"""chamfer_ms.per_step: device milliseconds a training step of the
operations launched in the Chamfer loss (K3 forward, the masked mean;
K4/K5 backward): the span ``ae.chamfer`` and its backward segment per
``ae.step`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx, "ae.step", ("ae.chamfer",))
