"""optimizer_ms.per_step: device milliseconds a training step of the
operations launched by Adam and the learning-rate schedule: the span
``ae.optimizer`` per ``ae.step`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx, "ae.step", ("ae.optimizer",))
