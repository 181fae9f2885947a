"""folding_ms.per_step: device milliseconds a training step of the
operations launched in the folding decoder's folding (the concatenated
input, the 1,029 -> 512 -> 512 -> 3 layers, the added coarse points),
forward and backward: the span ``ae.folding`` and its backward segment per
``ae.step`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx, "ae.step", ("ae.folding",))
