"""encoder_ms.per_step: device milliseconds a training step of the
operations launched in the encoder (point MLP, attention pool, head),
forward and backward: the span ``ae.encoder`` and its backward segment
per ``ae.step`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx, "ae.step", ("ae.encoder",))
