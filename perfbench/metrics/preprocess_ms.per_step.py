"""preprocess_ms.per_step: device milliseconds a training step of the
operations launched for the batch's draws and gather and for the hole
cutting, augmentation and normalisation: the spans ``ae.batch`` and
``ae.preprocess`` per ``ae.step`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx, "ae.step", ("ae.batch", "ae.preprocess"))
