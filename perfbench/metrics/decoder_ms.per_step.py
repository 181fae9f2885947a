"""decoder_ms.per_step: device milliseconds a training step of the
operations launched in the decoder (the adaptive decoder and its
refinement), forward and backward: the span ``ae.decoder`` and its
backward segment per ``ae.step`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx, "ae.step", ("ae.decoder",))
