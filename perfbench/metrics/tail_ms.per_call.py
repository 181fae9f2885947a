"""tail_ms.per_call: device milliseconds a served call of the operations
launched in the MLP tail (actor, G, the decoder pass) and the gate (D's
scores, the choice): the spans ``serve.tail`` and ``serve.gate`` per
``serve.call`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx, "serve.call", ("serve.tail", "serve.gate"))
