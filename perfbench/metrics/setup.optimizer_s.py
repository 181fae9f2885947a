"""setup.optimizer_s: host seconds of the optimizer's set-up
(``make_ae_optimizer``; the process's first ``torch.optim`` optimizer
imports ``torch._dynamo``), from the span totals of ``setup.optimizer``.
Set-up runs before the profiler starts, so it is read from the totals,
in a traced run that recorded device seconds."""

from perfbench import spans


def read(ctx):
    total = spans.totals().get("setup.optimizer")
    if not spans.records() or total is None:
        return None
    return total["host_s"]
