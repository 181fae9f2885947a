"""device_idle.serve: the share of the serving window in which no device
operation ran: the traced pass's busy time against the untraced pass of
the same work (``trace.traced``), since the profiler stretches its own
pass on the host."""

from perfbench.trace import share


def read(ctx):
    tr = ctx["trace"]
    if not tr.device:
        return None
    return share(tr.window_s - tr.busy_s(), tr.window_s)
