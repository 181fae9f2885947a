"""launches.per_step: device operations (kernels, copies, memsets) a
training step, from the traced window."""


def read(ctx):
    if not ctx["trace"].device:
        return None
    return ctx["trace"].launches() / ctx["steps"]
