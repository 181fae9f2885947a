"""launches.per_call: device operations (kernels, copies, memsets) a
served call, from the traced window."""


def read(ctx):
    if not ctx["trace"].device:
        return None
    return ctx["trace"].launches() / ctx["steps"]
