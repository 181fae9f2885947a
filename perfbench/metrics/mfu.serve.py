"""mfu.serve: the served model's flops a completed cloud times the clouds
completed a second in the untraced pass of the traced calls
(``trace.traced``), as a share of the card's float32 peak on the CUDA
cores (the port runs float32 with TF32 off)."""

from perfbench import work


def read(ctx):
    if not ctx["trace"].device:
        return None
    model = ctx["cell"].config["model"]
    bsz = ctx["clouds"] // ctx["steps"]
    flops = sum(work.serve_flops(model, kept, bsz)
                for kept in ctx["timed_kept_points"])
    return 100.0 * flops / ctx["trace"].window_s / work.PEAKS["f32_flops"]
