"""mfu.train: the autoencoder's dense-layer flops a trained cloud, forward
and backward, times the clouds trained a second in the untraced pass
ahead of the traced steps (``trace.traced``), as a share of the card's
float32 peak on the CUDA cores."""

from perfbench import work


def read(ctx):
    if not ctx["trace"].device:
        return None
    ae = ctx["cell"].config["model"]["autoencoder"]
    bsz = ctx["clouds"] // ctx["steps"]
    flops = sum(work.train_flops(ae, kept, bsz)
                for kept in ctx["timed_kept_points"])
    return 100.0 * flops / ctx["trace"].window_s / work.PEAKS["f32_flops"]
