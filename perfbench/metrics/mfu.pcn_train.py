"""mfu.pcn_train: PCN's flops a trained cloud (``work_pcn.train_flops``:
the kept input points, the fine points, the concatenated layers' shared
parts once a cloud), forward and backward, times the clouds trained a
second in the untraced pass ahead of the traced steps
(``trace.traced``), as a share of the card's float32 peak on the CUDA
cores."""

from perfbench import work, work_pcn


def _ae(ctx) -> dict:
    cell = ctx["cell"]
    return dict(cell.config["model"]["autoencoder"],
                num_coarse=cell.traffic["num_coarse"])


def read(ctx):
    if not ctx["trace"].device:
        return None
    bsz = ctx["clouds"] // ctx["steps"]
    flops = sum(work_pcn.train_flops(_ae(ctx), kept, bsz)
                for kept in ctx["timed_kept_points"])
    return 100.0 * flops / ctx["trace"].window_s / work.PEAKS["f32_flops"]
