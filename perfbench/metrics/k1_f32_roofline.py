"""k1_f32_roofline: the float32 fused encoder-and-pool kernel's least time
(its operations on the kept points over the float32 peak, or its bytes
over the memory bandwidth) over its device time in the traced window,
found by its exact kernel name."""

from perfbench import work

# encoder_pool_kernel<tile, bf16, masked> with bf16 false
NAME = r"\bencoder_pool_kernel<\s*\d+\s*,\s*false\b"


def read(ctx):
    launches, seconds = ctx["trace"].kernel_seconds(NAME)
    if not launches:
        return None
    ae = ctx["cell"].config["model"]["autoencoder"]
    bsz = ctx["clouds"] // ctx["steps"]
    bound = sum(work.bound_seconds(*work.k1_f32(ae, bsz, ctx["points"],
                                                kept))
                for kept in ctx["kept_points"])
    return 100.0 * bound / seconds
