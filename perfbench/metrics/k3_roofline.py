"""k3_roofline: the nearest-neighbour kernel with indices (the Chamfer
loss's forward, both ways) at its least time, 8 flops a pair of the
batch's clouds over the float32 peak or its bytes over the memory
bandwidth, over its device time in the traced window, found by its exact
kernel name."""

from perfbench import work

# nn_kernel<keep_idx, masked> with keep_idx true (K2 is keep_idx false)
NAME = r"\bnn_kernel<\s*true\b"


def read(ctx):
    launches, seconds = ctx["trace"].kernel_seconds(NAME)
    if not launches:
        return None
    bsz = ctx["clouds"] // ctx["steps"]
    n = ctx["points"]
    return 100.0 * launches * work.bound_seconds(*work.k3(bsz, n, n)) \
        / seconds
