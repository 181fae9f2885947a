"""k3_roofline.pcn: the nearest-neighbour kernel with indices in PCN's
step, four launches a step (coarse to target and back, fine to target and
back), each at its least time for its own (N, M) (8 flops a pair over the
float32 peak, or its bytes over the memory bandwidth), over their device
time in the traced window, found by the kernel's exact name. A window
with another number of launches than four a step gives nothing."""

from perfbench import work, work_pcn

# nn_kernel<keep_idx, masked> with keep_idx true (K2 is keep_idx false)
NAME = r"\bnn_kernel<\s*true\b"


def read(ctx):
    launches, seconds = ctx["trace"].kernel_seconds(NAME)
    if not launches or launches != 4 * ctx["steps"]:
        return None
    cell = ctx["cell"]
    ae = dict(cell.config["model"]["autoencoder"],
              num_coarse=cell.traffic["num_coarse"])
    bsz = ctx["clouds"] // ctx["steps"]
    bound = sum(work.bound_seconds(*k) for k in work_pcn.k3_launches(
        ae, bsz, cell.traffic["gt_points"]))
    return 100.0 * ctx["steps"] * bound / seconds
