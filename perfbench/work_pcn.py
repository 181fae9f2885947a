"""PCN's work, counted from the configuration's widths as ``work.py``
counts the other families': model flops (two a multiply-add of every
dense layer, nothing for biases, activations, pools or the folding's
concatenation) and the four nearest-neighbour launches of a step.

A concatenated input's dense layer is counted as the published layer's
parts that differ from row to row, plus its parts that every row of a
cloud shares once a cloud: stage 1's first layer takes f (256) a kept
point and g0 (256) once a cloud; the folding's first layer takes the grid
point and the coarse point (5) a fine point and the GFV (1,024) once a
cloud. A program that computes the shared parts once a cloud reads under
100% by this count; one that repeats them on every row does more work
than it counts. Per-point layers count the points each cloud's mask
keeps.
"""

from typing import List, Tuple

from perfbench import work


def encoder_macs(ae: dict) -> Tuple[int, int]:
    """(a kept point's, a cloud's) multiply-adds of the two-stage encoder:
    688,512 and 131,072 at 3 -> 128 -> 256, [256 + 256] -> 512 -> 1024."""
    d = ae["encoder_dims"]
    per_point = work.macs(ae["input_dim"], d[:2]) + d[1] * d[2] \
        + d[2] * d[3]
    return per_point, d[1] * d[2]


def decoder_macs(ae: dict) -> Tuple[int, int]:
    """(a fine point's, a cloud's) multiply-adds of the decoder: 266,240
    a fine point (the folding's 5 -> 512 part, 512 -> 512 -> 3), and a
    cloud's coarse MLP with the folding's GFV part (1,024 x 512)."""
    f = list(ae["folding_dims"])
    per_fine = 5 * f[0] + work.macs(f[0], f[1:] + [3])
    coarse = work.macs(ae["latent_dim"], list(ae["decoder_dims"][:-1])
                       + [3 * ae["num_coarse"]])
    return per_fine, coarse + ae["latent_dim"] * f[0]


def fine_points(ae: dict) -> int:
    return ae["num_coarse"] * ae["grid_size"] ** 2


def forward_flops(ae: dict, kept_points: int, clouds: int) -> int:
    """One forward pass of ``clouds`` clouds with ``kept_points`` kept
    input points among them."""
    enc_point, enc_cloud = encoder_macs(ae)
    dec_fine, dec_cloud = decoder_macs(ae)
    return 2 * (enc_point * kept_points + (enc_cloud + dec_cloud) * clouds
                + dec_fine * fine_points(ae) * clouds)


def train_flops(ae: dict, kept_points: int, clouds: int) -> int:
    """A training step: the forward pass and a backward pass of twice its
    flops."""
    return 3 * forward_flops(ae, kept_points, clouds)


def k3_launches(ae: dict, bsz: int, gt_points: int) -> List[Tuple[int, int]]:
    """(flops, bytes) of the step's four launches of K3, each at its own
    (N, M): coarse to target and back, fine to target and back."""
    shapes = []
    for n in (ae["num_coarse"], fine_points(ae)):
        shapes += [(n, gt_points), (gt_points, n)]
    return [work.k3(bsz, n, m) for n, m in shapes]
