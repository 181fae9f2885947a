"""The work that the benchmark's inputs need, counted from the
configuration's widths: model flops (two a multiply-add of every dense
layer, nothing for biases, normalisation or activations), and the
operations and bytes of the kernels whose roofline share is reported.

Per-point layers are counted over the points each cloud's mask keeps, not
over its padded rows: padding is work a program may skip, so a program
that skips it must not read above 100%.
"""

import json
from pathlib import Path
from typing import Sequence

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def macs(d_in: int, dims: Sequence[int]) -> int:
    """Multiply-adds of a chain of dense layers."""
    total = 0
    for d_out in dims:
        total += d_in * d_out
        d_in = d_out
    return total


def point_mlp_flops(ae: dict) -> int:
    """Flops a kept point of the encoder's shared point MLP (180,608 at
    3 -> 64 -> 128 -> 128 -> 256 -> 128)."""
    return 2 * macs(ae["input_dim"], ae["encoder_dims"])


def encoder_flops(ae: dict, kept_points: int, clouds: int) -> int:
    """The encoder's forward flops: the point MLP and, for the attention
    encoder, its c -> c/4 -> 1 weights on every kept point; the head once
    a cloud."""
    per_point = point_mlp_flops(ae)
    if ae["encoder_type"] == "attention":
        c = ae["encoder_dims"][-1]
        per_point += 2 * macs(c, [c // 4, 1])
    head = 2 * ae["encoder_dims"][-1] * ae["latent_dim"]
    return per_point * kept_points + head * clouds


def decoder_flops(ae: dict, clouds: int) -> int:
    """The decoder's forward flops for ``clouds`` decoded clouds."""
    if ae["decoder_type"] == "adaptive":
        feat = ae["adaptive_dims"]
        per_cloud = 2 * (macs(ae["latent_dim"], feat)
                         + feat[-1] * ae["num_points"] * 3)
        refine = 2 * macs(3, [ae["refine_dim"], 3]) * ae["num_points"]
        return (per_cloud + refine) * clouds
    return 2 * macs(ae["latent_dim"], ae["decoder_dims"]) * clouds


def serve_flops(model: dict, kept_points: int, clouds: int) -> int:
    """One served completion of ``clouds`` clouds: the encoder, the actor,
    the generator, the decoder on the generated and on the encoded GFV,
    and the discriminator on both."""
    ae, lg, rl = model["autoencoder"], model["lgan"], model["rl_agent"]
    tail = 2 * (macs(rl["state_dim"], list(rl["hidden_dims"])
                     + [rl["action_dim"]])
                + macs(lg["z_dim"], lg["generator_dims"])
                + 2 * macs(lg["latent_dim"], lg["discriminator_dims"]))
    return (encoder_flops(ae, kept_points, clouds) + tail * clouds
            + decoder_flops(ae, 2 * clouds))


def train_flops(ae: dict, kept_points: int, clouds: int) -> int:
    """One autoencoder training step: the forward pass, and a backward
    pass of twice its flops (the weights' gradient and the inputs'), less
    the first layer's input gradient, which the cloud does not need."""
    forward = encoder_flops(ae, kept_points, clouds) \
        + decoder_flops(ae, clouds)
    first = 2 * ae["input_dim"] * ae["encoder_dims"][0] * kept_points
    return 3 * forward - first


def k1_f32(ae: dict, clouds: int, n: int, kept_points: int):
    """(flops, bytes) of one fused encoder-and-pool launch in float32: the
    point MLP on the kept points; the clouds and masks read once, the
    folded weights and biases read once, the pooled features written."""
    dims = [ae["input_dim"]] + list(ae["encoder_dims"])
    weights = sum((a + 1) * b for a, b in zip(dims, dims[1:]))
    nbytes = 4 * (clouds * n * 4 + weights + clouds * dims[-1])
    return point_mlp_flops(ae) * kept_points, nbytes


def k3(bsz: int, n: int, m: int):
    """(flops, bytes) of one nearest-neighbour launch with indices: 8 flops
    a pair (the squared distance's three differences, three products and
    two sums); both clouds read, a distance and an index written a query
    point."""
    return 8 * bsz * n * m, 4 * (bsz * n * 3 + bsz * m * 3) + 8 * bsz * n


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the float32 rate
    of the CUDA cores, or bytes over the memory bandwidth, the larger."""
    return max(flops / PEAKS["f32_flops"], nbytes / PEAKS["hbm_bytes"])
