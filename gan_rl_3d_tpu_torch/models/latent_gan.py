"""Latent GAN, eval mode (gan_rl_3d_tpu/models/latent_gan.py:52-127).

Generator z -> [256, 512, 512, 256] (+BN+ReLU) -> 128 + tanh.
Discriminator: each hidden block Dense (spectral-normed when the state
carries ``sn``) + LayerNorm + LeakyReLU(0.2); the final Dense has no
activation. Without ``sn`` state it is the plain variant.
"""

from __future__ import annotations

import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.models.common import bn_mlp_apply

Tensor = torch.Tensor


def generator_apply(params: dict, state: dict, z: Tensor) -> Tensor:
    """z (B, z_dim) -> clean GFV (B, latent_dim) in [-1, 1]."""
    return bn_mlp_apply(params["mlp"], state["mlp"], z,
                        final_activation=torch.tanh)[0]


def discriminator_apply(params: dict, state: dict, gfv: Tensor, *,
                        leak: float = 0.2) -> Tensor:
    """GFV (B, latent_dim) -> realness score (B, 1)."""
    x = gfv
    for p, s in zip(params["layers"], state["layers"]):
        w = p["dense"]["w"]
        if "sn" in s:
            w = nn.spectral_norm_eval(w, s["sn"])
        x = x @ w + p["dense"]["b"]
        if "ln" in p:
            x = nn.leaky_relu(nn.layernorm(p["ln"], x), leak)
    return x
