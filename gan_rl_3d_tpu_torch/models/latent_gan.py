"""Latent GAN, init and eval mode (gan_rl_3d_tpu/models/latent_gan.py).

Generator z -> [256, 512, 512, 256] (+BN+ReLU) -> 128 + tanh.
Discriminator 128 -> [128, 256, 512, 256] -> 1: each hidden block Dense
(spectral-normed when the state carries ``sn``) + LayerNorm +
LeakyReLU(0.2); the final Dense has no activation. Without ``sn`` state it
is the plain variant.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.models.common import bn_mlp_apply, bn_mlp_init

Tensor = torch.Tensor

GENERATOR_DIMS = (256, 512, 512, 256, 128)
DISCRIMINATOR_DIMS = (128, 256, 512, 256, 1)


def generator_init(generator: torch.Generator, z_dim: int = 1,
                   latent_dim: int = 128,
                   hidden_dims: Sequence[int] = GENERATOR_DIMS
                   ) -> Tuple[dict, dict]:
    """(latent_gan.py:40-49)"""
    if hidden_dims[-1] != latent_dim:
        raise ValueError(f"last generator dim must equal latent_dim="
                         f"{latent_dim}, got {hidden_dims[-1]}")
    p, s = bn_mlp_init(generator, z_dim, hidden_dims, final_plain=True)
    return {"mlp": p}, {"mlp": s}


def discriminator_init(generator: torch.Generator, latent_dim: int = 128,
                       hidden_dims: Sequence[int] = DISCRIMINATOR_DIMS, *,
                       spectral_norm: bool = True) -> Tuple[dict, dict]:
    """Per layer a Dense, its spectral-norm vectors when ``spectral_norm``,
    and a LayerNorm on every layer but the last (latent_gan.py:70-92)."""
    params, state = [], []
    d_in = latent_dim
    for i, d_out in enumerate(hidden_dims):
        layer_p = {"dense": nn.dense_init(generator, d_in, d_out)}
        layer_s = {}
        if spectral_norm:
            layer_s["sn"] = nn.spectral_norm_init(generator, (d_in, d_out))
        if i < len(hidden_dims) - 1:
            layer_p["ln"] = nn.layernorm_init(d_out)
        params.append(layer_p)
        state.append(layer_s)
        d_in = d_out
    return {"layers": params}, {"layers": state}


def lgan_init(generator: torch.Generator, z_dim: int = 1,
              latent_dim: int = 128,
              generator_dims: Sequence[int] = GENERATOR_DIMS,
              discriminator_dims: Sequence[int] = DISCRIMINATOR_DIMS, *,
              spectral_norm: bool = True) -> Tuple[dict, dict]:
    """(latent_gan.py:135-149): the generator's draws, then the
    discriminator's."""
    g_p, g_s = generator_init(generator, z_dim, latent_dim, generator_dims)
    d_p, d_s = discriminator_init(generator, latent_dim, discriminator_dims,
                                  spectral_norm=spectral_norm)
    return ({"generator": g_p, "discriminator": d_p},
            {"generator": g_s, "discriminator": d_s})


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
