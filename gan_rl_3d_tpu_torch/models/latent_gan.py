"""Latent GAN (gan_rl_3d_tpu/models/latent_gan.py).

Generator z -> [256, 512, 512, 256] (+BN+ReLU) -> 128 + tanh.
Discriminator 128 -> [128, 256, 512, 256] -> 1: each hidden block Dense
(spectral-normed when the state carries ``sn``) + LayerNorm +
LeakyReLU(0.2) + Dropout(0.3) in training; the final Dense has no
activation. Without ``sn`` state it is the plain variant. Both apply
functions return (output, new state), as the JAX ones do: in training the
generator's BN statistics and the spectral-norm vectors advance once per
call. Dropout takes its keep masks, one per hidden layer, as drawn by
``draw_dropout_masks`` or replayed from JAX's keys. Under a mesh whose
model axis shards a layer by column (``parallel.mesh``), the layer
computes this rank's columns and gathers the rest before the next one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.models.common import bn_mlp_apply, bn_mlp_init
from gan_rl_3d_tpu_torch.parallel import collectives
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

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


def generator_apply(params: dict, state: dict, z: Tensor, *,
                    training: bool = False, bn_stats: str = "centered"
                    ) -> Tuple[Tensor, dict]:
    """z (B, z_dim) -> clean GFV (B, latent_dim) in [-1, 1], and the new
    BN state. Phases 3-4 train BN with the centered statistics; the joint
    step passes training.bn_stats, as the JAX joint step sets it for every
    network it runs."""
    gfv, mlp_s = bn_mlp_apply(params["mlp"], state["mlp"], z,
                              training=training, bn_stats=bn_stats,
                              final_activation=torch.tanh)
    return gfv, {"mlp": mlp_s}


def draw_dropout_masks(generator: torch.Generator, bsz: int,
                       dims: Sequence[int], rate: float = 0.3
                       ) -> List[Optional[Tensor]]:
    """Keep masks for one training call of the discriminator of widths
    ``dims`` (DISCRIMINATOR_DIMS): (B, d) booleans, true with probability
    1 - rate, for each hidden layer; None for the last."""
    return [torch.rand((bsz, d), generator=generator,
                       device=generator.device) < 1.0 - rate
            for d in dims[:-1]] + [None]


def discriminator_apply(params: dict, state: dict, gfv: Tensor, *,
                        training: bool = False,
                        keep_masks: Optional[Sequence] = None,
                        dropout_rate: float = 0.3, leak: float = 0.2
                        ) -> Tuple[Tensor, dict]:
    """GFV (B, latent_dim) -> realness score (B, 1), and the new state (the
    spectral-norm vectors after one power iteration in training). Dropout
    runs in training when ``keep_masks`` is given (latent_gan.py:95-132)."""
    x = gfv
    new_state = []
    masks = keep_masks if training and keep_masks is not None else None
    for i, (p, s) in enumerate(zip(params["layers"], state["layers"])):
        w = p["dense"]["w"]
        layer_s = {}
        if "sn" in s:
            w, layer_s["sn"] = nn.spectral_norm_apply(w, s["sn"],
                                                      training=training)
        sharded = mesh_lib.is_model_sharded(p["dense"]["w"])
        if sharded:
            x = collectives.enter_columns(x, mesh_lib.active())
        x = x @ w + p["dense"]["b"]
        if sharded:
            x = collectives.gather_columns(x, mesh_lib.active())
        if "ln" in p:
            x = nn.leaky_relu(nn.layernorm(p["ln"], x), leak)
            if masks is not None:
                x = nn.dropout(x, masks[i], dropout_rate)
        new_state.append(layer_s)
    return x, {"layers": new_state}
