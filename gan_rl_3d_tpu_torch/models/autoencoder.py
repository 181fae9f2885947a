"""PointNet autoencoder and the dispatch over both model families
(gan_rl_3d_tpu/models/autoencoder.py).

Encoder point-MLP 3->[64,128,128,256,128] each +BN+ReLU, masked max over N,
head 128->128 +BN+ReLU; decoder 128->256->256->6144 reshaped row-major to
(B, 2048, 3). The attention encoder and the adaptive decoder
(``models.variants``) are the second family, PCN's two-stage encoder and
folding decoder (``models.pcn``) the third; the tree tells them apart, as
in the JAX package: an encoder with an ``"attention"`` subtree (or PCN's
``"stage1"``), a decoder with ``"feature_mlp"`` (or ``"folding"``: the
fine cloud is the output). ``any_encoder_apply`` / ``any_decoder_apply``
run any family with ``training=`` and return the new BatchNorm state;
``encoder_apply`` / ``decoder_apply`` are their eval-mode forms returning
tensors (the serving path); ``autoencoder_apply`` goes through the
dispatchers, as the JAX function does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch.models import pcn, variants
from gan_rl_3d_tpu_torch.models.common import bn_mlp_apply, bn_mlp_init

Tensor = torch.Tensor

ENCODER_DIMS = (64, 128, 128, 256, 128)
DECODER_DIMS = (256, 256, 6144)


def encoder_init(generator: torch.Generator, input_dim: int = 3,
                 latent_dim: int = 128,
                 hidden_dims: Sequence[int] = ENCODER_DIMS
                 ) -> Tuple[dict, dict]:
    mlp_p, mlp_s = bn_mlp_init(generator, input_dim, hidden_dims)
    head_p, head_s = bn_mlp_init(generator, hidden_dims[-1], [latent_dim])
    return ({"point_mlp": mlp_p, "head": head_p},
            {"point_mlp": mlp_s, "head": head_s})


def decoder_init(generator: torch.Generator, latent_dim: int = 128,
                 num_points: int = 2048,
                 hidden_dims: Sequence[int] = DECODER_DIMS
                 ) -> Tuple[dict, dict]:
    if hidden_dims[-1] != num_points * 3:
        raise ValueError(f"last decoder dim must be num_points*3="
                         f"{num_points * 3}, got {hidden_dims[-1]}")
    p, s = bn_mlp_init(generator, latent_dim, hidden_dims, final_plain=True)
    return {"mlp": p}, {"mlp": s}


def autoencoder_init(generator: torch.Generator, input_dim: int = 3,
                     latent_dim: int = 128, num_points: int = 2048,
                     encoder_dims: Sequence[int] = ENCODER_DIMS,
                     decoder_dims: Sequence[int] = DECODER_DIMS,
                     encoder_type: str = "pointnet",
                     decoder_type: str = "mlp", *, num_coarse: int = 1024,
                     grid_size: int = 4, grid_scale: float = 0.05
                     ) -> Tuple[dict, dict]:
    """f32 params and BN state on the CPU, drawn from ``generator`` (encoder
    first); move them to a device with ``utils.tree.tree_map``. The
    adaptive decoder ignores ``decoder_dims`` and emits ``num_points``
    points (autoencoder.py:134-169). The folding decoder's coarse MLP is
    ``decoder_dims`` and it emits ``num_coarse * grid_size**2`` points,
    which must be ``num_points``."""
    if encoder_type == "pcn":
        enc_p, enc_s = pcn.pcn_encoder_init(generator, input_dim, latent_dim,
                                            encoder_dims)
    elif encoder_type == "attention":
        enc_p, enc_s = variants.attention_encoder_init(
            generator, input_dim, latent_dim, encoder_dims)
    elif encoder_type == "pointnet":
        enc_p, enc_s = encoder_init(generator, input_dim, latent_dim,
                                    encoder_dims)
    else:
        raise ValueError(f"unknown encoder_type {encoder_type!r}")
    if decoder_type == "adaptive":
        dec_p, dec_s = variants.adaptive_decoder_init(generator, latent_dim,
                                                      num_points)
    elif decoder_type == "folding":
        if num_coarse * grid_size ** 2 != num_points:
            raise ValueError(f"the folding decoder emits num_coarse * "
                             f"grid_size**2 = {num_coarse * grid_size ** 2} "
                             f"points, not num_points={num_points}")
        dec_p, dec_s = pcn.folding_decoder_init(
            generator, latent_dim, num_coarse, grid_size, grid_scale,
            decoder_dims)
    elif decoder_type == "mlp":
        dec_p, dec_s = decoder_init(generator, latent_dim, num_points,
                                    decoder_dims)
    else:
        raise ValueError(f"unknown decoder_type {decoder_type!r}")
    return ({"encoder": enc_p, "decoder": dec_p},
            {"encoder": enc_s, "decoder": dec_s})


def _encode(params: dict, state: dict, pc: Tensor, mask: Optional[Tensor],
            training: bool, bn_stats: str = "centered"
            ) -> Tuple[Tensor, dict]:
    feats, mlp_s = bn_mlp_apply(params["point_mlp"], state["point_mlp"], pc,
                                training=training, bn_stats=bn_stats)
    if mask is not None:
        feats = torch.where(mask[..., None] > 0, feats,
                            torch.tensor(float("-inf"), dtype=feats.dtype,
                                         device=feats.device))
    # amax splits the gradient evenly among tied maxima, as jnp.max does
    # (ReLU outputs tie at 0 often)
    pooled = feats.amax(dim=-2)
    gfv, head_s = bn_mlp_apply(params["head"], state["head"], pooled,
                               training=training, bn_stats=bn_stats)
    return gfv, {"point_mlp": mlp_s, "head": head_s}


def _decode(params: dict, state: dict, gfv: Tensor, training: bool,
            bn_stats: str = "centered") -> Tuple[Tensor, dict]:
    x, mlp_s = bn_mlp_apply(params["mlp"], state["mlp"], gfv,
                            training=training, bn_stats=bn_stats)
    return x.reshape(x.shape[0], x.shape[-1] // 3, 3), {"mlp": mlp_s}


def any_encoder_apply(params: dict, state: dict, pc: Tensor,
                      mask: Optional[Tensor] = None, *,
                      training: bool = False, bn_stats: str = "centered"
                      ) -> Tuple[Tensor, dict]:
    """(GFV, new state) of any encoder (autoencoder.py:115-122)."""
    if pcn.is_pcn_encoder(params):
        return pcn.pcn_encoder_apply(params, state, pc, mask)
    if "attention" in params:
        return variants.attention_encoder_apply(
            params, state, pc, mask, training=training, bn_stats=bn_stats)
    return _encode(params, state, pc, mask, training, bn_stats)


def any_decoder_apply(params: dict, state: dict, gfv: Tensor, *,
                      training: bool = False, bn_stats: str = "centered"
                      ) -> Tuple[Tensor, dict]:
    """(cloud, new state) of any decoder (autoencoder.py:125-131); the
    folding decoder's cloud is its fine one."""
    if pcn.is_folding(params):
        return pcn.folding_decoder_apply(params, state, gfv)
    if "feature_mlp" in params:
        return variants.adaptive_decoder_apply(
            params, state, gfv, training=training, bn_stats=bn_stats)
    return _decode(params, state, gfv, training, bn_stats)


def encoder_apply(params: dict, state: dict, pc: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """pc (B, N, 3)[, mask (B, N)] -> GFV (B, latent_dim), eval mode.
    ``mask=None`` pools over every point (autoencoder.py:54-71)."""
    return any_encoder_apply(params, state, pc, mask)[0]


def decoder_apply(params: dict, state: dict, gfv: Tensor) -> Tensor:
    """GFV (B, latent_dim) -> cloud (B, num_points, 3), eval mode
    (autoencoder.py:92-103)."""
    return any_decoder_apply(params, state, gfv)[0]


def autoencoder_apply(params: dict, state: dict, pc: Tensor,
                      mask: Optional[Tensor] = None, *,
                      training: bool = False, bn_stats: str = "centered"
                      ) -> Tuple[Tuple[Tensor, Tensor], dict]:
    """Returns ((reconstruction, gfv), new_state) (autoencoder.py:172-185);
    ``bn_stats`` is the training BN statistics mode."""
    gfv, enc_s = any_encoder_apply(params["encoder"], state["encoder"], pc,
                                   mask, training=training, bn_stats=bn_stats)
    recon, dec_s = any_decoder_apply(params["decoder"], state["decoder"], gfv,
                                     training=training, bn_stats=bn_stats)
    return (recon, gfv), {"encoder": enc_s, "decoder": dec_s}
