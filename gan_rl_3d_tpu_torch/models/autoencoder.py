"""PointNet autoencoder (gan_rl_3d_tpu/models/autoencoder.py).

Encoder point-MLP 3->[64,128,128,256,128] each +BN+ReLU, masked max over N,
head 128->128 +BN+ReLU; decoder 128->256->256->6144 reshaped row-major to
(B, 2048, 3). ``encoder_apply`` / ``decoder_apply`` run eval mode and
return tensors (the serving path); ``autoencoder_apply`` takes
``training=`` and returns the new BatchNorm state, as the JAX function
does; ``any_encoder_apply`` / ``any_decoder_apply`` run either half that
way (the joint step's encoder and its one decoder pass). The attention encoder and adaptive decoder variants are a later
slice (ROADMAP queue 1, item 16).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch.models.common import bn_mlp_apply, bn_mlp_init

Tensor = torch.Tensor

ENCODER_DIMS = (64, 128, 128, 256, 128)
DECODER_DIMS = (256, 256, 6144)


def _require_pointnet(params: dict) -> None:
    if "attention" in params or "feature_mlp" in params:
        raise NotImplementedError(
            "the attention encoder / adaptive decoder variants are not "
            "ported yet (ROADMAP queue 1, item 16)")


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
                     decoder_type: str = "mlp") -> Tuple[dict, dict]:
    """f32 params and BN state on the CPU, drawn from ``generator`` (encoder
    first); move them to a device with ``utils.tree.tree_map``."""
    if encoder_type != "pointnet" or decoder_type != "mlp":
        raise NotImplementedError(
            f"{encoder_type}/{decoder_type}: only the pointnet encoder and "
            "mlp decoder are ported (ROADMAP queue 1, item 16)")
    enc_p, enc_s = encoder_init(generator, input_dim, latent_dim,
                                encoder_dims)
    dec_p, dec_s = decoder_init(generator, latent_dim, num_points,
                                decoder_dims)
    return ({"encoder": enc_p, "decoder": dec_p},
            {"encoder": enc_s, "decoder": dec_s})


def _encode(params: dict, state: dict, pc: Tensor, mask: Optional[Tensor],
            training: bool, bn_stats: str = "centered"
            ) -> Tuple[Tensor, dict]:
    _require_pointnet(params)
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
    _require_pointnet(params)
    x, mlp_s = bn_mlp_apply(params["mlp"], state["mlp"], gfv,
                            training=training, bn_stats=bn_stats)
    return x.reshape(x.shape[0], x.shape[-1] // 3, 3), {"mlp": mlp_s}


def encoder_apply(params: dict, state: dict, pc: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """pc (B, N, 3)[, mask (B, N)] -> GFV (B, latent_dim), eval mode.
    ``mask=None`` pools over every point (autoencoder.py:54-71)."""
    return _encode(params, state, pc, mask, training=False)[0]


def decoder_apply(params: dict, state: dict, gfv: Tensor) -> Tensor:
    """GFV (B, latent_dim) -> cloud (B, num_points, 3), eval mode
    (autoencoder.py:92-103)."""
    return _decode(params, state, gfv, training=False)[0]


def any_encoder_apply(params: dict, state: dict, pc: Tensor,
                      mask: Optional[Tensor] = None, *,
                      training: bool = False, bn_stats: str = "centered"
                      ) -> Tuple[Tensor, dict]:
    """(GFV, new state) (autoencoder.py:115-122; the pointnet encoder
    alone, the variants being a later item)."""
    return _encode(params, state, pc, mask, training, bn_stats)


def any_decoder_apply(params: dict, state: dict, gfv: Tensor, *,
                      training: bool = False, bn_stats: str = "centered"
                      ) -> Tuple[Tensor, dict]:
    """(cloud, new state) (autoencoder.py:125-131)."""
    return _decode(params, state, gfv, training, bn_stats)


def autoencoder_apply(params: dict, state: dict, pc: Tensor,
                      mask: Optional[Tensor] = None, *,
                      training: bool = False, bn_stats: str = "centered"
                      ) -> Tuple[Tuple[Tensor, Tensor], dict]:
    """Returns ((reconstruction, gfv), new_state) (autoencoder.py:172-185);
    ``bn_stats`` is the training BN statistics mode."""
    gfv, enc_s = _encode(params["encoder"], state["encoder"], pc, mask,
                         training, bn_stats)
    recon, dec_s = _decode(params["decoder"], state["decoder"], gfv, training,
                           bn_stats)
    return (recon, gfv), {"encoder": enc_s, "decoder": dec_s}
