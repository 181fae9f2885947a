"""The attention-encoder / adaptive-decoder model family
(gan_rl_3d_tpu/models/variants.py).

* ``attention_encoder_*``: the BN point-MLP, then per-point sigmoid
  attention weights (c -> c/4 -> 1) that replace the max-pool by a
  normalised weighted sum; padded points get zero weight. Head 128->128
  +BN+ReLU.
* ``adaptive_decoder_*``: a BN feature MLP 128->256->512->1024, a tanh
  point generator 1024 -> max_points*3 reshaped row-major and sliced to
  ``num_points``, then a pointwise residual refinement 3->64 (+BN+ReLU)
  ->3 added to the points.

The JAX functions inherit the training BatchNorm statistics mode from a
trace-time context (nn.bn_stats_mode); here every apply takes
``training=`` and ``bn_stats=`` explicitly, as ``models.autoencoder``
does. Neither network folds into an inference engine (the weighted pool
and the refinement depend on the data): ``models.rl_gan_net.complete``
serves them. Initialisers draw from ``generator`` in the JAX function's
key order (point-MLP, fc1, fc2, head; feature MLP, generator, conv1,
conv2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.models.common import bn_mlp_apply, bn_mlp_init
from gan_rl_3d_tpu_torch.ops import bn_train

Tensor = torch.Tensor

ATTENTION_DIMS = (64, 128, 128, 256, 128)
ADAPTIVE_DIMS = (256, 512, 1024)


def attention_encoder_init(generator: torch.Generator, input_dim: int = 3,
                           latent_dim: int = 128,
                           hidden_dims: Sequence[int] = ATTENTION_DIMS
                           ) -> Tuple[dict, dict]:
    """(variants.py:39-54)"""
    mlp_p, mlp_s = bn_mlp_init(generator, input_dim, hidden_dims)
    c = hidden_dims[-1]
    att = {"fc1": nn.dense_init(generator, c, c // 4),
           "fc2": nn.dense_init(generator, c // 4, 1)}
    head_p, head_s = bn_mlp_init(generator, c, [latent_dim])
    return ({"point_mlp": mlp_p, "attention": att, "head": head_p},
            {"point_mlp": mlp_s, "head": head_s})


def attention_encoder_apply(params: dict, state: dict, pc: Tensor,
                            mask: Optional[Tensor] = None, *,
                            training: bool = False,
                            bn_stats: str = "centered"
                            ) -> Tuple[Tensor, dict]:
    """pc (B, N, 3)[, mask (B, N)] -> (GFV (B, latent_dim), new state):
    the weighted sum of the point features over the sum of the weights
    (+1e-8), the weights times the mask (variants.py:57-82)."""
    feats, mlp_s = bn_mlp_apply(params["point_mlp"], state["point_mlp"], pc,
                                training=training, bn_stats=bn_stats)
    att = params["attention"]
    a = torch.sigmoid(nn.dense(att["fc2"], torch.relu(nn.dense(att["fc1"],
                                                               feats))))
    if mask is not None:
        a = a * mask[..., None]
    pooled = (feats * a).sum(dim=-2) / (a.sum(dim=-2) + 1e-8)
    gfv, head_s = bn_mlp_apply(params["head"], state["head"], pooled,
                               training=training, bn_stats=bn_stats)
    return gfv, {"point_mlp": mlp_s, "head": head_s}


def adaptive_decoder_init(generator: torch.Generator, latent_dim: int = 128,
                          max_points: int = 2048,
                          hidden_dims: Sequence[int] = ADAPTIVE_DIMS
                          ) -> Tuple[dict, dict]:
    """(variants.py:90-104)"""
    feat_p, feat_s = bn_mlp_init(generator, latent_dim, hidden_dims)
    gen = nn.dense_init(generator, hidden_dims[-1], max_points * 3)
    refine = {"conv1": nn.dense_init(generator, 3, 64),
              "conv2": nn.dense_init(generator, 64, 3)}
    refine["bn"], bn_s = nn.batchnorm_init(64)
    return ({"feature_mlp": feat_p, "gen": gen, "refine": refine},
            {"feature_mlp": feat_s, "refine_bn": bn_s})


def adaptive_decoder_apply(params: dict, state: dict, gfv: Tensor, *,
                           num_points: Optional[int] = None,
                           training: bool = False,
                           bn_stats: str = "centered"
                           ) -> Tuple[Tensor, dict]:
    """GFV (B, latent) -> ((B, num_points, 3), new state); ``num_points``
    defaults to max_points (variants.py:107-133)."""
    max_points = params["gen"]["w"].shape[1] // 3
    n = num_points or max_points
    if n > max_points:
        raise ValueError(f"num_points {n} > max_points {max_points}")
    feats, feat_s = bn_mlp_apply(params["feature_mlp"], state["feature_mlp"],
                                 gfv, training=training, bn_stats=bn_stats)
    pts = torch.tanh(nn.dense(params["gen"], feats))
    pts = pts.reshape(pts.shape[0], max_points, 3)[:, :n, :]
    ref = params["refine"]
    if training:
        r, bn_s = bn_train.dense_bn_relu_train(ref["conv1"], ref["bn"],
                                               state["refine_bn"], pts,
                                               mode=bn_stats)
    else:
        bn_s = state["refine_bn"]
        r = torch.relu(nn.batchnorm_eval(ref["bn"], bn_s,
                                         nn.dense(ref["conv1"], pts)))
    r = nn.dense(ref["conv2"], r)
    return pts + r, {"feature_mlp": feat_s, "refine_bn": bn_s}
