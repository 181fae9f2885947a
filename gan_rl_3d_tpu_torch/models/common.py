"""Dense(+BatchNorm)(+activation) stacks (gan_rl_3d_tpu/models/common.py),
and the optimizer step the training phases share."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.ops import bn_train
from gan_rl_3d_tpu_torch.parallel import collectives
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves

Tensor = torch.Tensor


def bn_mlp_init(generator: torch.Generator, in_dim: int,
                hidden_dims: Sequence[int], *,
                w_init: Callable = nn.kaiming_uniform,
                bias_const: Optional[float] = None,
                final_plain: bool = False) -> Tuple[list, list]:
    """[Dense -> BatchNorm] blocks; with ``final_plain`` the last Dense has
    no BatchNorm (common.py:19-45). Layers draw from ``generator`` in
    order, weight then bias."""
    params, state = [], []
    d_in = in_dim
    for i, d_out in enumerate(hidden_dims):
        layer_p = {"dense": nn.dense_init(generator, d_in, d_out,
                                          w_init=w_init,
                                          bias_const=bias_const)}
        layer_s = {}
        if not (final_plain and i == len(hidden_dims) - 1):
            layer_p["bn"], layer_s["bn"] = nn.batchnorm_init(d_out)
        params.append(layer_p)
        state.append(layer_s)
        d_in = d_out
    return params, state


def bn_mlp_apply(params: list, state: list, x: Tensor, *,
                 training: bool = False, bn_stats: str = "centered",
                 activation: Callable = torch.relu,
                 final_activation: Optional[Callable] = None
                 ) -> Tuple[Tensor, list]:
    """Blocks with a 'bn' entry run Dense -> BN -> activation; a plain block
    (the final_plain block) runs Dense then ``final_activation`` if given
    (common.py:48-71). Training BN takes its statistics by ``bn_stats``;
    a training block with the ReLU runs as ``bn_train.dense_bn_relu_train``
    (one op over the kernels on the card). Returns (x, new state); eval
    mode returns the state it was given."""
    new_state = []
    for p, s in zip(params, state):
        if "bn" in p and training and activation is torch.relu:
            x, bn_s = bn_train.dense_bn_relu_train(p["dense"], p["bn"],
                                                   s["bn"], x, mode=bn_stats)
            new_state.append({"bn": bn_s})
            continue
        x = nn.dense(p["dense"], x)
        if "bn" in p:
            if training:
                x, bn_s = nn.batchnorm_train(p["bn"], s["bn"], x,
                                              mode=bn_stats)
            else:
                x, bn_s = nn.batchnorm_eval(p["bn"], s["bn"], x), s["bn"]
            new_state.append({"bn": bn_s})
            x = activation(x)
        else:
            new_state.append({})
            if final_activation is not None:
                x = final_activation(x)
    return x, new_state


def grad_step(opt: torch.optim.Optimizer, loss: Tensor, params) -> None:
    """One step of ``opt`` on the gradient of ``loss`` w.r.t. the leaves
    of ``params`` alone: the other networks in the graph get no gradient,
    as with jax.grad of one argument. Under a mesh the gradients are
    summed over the data group first (``loss`` is this rank's term)."""
    leaves = tree_leaves(params)
    for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
        p.grad = g
    collectives.all_reduce_grads(leaves, mesh_lib.active())
    opt.step()
