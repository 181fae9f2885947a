"""Layers on plain tensors (gan_rl_3d_tpu/nn.py).

Parameters are dictionaries of tensors in the JAX package's layout: dense
weights are (in, out), so a layer is ``x @ w + b`` on channels-last input.
Initialisers draw from an explicit ``torch.Generator``. BatchNorm runs in
eval mode and in both training statistics modes of the JAX package;
LayerNorm, dropout (given its keep mask) and spectral norm with its
power iteration follow nn.py:270-349.

Under a mesh (``parallel.mesh.active()``) training BatchNorm takes its
statistics across the data group, and a leaf ``shard_model_for_mesh``
marked as column-sharded computes this rank's columns: ``dense`` gathers
its output columns over the model group, BatchNorm normalises this rank's
columns with its own parameters and state, LayerNorm and spectral norm
gather what they read whole. Without a mesh nothing here communicates.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from gan_rl_3d_tpu_torch.parallel import collectives
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Initialisers (nn.py:42-111): torch's own defaults, which the JAX package
# reproduces with jax.random
# ---------------------------------------------------------------------------


def _uniform(generator: torch.Generator, shape, bound: float) -> Tensor:
    return (torch.rand(shape, generator=generator, dtype=torch.float32)
            * (2.0 * bound) - bound)


def kaiming_uniform(generator: torch.Generator, shape: Tuple[int, int]
                    ) -> Tensor:
    """torch Linear / Conv1d default weight init, kaiming_uniform(a=sqrt(5)):
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for an (in, out) weight."""
    fan_in = shape[0]
    return _uniform(generator, shape,
                    1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def xavier_uniform(generator: torch.Generator, shape: Tuple[int, int]
                   ) -> Tensor:
    """torch.nn.init.xavier_uniform_ for an (in, out) weight:
    U(-sqrt(6 / (fan_in + fan_out)), +sqrt(6 / (fan_in + fan_out)))."""
    return _uniform(generator, shape, math.sqrt(6.0 / (shape[0] + shape[1])))


def torch_bias_uniform(generator: torch.Generator, fan_in: int,
                       out_dim: int) -> Tensor:
    """torch Linear default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return _uniform(generator, (out_dim,),
                    1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               w_init: Callable = kaiming_uniform,
               bias_const: Optional[float] = None) -> dict:
    """{'w': (in, out), 'b': (out,)}; ``bias_const`` replaces the default
    bias init (nn.py:70-89)."""
    w = w_init(generator, (in_dim, out_dim))
    if bias_const is not None:
        b = torch.full((out_dim,), float(bias_const))
    else:
        b = torch_bias_uniform(generator, in_dim, out_dim)
    return {"w": w, "b": b}


def batchnorm_init(dim: int) -> Tuple[dict, dict]:
    return ({"scale": torch.ones(dim), "bias": torch.zeros(dim)},
            {"mean": torch.zeros(dim), "var": torch.ones(dim)})


def _sharded_mesh(leaf: Tensor) -> Optional[mesh_lib.Mesh]:
    """The active mesh when ``leaf`` is column-sharded, else None."""
    if not mesh_lib.is_model_sharded(leaf):
        return None
    mesh = mesh_lib.active()
    if mesh is None:
        raise RuntimeError("a column-sharded leaf runs only under its mesh "
                           "(parallel.mesh.use)")
    return mesh


def _whole(leaf: Tensor) -> Tensor:
    """``leaf``, or every model rank's columns of it when it is sharded."""
    mesh = _sharded_mesh(leaf)
    return leaf if mesh is None else collectives.gather_columns(leaf, mesh)


def dense(params: dict, x: Tensor) -> Tensor:
    """``x @ w + b`` with f32 accumulation; the result follows the weight's
    dtype (nn.py:92-100). A column-sharded layer computes this rank's
    columns and gathers the rest."""
    w = params["w"]
    mesh = _sharded_mesh(w)
    if mesh is not None:
        x = collectives.enter_columns(x, mesh)
    y = (torch.matmul(x.float(), w.float()) + params["b"].float()).to(w.dtype)
    return y if mesh is None else collectives.gather_columns(y, mesh)


def batchnorm_eval(params: dict, state: dict, x: Tensor, *,
                   eps: float = 1e-5) -> Tensor:
    """BatchNorm with running statistics, normalising the last axis
    (nn.py:262-267). Computed in f32; the output follows the input dtype."""
    mesh = _sharded_mesh(params["scale"])
    if mesh is not None:
        y = batchnorm_eval(_unmarked(params), _unmarked(state),
                           mesh_lib.column_block(
                               mesh, collectives.enter_columns(x, mesh)),
                           eps=eps)
        return collectives.gather_columns(y, mesh)
    inv = torch.rsqrt(state["var"].float() + eps)
    y = ((x.float() - state["mean"].float())
         * (inv * params["scale"].float()) + params["bias"].float())
    return y.to(x.dtype)


# Training statistics (nn.py:114-200). "centered" is the two-pass form;
# "single_read_grouped" reads the activation once for both moments, in
# BN_GROUPS fixed groups of the leading axis combined in a fixed order with
# Neumaier compensation, and falls back to "centered" when the leading
# axis does not divide into the groups. The JAX package sets the mode with
# a trace-time context (nn.bn_stats_mode); here it is an argument.
BN_STATS_MODES = ("centered", "single_read_grouped")
BN_GROUPS = 8


def check_bn_stats(mode: str) -> None:
    if mode not in BN_STATS_MODES:
        raise ValueError(f"bn_stats must be one of {BN_STATS_MODES}, "
                         f"got {mode!r}")


def validate_bn_stats_mesh(bn_stats: str, data_shards: int,
                           segments: int = 1) -> None:
    """Refuse single_read_grouped where the data axis does not divide the
    fixed BN_GROUPS: a group would straddle ranks (nn.py:141-153). A step
    whose BN input concatenates ``segments`` sharded batches (the joint
    step's (2B, .) decoder pass, ``parallel.mesh.segments``) needs
    ``segments`` x the data axis to divide them."""
    if bn_stats == "single_read_grouped" and \
            BN_GROUPS % (segments * data_shards) != 0:
        what = (f"data mesh axis ({data_shards} shards)" if segments == 1
                else f"{segments} x the data mesh axis ({data_shards} "
                f"shards; {segments} batches decoded in one pass)")
        raise ValueError(
            f"training.bn_stats='single_read_grouped' requires the {what} "
            f"to divide _BN_GROUPS={BN_GROUPS}; use bn_stats='centered' on "
            f"larger meshes (see docs/PERF.md #7)")


def _unmarked(tree: dict) -> dict:
    """Shallow copies of ``tree``'s tensors without the column-sharded
    mark, for the local computation on this rank's columns."""
    return {k: v.view_as(v) for k, v in tree.items()}


def _neumaier_combine(parts: Tensor) -> Tensor:
    """Sum the leading axis of ``parts`` (G, C) in a fixed sequential order
    with Neumaier compensation (nn.py:170-184)."""
    s = parts[0]
    c = torch.zeros_like(s)
    for i in range(1, parts.shape[0]):
        p = parts[i]
        t = s + p
        c = c + torch.where(s.abs() >= p.abs(), (s - t) + p, (p - t) + s)
        s = t
    return s + c


def _grouped_moments(x32: Tensor, mesh: Optional[mesh_lib.Mesh] = None
                     ) -> Tuple[Tensor, Tensor]:
    """(mean, biased var) over all but the last axis in one read, in
    BN_GROUPS groups of the leading axis (nn.py:187-200). Under a mesh
    each rank holds BN_GROUPS / n_data whole groups of every segment
    (``parallel.mesh.segments``); their sums and sums of squares are
    gathered in rank order, so every rank combines the same 8 partials a
    single device does."""
    ch = x32.shape[-1]
    n = x32.numel() // ch
    if mesh is None:
        xg = x32.reshape(BN_GROUPS, n // BN_GROUPS, ch)
        s, q = xg.sum(dim=1), (xg * xg).sum(dim=1)
    else:
        seg = mesh_lib.active_segments()
        # validate_bn_stats_mesh refuses such a mesh before a step runs
        assert BN_GROUPS % (seg * mesh.n_data) == 0, (seg, mesh.n_data)
        xg = x32.reshape(seg, BN_GROUPS // (seg * mesh.n_data), -1, ch)
        parts = torch.stack([xg.sum(dim=2), (xg * xg).sum(dim=2)])
        parts = collectives.all_gather(parts[None], mesh.data_group)
        # (rank, moment, segment, group) -> (moment, segment, rank, group)
        parts = parts.permute(1, 2, 0, 3, 4).reshape(2, BN_GROUPS, ch)
        s, q = parts[0], parts[1]
        n *= mesh.n_data
    total = _neumaier_combine(s)
    total_sq = _neumaier_combine(q)
    mean = total / n
    var = torch.clamp(total_sq / n - mean * mean, min=0.0)
    return mean, var


def batchnorm_train(params: dict, state: dict, x: Tensor, *,
                    mode: str = "centered", momentum: float = 0.1,
                    eps: float = 1e-5) -> Tuple[Tensor, dict]:
    """Training BatchNorm over every axis but the last (nn.py:222-261):
    batch statistics in f32 by ``mode`` (one of BN_STATS_MODES),
    normalised with the biased variance; the running variance takes the
    unbiased one (n / (n - 1)), momentum 0.1. Returns (y in the input's
    dtype, new state); the new state carries no gradient. Under a mesh
    the statistics and n are the whole data group's: the leading axis is
    then this rank's rows of the global batch."""
    check_bn_stats(mode)
    tp = _sharded_mesh(params["scale"])
    if tp is not None:
        y, new_state = batchnorm_train(
            _unmarked(params), _unmarked(state),
            mesh_lib.column_block(tp, collectives.enter_columns(x, tp)),
            mode=mode, momentum=momentum, eps=eps)
        return (collectives.gather_columns(y, tp),
                {k: mesh_lib.mark_model_sharded(v)
                 for k, v in new_state.items()})
    mesh = mesh_lib.active()
    if mesh is not None and mesh.n_data == 1:
        mesh = None
    shards = mesh.n_data if mesh is not None else 1
    x32 = x.float()
    axes = tuple(range(x.ndim - 1))
    n = x.numel() // x.shape[-1] * shards
    if mode == "single_read_grouped" and \
            (x.shape[0] * shards) % BN_GROUPS == 0:
        mean, var = _grouped_moments(x32, mesh)
    elif mesh is None:
        mean = x32.mean(dim=axes)
        var = (x32 - mean).square().mean(dim=axes)
    else:
        mean = collectives.sum_over_data(x32.sum(dim=axes), mesh) / n
        var = collectives.sum_over_data(
            (x32 - mean).square().sum(dim=axes), mesh) / n
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_state = {
            "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
            "var": (1.0 - momentum) * state["var"] + momentum * unbiased,
        }
    inv = torch.rsqrt(var + eps)
    y = (x32 - mean) * (inv * params["scale"].float()) + params["bias"].float()
    return y.to(x.dtype), new_state


def layernorm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layernorm(params: dict, x: Tensor, *, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis with the biased variance (nn.py:279-283)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - mean) * torch.rsqrt(var + eps) * _whole(params["scale"])
            + _whole(params["bias"]))


def leaky_relu(x: Tensor, leak: float = 0.2) -> Tensor:
    return torch.where(x >= 0, x, leak * x)


def spectral_norm_init(generator: torch.Generator,
                       w_shape: Tuple[int, int]) -> dict:
    """Unit-norm singular-vector estimates for an (in, out) weight: u of
    length out, v of length in (nn.py:304-317)."""
    in_dim, out_dim = w_shape
    u = torch.randn(out_dim, generator=generator)
    v = torch.randn(in_dim, generator=generator)
    return {"u": u / (u.norm() + 1e-12), "v": v / (v.norm() + 1e-12)}


def spectral_norm_eval(w: Tensor, state: dict) -> Tensor:
    """w / sigma with sigma = v . (W u) from the stored singular-vector
    estimates; eval mode runs no power iteration (nn.py:335-349)."""
    return w / torch.dot(state["v"], w @ state["u"])


def spectral_norm_apply(w: Tensor, state: dict, *, training: bool,
                        n_iter: int = 1, eps: float = 1e-12
                        ) -> Tuple[Tensor, dict]:
    """(w / sigma, new state) (nn.py:320-349). In training mode ``n_iter``
    power iterations on the detached weight advance u and v first (torch
    order for an (out, in) weight: v = normalize(W^T u), u =
    normalize(W v)). u and v are constants for differentiation while sigma
    = v . (W u) stays a function of w, so WGAN-GP's double backward runs
    through w / sigma. Column-sharded leaves are gathered whole for the
    iteration and sigma, so every rank keeps the same u and v; the result
    is ``w`` (this rank's columns) over sigma."""
    u, v = _whole(state["u"]).detach(), _whole(state["v"]).detach()
    w_all = _whole(w)
    if training:
        w_c = w_all.detach()
        for _ in range(n_iter):
            v = w_c @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = v @ w_c
            u = u / (torch.linalg.vector_norm(u) + eps)
        mesh = mesh_lib.active()
        state = {k: (mesh_lib.mark_model_sharded(
            mesh_lib.column_block(mesh, new).contiguous())
            if mesh_lib.is_model_sharded(state[k]) else new)
            for k, new in (("u", u), ("v", v))}
    sigma = torch.dot(v, w_all @ u)
    tp = _sharded_mesh(w)
    if tp is not None:
        # every column's output reads sigma
        sigma = collectives.enter_columns(sigma, tp)
    return w / sigma, state


def dropout(x: Tensor, keep_mask: Optional[Tensor], rate: float) -> Tensor:
    """Inverted dropout given the keep mask (boolean, x's shape), as
    jax.random.bernoulli(key, 1 - rate, x.shape) draws it (nn.py:291-296);
    ``keep_mask=None`` or rate 0 is the identity."""
    if keep_mask is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(keep_mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
