"""Layers on plain tensors (gan_rl_3d_tpu/nn.py).

Parameters are dictionaries of tensors in the JAX package's layout: dense
weights are (in, out), so a layer is ``x @ w + b`` on channels-last input.
Initialisers draw from an explicit ``torch.Generator``. BatchNorm runs in
eval mode and in both training statistics modes of the JAX package;
LayerNorm and spectral norm have their inits and eval mode; dropout and
the spectral-norm power iteration come with the LGAN slice.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

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


def dense(params: dict, x: Tensor) -> Tensor:
    """``x @ w + b`` with f32 accumulation; the result follows the weight's
    dtype (nn.py:92-100)."""
    w = params["w"]
    y = torch.matmul(x.float(), w.float()) + params["b"].float()
    return y.to(w.dtype)


def batchnorm_eval(params: dict, state: dict, x: Tensor, *,
                   eps: float = 1e-5) -> Tensor:
    """BatchNorm with running statistics, normalising the last axis
    (nn.py:262-267). Computed in f32; the output follows the input dtype."""
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


def _grouped_moments(x32: Tensor) -> Tuple[Tensor, Tensor]:
    """(mean, biased var) over all but the last axis in one read, in
    BN_GROUPS groups of the leading axis (nn.py:187-200)."""
    ch = x32.shape[-1]
    n = x32.numel() // ch
    xg = x32.reshape(BN_GROUPS, n // BN_GROUPS, ch)
    total = _neumaier_combine(xg.sum(dim=1))
    total_sq = _neumaier_combine((xg * xg).sum(dim=1))
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
    dtype, new state); the new state carries no gradient."""
    if mode not in BN_STATS_MODES:
        raise ValueError(f"bn_stats must be one of {BN_STATS_MODES}, "
                         f"got {mode!r}")
    x32 = x.float()
    axes = tuple(range(x.ndim - 1))
    if mode == "single_read_grouped" and x.shape[0] % BN_GROUPS == 0:
        mean, var = _grouped_moments(x32)
    else:
        mean = x32.mean(dim=axes)
        var = (x32 - mean).square().mean(dim=axes)
    n = x.numel() // x.shape[-1]
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
    return (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]


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
