"""Training BatchNorm + ReLU after a dense layer as one autograd op.

``dense_bn_relu_train`` computes ``relu(batchnorm_train(dense(x)))``, the
block that ``models.common.bn_mlp_apply`` and the adaptive decoder's
refinement run in training. On one CUDA device in float32 it runs
``z = x @ w`` through ``torch.matmul`` (cuBLAS, no bias) and the rest in
the hand-written kernels of ``csrc/bn_train.cu``: two launches forward
(the statistics with the running state, then y) and two backward (two
channel sums, then dz with the dense bias's gradient). Everywhere else it
runs the composite, ``nn.dense`` -> ``nn.batchnorm_train`` ->
``torch.relu``: on the CPU, under a data mesh (cross-rank statistics), on
column-sharded leaves (tensor-parallel columns) and in any other dtype.
Callers with another activation call the composite themselves.

The forward's statistics are the composite's bit for bit (the kernels
add in PyTorch's own reduction order), and so are y and the new running
state. ``bn_relu_forward`` / ``bn_relu_backward`` launch the kernels on
CUDA tensors and run ``bn_relu_forward_plain`` / ``bn_relu_backward_plain``,
the kernels' arithmetic in plain PyTorch, on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.ops import _cuda
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor

# integer tickets the kernels' last blocks take (every launch leaves them
# 0), kept per device: the op's launches on a device are ordered, as on the
# one stream the port runs
_TICKETS = 1024
_INT_MAX = 2 ** 31 - 1
_tickets: Dict[torch.device, Tensor] = {}


def _rows(t: Tensor) -> Tensor:
    return t.reshape(-1, t.shape[-1])


def bn_relu_forward_plain(z: Tensor, b: Tensor, scale: Tensor, bias: Tensor,
                          run_mean: Tensor, run_var: Tensor, *,
                          grouped: bool, momentum: float = 0.1,
                          eps: float = 1e-5
                          ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain version of the forward kernels: (y, stats, new mean, new var)
    for x = z + b over every axis of ``z`` but the last, the statistics
    computed as ``nn.batchnorm_train`` computes them (``grouped``: the 8
    groups of rows' sums combined by ``nn._neumaier_combine``, else the
    centered form). ``stats`` (2, C) holds the batch mean and inv =
    rsqrt(var + eps), negated where the single-read variance clamped to 0
    (its gradient is then 0)."""
    x = _rows(z) + b
    n = x.shape[0]
    if grouped:
        xg = x.reshape(nn.BN_GROUPS, -1, x.shape[1])
        mean = nn._neumaier_combine(xg.sum(dim=1)) / n
        raw = nn._neumaier_combine((xg * xg).sum(dim=1)) / n - mean * mean
        var, live = torch.clamp(raw, min=0.0), raw >= 0
    else:
        mean = x.mean(dim=0)
        var = (x - mean).square().mean(dim=0)
        live = torch.ones_like(var, dtype=torch.bool)
    inv = torch.rsqrt(var + eps)
    y = torch.relu((x - mean) * (inv * scale) + bias)
    new_mean = (1.0 - momentum) * run_mean + momentum * mean
    new_var = ((1.0 - momentum) * run_var
               + momentum * (var * (n / max(n - 1, 1))))
    stats = torch.stack([mean, torch.where(live, inv, -inv)])
    return y.reshape(z.shape), stats, new_mean, new_var


def bn_relu_backward_plain(z: Tensor, b: Tensor, scale: Tensor,
                           bias: Tensor, stats: Tensor, dy: Tensor
                           ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain version of the backward kernels: (dz, db, d_scale, d_bias)
    from z and the forward's ``stats``, y recomputed for its ReLU mask.
    With g = dy [y > 0], k = inv * scale and x - mean = xc:
    dz = k g - k sum(g) / n - xc k inv^2 sum(g xc) / n (the last term 0
    where the variance clamped), db = sum dz; sums in float64."""
    xc = (_rows(z) + b) - stats[0]
    inv, live = stats[1].abs(), stats[1] > 0
    k = inv * scale
    zero = torch.zeros((), device=z.device)
    g = torch.where(xc * k + bias > 0, _rows(dy), zero)
    n = xc.shape[0]
    sum_g = g.double().sum(dim=0)
    sum_gx = (g.double() * xc.double()).sum(dim=0)
    c1 = (-k.double() * sum_g / n).float()
    c2 = torch.where(live, (-k.double() * inv.double() ** 2 * sum_gx / n)
                     .float(), zero)
    dz = xc * c2 + (k * g + c1)
    return (dz.reshape(z.shape), dz.double().sum(dim=0).float(),
            sum_gx.float() * inv, sum_g.float())


def _lib() -> ctypes.CDLL:
    lib = _cuda.library("bn_train")
    if lib.grl_bn_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        lib.grl_bn_scratch.argtypes = [ll, i, i]
        lib.grl_bn_scratch.restype = ll
        lib.grl_bn_forward.argtypes = [p, p, p, p, p, p, ll, i, i, f, f, f, f,
                                       p, p, i, p, p, p, p, p]
        lib.grl_bn_forward.restype = i
        lib.grl_bn_backward.argtypes = [p, p, p, p, p, p, ll, i, p, p, i, p,
                                        p, p, p, p, p]
        lib.grl_bn_backward.restype = i
    return lib


def _operand(t: Tensor, shape: tuple, device, what: str) -> Tensor:
    """``t`` as the kernels read it: float32, contiguous, 16-byte aligned."""
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{what}: expected {shape} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scratch(lib: ctypes.CDLL, rows: int, c: int, grouped: bool, device
             ) -> Tuple[Tensor, Tensor]:
    """The call's scratch and the device's tickets (under its context)."""
    tickets = _tickets.get(device)
    if tickets is None:
        tickets = _tickets[device] = torch.zeros(_TICKETS, dtype=torch.int32,
                                                 device=device)
    words = lib.grl_bn_scratch(rows, c, int(grouped))
    if words < 0:
        raise ValueError(f"bn_train: no kernel for {rows} rows of {c} "
                         "channels on this device")
    return torch.empty(words, dtype=torch.float64, device=device), tickets


def bn_relu_forward(z: Tensor, b: Tensor, scale: Tensor, bias: Tensor,
                    run_mean: Tensor, run_var: Tensor, *, grouped: bool,
                    momentum: float = 0.1, eps: float = 1e-5
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(y, stats, new running mean, new running var) of
    ``bn_relu_forward_plain``: the kernels on a CUDA ``z`` (a 2-D or wider
    float32 activation, C from its last axis; ``grouped`` needs its row
    count to divide by 8), the plain version on a CPU one."""
    if z.device.type == "cpu":
        return bn_relu_forward_plain(z, b, scale, bias, run_mean, run_var,
                                     grouped=grouped, momentum=momentum,
                                     eps=eps)
    _cuda.require_cuda(z, "bn_relu_forward")
    if z.ndim < 2 or z.numel() == 0:
        raise ValueError(f"bn_relu_forward: expected a non-empty (..., C) "
                         f"activation, got {tuple(z.shape)}")
    c = z.shape[-1]
    rows = z.numel() // c
    if grouped and rows % nn.BN_GROUPS:
        raise ValueError(f"bn_relu_forward: {rows} rows do not split into "
                         f"{nn.BN_GROUPS} groups")
    dev = z.device
    z = _operand(z, tuple(z.shape), dev, "bn_relu_forward z")
    b, scale, bias, run_mean, run_var = (
        _operand(t, (c,), dev, f"bn_relu_forward {name}") for t, name in (
            (b, "b"), (scale, "scale"), (bias, "bias"),
            (run_mean, "running mean"), (run_var, "running var")))
    lib = _lib()
    stats = torch.empty((2, c), dtype=torch.float32, device=dev)
    y = torch.empty_like(z)
    new_mean = torch.empty((c,), dtype=torch.float32, device=dev)
    new_var = torch.empty((c,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        scratch, tickets = _scratch(lib, rows, c, grouped, dev)
        err = lib.grl_bn_forward(
            z.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            run_mean.data_ptr(), run_var.data_ptr(), rows, c, int(grouped),
            1.0 - momentum, momentum, rows / max(rows - 1, 1), eps,
            scratch.data_ptr(), tickets.data_ptr(), _TICKETS,
            stats.data_ptr(), y.data_ptr(), new_mean.data_ptr(),
            new_var.data_ptr(), _cuda.stream_of(z))
    _cuda.check(err, lib, "bn_train_forward")
    _cuda.launch_counts["bn_train_forward"] += 1
    return y, stats, new_mean, new_var


def bn_relu_backward(z: Tensor, b: Tensor, scale: Tensor, bias: Tensor,
                     stats: Tensor, dy: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dz, db, d_scale, d_bias) of ``bn_relu_backward_plain``: the kernels
    on a CUDA ``z``, the plain version on a CPU one."""
    if z.device.type == "cpu":
        return bn_relu_backward_plain(z, b, scale, bias, stats, dy)
    _cuda.require_cuda(z, "bn_relu_backward")
    c = z.shape[-1]
    rows = z.numel() // c
    dev = z.device
    z = _operand(z, tuple(z.shape), dev, "bn_relu_backward z")
    dy = _operand(dy, tuple(z.shape), dev, "bn_relu_backward dy")
    stats = _operand(stats, (2, c), dev, "bn_relu_backward stats")
    b, scale, bias = (_operand(t, (c,), dev, f"bn_relu_backward {name}")
                      for t, name in ((b, "b"), (scale, "scale"),
                                      (bias, "bias")))
    lib = _lib()
    coef = torch.empty((2, c), dtype=torch.float32, device=dev)
    dz = torch.empty_like(z)
    db, d_scale, d_bias = (torch.empty((c,), dtype=torch.float32, device=dev)
                           for _ in range(3))
    with torch.cuda.device(dev):
        scratch, tickets = _scratch(lib, rows, c, False, dev)
        err = lib.grl_bn_backward(
            z.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            stats.data_ptr(), dy.data_ptr(), rows, c, scratch.data_ptr(),
            tickets.data_ptr(), _TICKETS, coef.data_ptr(), dz.data_ptr(),
            db.data_ptr(), d_scale.data_ptr(), d_bias.data_ptr(),
            _cuda.stream_of(z))
    _cuda.check(err, lib, "bn_train_backward")
    _cuda.launch_counts["bn_train_backward"] += 1
    return dz, db, d_scale, d_bias


class _BNReLU(torch.autograd.Function):
    """relu(batchnorm_train(z + b)) with its running state; saves z and the
    (2, C) statistics for the backward."""

    @staticmethod
    def forward(ctx, z, b, scale, bias, run_mean, run_var, grouped,
                momentum, eps):
        y, stats, new_mean, new_var = bn_relu_forward(
            z, b, scale, bias, run_mean, run_var, grouped=grouped,
            momentum=momentum, eps=eps)
        ctx.save_for_backward(z, b, scale, bias, stats)
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _d_mean, _d_var):
        grads = bn_relu_backward(*ctx.saved_tensors, dy)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None, None)


def _on_card(t: Tensor) -> bool:
    return t.device.type == "cuda"


def takes_op(dense_p: dict, bn_p: dict, bn_s: dict, x: Tensor) -> bool:
    """Whether ``dense_bn_relu_train`` runs the kernels for these operands:
    a float32 CUDA input of two or more axes and float32 leaves, an
    activation under 2^31 elements (PyTorch splits larger reductions), no
    data mesh (the statistics would cross ranks) and no column-sharded
    leaf."""
    leaves = (dense_p["w"], dense_p["b"], bn_p["scale"], bn_p["bias"],
              bn_s["mean"], bn_s["var"])
    mesh = mesh_lib.active()
    c = dense_p["w"].shape[-1]
    return (_on_card(x) and x.ndim >= 2
            and x.numel() // x.shape[-1] < _INT_MAX // c
            and (mesh is None or mesh.n_data == 1)
            and not any(mesh_lib.is_model_sharded(t) for t in leaves)
            and all(t.dtype == torch.float32 for t in (x, *leaves)))


def dense_bn_relu_train(dense_p: dict, bn_p: dict, bn_s: dict, x: Tensor, *,
                        mode: str = "centered", momentum: float = 0.1,
                        eps: float = 1e-5) -> Tuple[Tensor, dict]:
    """relu(batchnorm_train(dense(x))) and the new BatchNorm state, the
    statistics by ``mode`` (``nn.BN_STATS_MODES``): one autograd op over
    the kernels where ``takes_op``, else the composite."""
    nn.check_bn_stats(mode)
    if not takes_op(dense_p, bn_p, bn_s, x):
        y, new_state = nn.batchnorm_train(bn_p, bn_s, nn.dense(dense_p, x),
                                          mode=mode, momentum=momentum,
                                          eps=eps)
        return torch.relu(y), new_state
    z = torch.matmul(x, dense_p["w"])
    grouped = (mode == "single_read_grouped"
               and z.shape[0] % nn.BN_GROUPS == 0)
    y, mean, var = _BNReLU.apply(z, dense_p["b"], bn_p["scale"],
                                 bn_p["bias"], bn_s["mean"], bn_s["var"],
                                 grouped, momentum, eps)
    return y, {"mean": mean, "var": var}
