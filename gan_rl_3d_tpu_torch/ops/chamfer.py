"""Chamfer distance and its gradient (gan_rl_3d_tpu/ops/chamfer.py).

``nearest_distances`` runs kernel K3 forward and kernels K4 (gather) and
K5 (scatter) backward inside one ``torch.autograd.Function``, the port of
the JAX custom VJP ``_nearest_tpu`` (chamfer.py:330-356);
``nearest_min_distances`` runs kernel K2 and has no gradient, as in the
JAX package. On CUDA tensors the wrappers launch the hand-written kernels
``csrc/nn_dist.cu`` and ``csrc/nn_grad.cu``; on CPU tensors they run their
plain PyTorch versions. The kernels take any N and M.

All distances follow the reference convention: unsquared Euclidean
nearest-neighbour distances, averaged per cloud.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gan_rl_3d_tpu_torch.ops import _cuda

Tensor = torch.Tensor

_BIG = 1e30
_MIN_DIST = 1e-6


def _sqdist(a: Tensor, b: Tensor, b_mask: Optional[Tensor]) -> Tensor:
    """d2 = (|a|^2 + |b|^2) + (-2a).b with invalid b points' |b|^2 raised by
    1e30, the association and mask fold of the TPU kernel
    (chamfer.py:89,112-119)."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1)[:, None, :]
    if b_mask is not None:
        b2 = b2 + (1.0 - b_mask.float())[:, None, :] * _BIG
    return (a2 + b2) + torch.bmm(a * -2.0, b.transpose(1, 2))


def nearest_distances_plain(a: Tensor, b: Tensor,
                            b_mask: Optional[Tensor] = None
                            ) -> Tuple[Tensor, Tensor]:
    """Plain version of K3 (follows _nearest_jnp, chamfer.py:55-63):
    (dist (B, N) f32, idx (B, N) int32), the first index among equal
    minima, dist clamped at 1e-12 before the sqrt."""
    dmin, idx = _sqdist(a.float(), b.float(), b_mask).min(dim=-1)
    return torch.sqrt(torch.clamp(dmin, min=1e-12)), idx.to(torch.int32)


def nearest_min_distances_plain(a: Tensor, b: Tensor) -> Tensor:
    """Plain version of K2: the distances of nearest_distances_plain."""
    dmin = _sqdist(a.float(), b.float(), None).amin(dim=-1)
    return torch.sqrt(torch.clamp(dmin, min=1e-12))


def nearest_grad_a_plain(a: Tensor, b: Tensor, idx: Tensor, dist: Tensor,
                         g: Tensor) -> Tensor:
    """Plain version of K4, fused as the kernel is: the gradient of
    sum_i g_i dist_i w.r.t. a (chamfer.py:344-347),
    da = where(dist > 1e-6, g / max(dist, 1e-6), 0) * (a - b[idx])."""
    b_near = torch.gather(b, 1, idx.long()[..., None].expand(-1, -1, 3))
    safe = torch.where(dist > _MIN_DIST, g / torch.clamp(dist, min=_MIN_DIST),
                       torch.zeros_like(dist))
    return safe[..., None] * (a - b_near)


def nearest_grad_b_plain(idx: Tensor, da: Tensor, m: int) -> Tensor:
    """Plain version of K5: db_j = -sum_{i: idx_i = j} da_i, (B, M, 3)
    (chamfer.py:348-352), summed as the kernel sums: from +0 in float32,
    over increasing i, then 0 - s.

    A stable sort of the flat targets lines each target's points up in
    increasing i; pass r adds, for every target at once, the r-th point of
    its segment. Each element gets the kernel's sequence of f32 adds, so
    the two agree bit for bit (indices outside [0, M) are skipped, as the
    kernel skips them)."""
    bsz, n = idx.shape
    dev = da.device
    key = idx.long() + m * torch.arange(bsz, device=dev)[:, None]
    valid = ((idx >= 0) & (idx < m)).reshape(-1)
    key = key.reshape(-1)[valid]
    vals = da.float().reshape(-1, 3)[valid]
    key, perm = torch.sort(key, stable=True)
    vals = vals[perm]
    counts = torch.bincount(key, minlength=bsz * m)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(key.numel(), device=dev) - starts[key]
    # group the sorted points by rank (stable: targets stay unique per group)
    rank, by_rank = torch.sort(rank, stable=True)
    key, vals = key[by_rank], vals[by_rank]
    bounds = torch.bincount(rank).cumsum(0).tolist() if rank.numel() else []
    acc = torch.zeros((bsz * m, 3), dtype=torch.float32, device=dev)
    lo = 0
    for hi in bounds:
        k = key[lo:hi]
        acc[k] = acc[k] + vals[lo:hi]
        lo = hi
    return (torch.zeros((), device=dev) - acc).reshape(bsz, m, 3)


def _lib(name: str) -> ctypes.CDLL:
    lib = _cuda.library(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "nn_dist" and lib.grl_nn_dist.argtypes is None:
        lib.grl_nn_dist.argtypes = [p, p, p, i, i, i, p, p, p]
        lib.grl_nn_dist.restype = i
        lib.grl_nn_min.argtypes = [p, p, i, i, i, p, p]
        lib.grl_nn_min.restype = i
    if name == "nn_grad" and lib.grl_nn_grad_a.argtypes is None:
        lib.grl_nn_grad_a.argtypes = [p, p, p, p, p, i, i, i, p, p]
        lib.grl_nn_grad_a.restype = i
        lib.grl_nn_grad_b.argtypes = [p, p, i, i, i, p, p, p]
        lib.grl_nn_grad_b.restype = i
        lib.grl_nn_grad_b_scratch.argtypes = [i, i]
        lib.grl_nn_grad_b_scratch.restype = ctypes.c_longlong
    return lib


def _check_clouds(a: Tensor, b: Tensor, what: str) -> Tuple[Tensor, Tensor]:
    _cuda.require_cuda(a, what)
    if (a.ndim != 3 or b.ndim != 3 or a.shape[-1] != 3 or b.shape[-1] != 3
            or a.shape[0] != b.shape[0]):
        raise ValueError(f"{what}: expected a (B, N, 3) and b (B, M, 3), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"{what}: a on {a.device}, b on {b.device}")
    if not (a.shape[0] >= 1 and a.shape[1] >= 1 and b.shape[1] >= 1):
        raise ValueError(f"{what}: empty batch "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    return (a.to(torch.float32).contiguous(), b.to(torch.float32).contiguous())


def _check_rows(t: Tensor, shape: tuple, dtype: torch.dtype, device,
                what: str) -> Tensor:
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{what}: expected {shape} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    return t.contiguous()


def _nearest_forward(a: Tensor, b: Tensor, b_mask: Optional[Tensor]
                     ) -> Tuple[Tensor, Tensor]:
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return nearest_distances_plain(a, b, b_mask)
    a, b = _check_clouds(a, b, "nearest_distances")
    bsz, n, _ = a.shape
    m = b.shape[1]
    if b_mask is not None:
        if b_mask.shape != (bsz, m) or b_mask.device != a.device:
            raise ValueError(f"b_mask must be (B, M) = {(bsz, m)} on "
                             f"{a.device}, got {tuple(b_mask.shape)}")
        b_mask = b_mask.to(torch.float32).contiguous()
    dist = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    idx = torch.empty((bsz, n), dtype=torch.int32, device=a.device)
    lib = _lib("nn_dist")
    with torch.cuda.device(a.device):
        err = lib.grl_nn_dist(a.data_ptr(), b.data_ptr(),
                              b_mask.data_ptr() if b_mask is not None else None,
                              bsz, n, m, dist.data_ptr(), idx.data_ptr(),
                              _cuda.stream_of(a))
    _cuda.check(err, lib, "nn_dist")
    _cuda.launch_counts["nn_dist"] += 1
    return dist, idx


def nearest_grad_a(a: Tensor, b: Tensor, idx: Tensor, dist: Tensor,
                   g: Tensor) -> Tensor:
    """K4: the gradient w.r.t. ``a`` (B, N, 3) of sum_i g_i dist_i, given
    K3's ``dist`` and ``idx`` (B, N) and the cotangent ``g`` (B, N).

    The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return nearest_grad_a_plain(a, b, idx, dist, g)
    a, b = _check_clouds(a, b, "nearest_grad_a")
    bsz, n, _ = a.shape
    m = b.shape[1]
    idx = _check_rows(idx, (bsz, n), torch.int32, a.device, "nearest_grad_a idx")
    dist = _check_rows(dist, (bsz, n), torch.float32, a.device,
                       "nearest_grad_a dist")
    g = _check_rows(g, (bsz, n), torch.float32, a.device, "nearest_grad_a g")
    da = torch.empty((bsz, n, 3), dtype=torch.float32, device=a.device)
    lib = _lib("nn_grad")
    with torch.cuda.device(a.device):
        err = lib.grl_nn_grad_a(a.data_ptr(), b.data_ptr(), idx.data_ptr(),
                                dist.data_ptr(), g.data_ptr(), bsz, n, m,
                                da.data_ptr(), _cuda.stream_of(a))
    _cuda.check(err, lib, "nn_gather")
    _cuda.launch_counts["nn_gather"] += 1
    return da


def nearest_grad_b(idx: Tensor, da: Tensor, m: int) -> Tensor:
    """K5: db (B, M, 3) with db_j = -sum_{i: idx_i = j} da_i, summed in
    increasing i by a counting sort (deterministic: the same inputs give
    the same bits, those of ``nearest_grad_b_plain``).

    The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if da.device.type == "cpu":
        return nearest_grad_b_plain(idx, da, m)
    _cuda.require_cuda(da, "nearest_grad_b")
    if da.ndim != 3 or da.shape[-1] != 3:
        raise ValueError(f"nearest_grad_b: da must be (B, N, 3), got "
                         f"{tuple(da.shape)}")
    bsz, n, _ = da.shape
    if not (bsz >= 1 and n >= 1 and m >= 1):
        raise ValueError(f"nearest_grad_b: empty batch "
                         f"{tuple(da.shape)}, M={m}")
    da = _check_rows(da, (bsz, n, 3), torch.float32, da.device,
                     "nearest_grad_b da")
    idx = _check_rows(idx, (bsz, n), torch.int32, da.device,
                      "nearest_grad_b idx")
    db = torch.empty((bsz, m, 3), dtype=torch.float32, device=da.device)
    lib = _lib("nn_grad")
    words = lib.grl_nn_grad_b_scratch(n, m)
    scratch = (torch.empty((bsz, words), dtype=torch.int32, device=da.device)
               if words else None)
    with torch.cuda.device(da.device):
        err = lib.grl_nn_grad_b(idx.data_ptr(), da.data_ptr(), bsz, n, m,
                                None if scratch is None else scratch.data_ptr(),
                                db.data_ptr(), _cuda.stream_of(da))
    _cuda.check(err, lib, "nn_scatter")
    _cuda.launch_counts["nn_scatter"] += 1
    return db


class _Nearest(torch.autograd.Function):
    """K3 forward, K4/K5 backward: the port of the custom VJP
    ``_nearest_tpu`` (chamfer.py:330-356). Masked b points are never
    selected, so their gradient is exactly zero; the mask and the integer
    index get none. K5 is skipped when ``b`` needs no gradient."""

    @staticmethod
    def forward(ctx, a, b, b_mask):
        dist, idx = _nearest_forward(a, b, b_mask)
        ctx.save_for_backward(a, b, dist, idx)
        ctx.mark_non_differentiable(idx)
        return dist, idx

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_idx):
        a, b, dist, idx = ctx.saved_tensors
        da = nearest_grad_a(a, b, idx, dist, g)
        db = nearest_grad_b(idx, da, b.shape[1]) if ctx.needs_input_grad[1] \
            else None
        return (da if ctx.needs_input_grad[0] else None), db, None


def nearest_distances(a: Tensor, b: Tensor, *,
                      b_mask: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Distance from each point of ``a`` (B, N, 3) to its nearest neighbour
    in ``b`` (B, M, 3), and that neighbour's index; ``b_mask`` (B, M) marks
    valid b points (chamfer.py:359-393). Returns (dist f32, idx int32),
    differentiable w.r.t. both clouds through the selected neighbour.

    K3 (and K4/K5 backward) on CUDA tensors, the plain versions on CPU
    tensors."""
    return _Nearest.apply(a.float(), b.float(), b_mask)


def nearest_min_distances(a: Tensor, b: Tensor) -> Tensor:
    """Distances only, no indices: the metrics path (chamfer.py:182-219).
    Like the JAX kernel it has no gradient.

    K2 on a CUDA tensor, the plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return nearest_min_distances_plain(a, b)
    _cuda.refuse_grad("nearest_min_distances", "the metrics path; use "
                      "nearest_distances for a loss", a, b)
    a, b = _check_clouds(a, b, "nearest_min_distances")
    bsz, n, _ = a.shape
    dist = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    lib = _lib("nn_dist")
    with torch.cuda.device(a.device):
        err = lib.grl_nn_min(a.data_ptr(), b.data_ptr(), bsz, n, b.shape[1],
                             dist.data_ptr(), _cuda.stream_of(a))
    _cuda.check(err, lib, "nn_min")
    _cuda.launch_counts["nn_min"] += 1
    return dist


def chamfer_distance_l2(a: Tensor, b: Tensor, *,
                        a_mask: Optional[Tensor] = None,
                        b_mask: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Tensor]:
    """Directed mean nearest-neighbour distances both ways, each (B,),
    averaged over the valid points (chamfer.py:401-424)."""
    d_ab, _ = nearest_distances(a, b, b_mask=b_mask)
    d_ba, _ = nearest_distances(b, a, b_mask=a_mask)
    if a_mask is not None:
        a_mask = a_mask.float()
        d_ab = (d_ab * a_mask).sum(1) / torch.clamp(a_mask.sum(1), min=1.0)
    else:
        d_ab = d_ab.mean(1)
    if b_mask is not None:
        b_mask = b_mask.float()
        d_ba = (d_ba * b_mask).sum(1) / torch.clamp(b_mask.sum(1), min=1.0)
    else:
        d_ba = d_ba.mean(1)
    return d_ab, d_ba


def chamfer_distance(a: Tensor, b: Tensor, *, bidirectional: bool = True,
                     a_mask: Optional[Tensor] = None,
                     b_mask: Optional[Tensor] = None) -> Tensor:
    """Per-cloud Chamfer distance (B,) (chamfer.py:427-442)."""
    d_ab, d_ba = chamfer_distance_l2(a, b, a_mask=a_mask, b_mask=b_mask)
    if bidirectional:
        return (d_ab + d_ba) / 2.0
    return d_ab
