"""The collectives the mesh's layers use, differentiable where a layer
needs them to be, as SyncBatchNorm's are.

* ``all_reduce_sum`` over a group: the backward is an all-reduce too
  (every rank's loss term reads the sum).
* ``all_gather`` over "data" along the leading axis, in group-rank
  order: each rank's loss term reads every rank's block, so the backward
  sums the gradient over the group and keeps this rank's block.
* ``gather_columns`` over "model": every rank computes the same loss from
  the gathered tensor, so the backward keeps this rank's columns alone.
* ``enter_columns``: the identity on a tensor every model rank holds
  whole (a layer's input, a spectral norm's sigma) where it meets this
  rank's columns; each rank's backward sees only its columns'
  contribution, so the backward sums the gradient over "model".

Under the ``gloo`` backend a CUDA tensor is staged through host memory
(``_host_staged``) on every call: the port does not rely on gloo's CUDA
paths. That is how ranks sharing one card, or a CPU-only build, run the
same code as NCCL ranks. A group of None is one rank: every function is
then the identity. ``calls`` counts the collectives issued, by kind.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor

calls: collections.Counter = collections.Counter()


def _host_staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _raw_all_reduce(x: Tensor, group) -> Tensor:
    """Sum of ``x`` over ``group``, a new tensor on ``x``'s device."""
    if group is None:
        return x
    calls["all_reduce"] += 1
    if x.is_cuda and _host_staged(group):
        host = x.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def _raw_all_gather(x: Tensor, group) -> Tensor:
    """The blocks of ``x`` of every rank of ``group`` concatenated along
    dim 0 in group-rank order."""
    if group is None:
        return x
    calls["all_gather"] += 1
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    if src.is_cuda and _host_staged(group):
        host = src.cpu()
        parts: List[Tensor] = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts).to(x.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts)


def broadcast_(x: Tensor, src: int = 0, group=None) -> Tensor:
    """Overwrite ``x`` with rank ``src``'s (a global rank) in place."""
    calls["broadcast"] += 1
    with torch.no_grad():
        if x.is_cuda and _host_staged(group):
            host = x.detach().cpu()
            dist.broadcast(host, src=src, group=group)
            x.detach().copy_(host)
        else:
            dist.broadcast(x.detach(), src=src, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose ranks each hold a term of the loss: the
    gradient of every rank's input is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _raw_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """Gather over "data" (loss terms on every rank): the backward sums
    the gradient over the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _raw_all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = _AllReduceSum.apply(g, ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


# Over "model" every rank computes the same loss once, so the four
# functions below come in adjoint pairs (Megatron's f / g): entering the
# columns is the identity with a summing backward, a sum the identity
# backward; a gather keeps this rank's block backward, a split gathers.
# Each backward is its adjoint function, so a double backward holds.


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceModel.apply(g, ctx.group), None


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _raw_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _EnterModel.apply(g, ctx.group), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _raw_all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _SplitModel.apply(g, ctx.group), None


class _SplitModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        rows = x.shape[0] // dist.get_world_size(group)
        r = dist.get_rank(group)
        return x[r * rows:(r + 1) * rows].clone()

    @staticmethod
    def backward(ctx, g):
        return _GatherModel.apply(g, ctx.group), None


def enter_columns(x: Tensor, mesh) -> Tensor:
    """``x`` (whole on every model rank) as the input of a computation on
    this rank's columns: the identity, whose backward sums over "model"."""
    if mesh is None or mesh.n_model == 1:
        return x
    return _EnterModel.apply(x, mesh.model_group)


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """Differentiable sum over ``group`` (None: the identity)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather(x: Tensor, group) -> Tensor:
    """Differentiable concatenation of every data rank's ``x`` along dim 0
    (see ``_AllGather``)."""
    if group is None:
        return x
    return _AllGather.apply(x, group)


def gather_columns(x: Tensor, mesh) -> Tensor:
    """The whole last axis of a column-sharded ``x``: every model rank's
    columns, in rank order. The backward keeps this rank's columns."""
    if mesh is None or mesh.n_model == 1:
        return x
    full = _GatherModel.apply(x.movedim(-1, 0), mesh.model_group)
    return full.movedim(0, -1)


def sum_over_data(x: Tensor, mesh) -> Tensor:
    """Differentiable sum of ``x`` over the data group."""
    return all_reduce_sum(x, mesh.data_group if mesh is not None else None)


def all_reduce_grads(params: List[Tensor], mesh) -> None:
    """Sum the gradients of ``params`` over the data group in one flat
    bucket: one collective a step, not one a leaf. Leaves without a
    gradient (the same on every rank) are left alone."""
    group = mesh.data_group if mesh is not None else None
    if group is None:
        return
    with_grad = [p for p in params if p.grad is not None]
    if not with_grad:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in with_grad])
    flat = _raw_all_reduce(flat, group)
    offset = 0
    for p in with_grad:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def gather_rows(x: Tensor, mesh) -> Tensor:
    """Every data rank's rows of ``x`` (no gradient), in rank order."""
    group: Optional[object] = mesh.data_group if mesh is not None else None
    return _raw_all_gather(x, group)


def sum_values(x: Tensor, mesh) -> Tensor:
    """A detached partial (a loss term) summed over the data group."""
    group = mesh.data_group if mesh is not None else None
    return _raw_all_reduce(x.detach(), group)
