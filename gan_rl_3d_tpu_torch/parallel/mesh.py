"""The ("data", "model") mesh over torch.distributed
(gan_rl_3d_tpu/parallel/mesh.py).

One process drives one device, launched by ``torchrun`` (or spawned by a
test). The world's ranks are laid out ``ranks.reshape(n_data, n_model)``:

* "data" shards the batch: every rank of a data group holds its own
  contiguous rows, training BatchNorm takes its statistics across the
  group (``nn.batchnorm_train``) and the gradients are summed over it in
  one flat bucket a step (``train.steps``).
* "model" shards the wide layers of the decoder, the generator and the
  discriminator by output column (``shard_model_for_mesh``): a marked
  leaf computes its own columns and ``parallel.collectives`` gathers them
  before the next layer.

Without a process group the mesh is 1x1 and every collective is the
identity, so a single-process run takes the code path it always took.
The JAX package declares shardings and lets XLA place the collectives;
here the mesh a step runs under is explicit: a step takes ``mesh=`` and
activates it (``use``) for the layers it calls, which read ``active()``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gan_rl_3d_tpu_torch.parallel import collectives
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Fixed group count for shard-aligned resident-data shuffling
# (training.data_residency="sharded"): the same 8-way contract as
# nn.BN_GROUPS. Plans are computed for 8 groups whatever the mesh, so
# trajectories are mesh-independent and the resident gather is local on
# any data axis that divides 8 (mesh.py:53-60).
DATA_SHARD_GROUPS = 8

# modules whose wide layers are column-sharded along "model": the
# decoder's 256 x 6144 head and the 512-wide latent-GAN layers
# (mesh.py:110-114). Everything else stays replicated.
_TP_MODULES = ("decoder", "generator", "discriminator")


@dataclass
class Mesh:
    """This rank's place in the (data, model) layout and its groups.
    ``data_group`` / ``model_group`` are None on an axis of size 1, where
    a collective over the axis is the identity; ``group`` holds every rank
    of the mesh (None: the whole process group), ``root`` its first."""

    shape: dict
    rank: int = 0
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    group: Any = None
    root: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def init_distributed(backend: str,
                     device: "str | torch.device" = "cuda") -> torch.device:
    """Join the process group torchrun describes (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) and return this
    rank's device. The backend is explicit: ``nccl`` on the card, ``gloo``
    on the CPU (or to share one card between ranks). On ``cuda`` the rank
    runs on ``cuda:LOCAL_RANK``."""
    dev = local_device(device)
    if dev.type == "cpu" and backend == "nccl":
        raise ValueError("backend 'nccl' needs CUDA devices; use "
                         "--dist-backend gloo with --device cpu")
    # NCCL binds the rank to its card at once (no guessing from the rank)
    bind = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **bind)
    return dev


def local_device(device: "str | torch.device") -> torch.device:
    """``device``, and on ``cuda`` this process's card: ``cuda:LOCAL_RANK``
    (torchrun's), made the current device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              ranks: Optional[Sequence[int]] = None,
              device: "str | torch.device | None" = None
              ) -> Optional[Mesh]:
    """A ("data", "model") mesh over ``ranks`` (default: every rank of the
    process group; the JAX function's ``devices``), or 1x1 without a
    group. Defaults to every rank on "data" (mesh.py:26-40). Every rank of
    the group must call it with the same arguments, since it creates the
    subgroups; a rank outside ``ranks`` gets None."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else list(ranks)
    if n_data is None:
        n_data = len(ranks) // n_model
    assert n_data * n_model == len(ranks), (
        f"{n_data}x{n_model} mesh needs {n_data * n_model} devices, "
        f"have {len(ranks)}")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
    if world == 1:
        return Mesh(shape, device=dev)
    rank = dist.get_rank()
    layout = np.asarray(ranks).reshape(n_data, n_model)
    group = dist.new_group(ranks) if len(ranks) < world else None
    data_group = model_group = None
    # every rank creates every subgroup, in the same order
    for m in range(n_model):
        g = dist.new_group(layout[:, m].tolist()) if n_data > 1 else None
        if rank in layout[:, m]:
            data_group = g
    for d in range(n_data):
        g = dist.new_group(layout[d].tolist()) if n_model > 1 else None
        if rank in layout[d]:
            model_group = g
    if rank not in ranks:
        return None
    at = ranks.index(rank)
    return Mesh(shape, rank=rank, data_rank=at // n_model,
                model_rank=at % n_model, data_group=data_group,
                model_group=model_group, group=group, root=ranks[0],
                device=dev)


# ---------------------------------------------------------------------------
# the mesh a step runs under
# ---------------------------------------------------------------------------

_ACTIVE: List[Optional[Mesh]] = [None]


def active() -> Optional[Mesh]:
    """The mesh the running step activated, or None (one device)."""
    return _ACTIVE[-1]


@contextlib.contextmanager
def use(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the block under ``mesh`` (None: this rank alone, as the
    replicated TD3 update runs)."""
    _ACTIVE.append(mesh if mesh is not None and mesh.size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.pop()


_SEGMENTS: List[int] = [1]


def active_segments() -> int:
    """How many batch-sharded blocks a BatchNorm input concatenates along
    its leading axis (``segments``); 1 outside such a block."""
    return _SEGMENTS[-1]


@contextlib.contextmanager
def segments(k: int) -> Iterator[None]:
    """Layers in the block take inputs that concatenate ``k`` batches
    along the leading axis, each sharded over "data" (the joint step's
    (2B, .) decoder pass): single_read_grouped then lays its groups out
    per block, as a single device sees the concatenation."""
    _SEGMENTS.append(k)
    try:
        yield
    finally:
        _SEGMENTS.pop()


def data_shards() -> int:
    mesh = active()
    return mesh.n_data if mesh is not None else 1


def is_writer() -> bool:
    """True on the rank that writes files and prints (rank 0), and
    without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ---------------------------------------------------------------------------
# batches and resident data
# ---------------------------------------------------------------------------


def process_local_slice(global_batch: int,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> slice:
    """Rows [p*B/P, (p+1)*B/P) of the global batch that process p owns
    (mesh.py:93-111). ``global_batch`` must divide evenly."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % process_count != 0:
        raise ValueError(
            f"global batch {global_batch} must divide evenly across "
            f"{process_count} processes (fixed shapes everywhere)")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def local_rows(mesh: Optional[Mesh], x, axis: int = 0):
    """This rank's contiguous block of ``x`` along ``axis`` (the data
    axis's rows; the model axis shares them)."""
    if mesh is None or mesh.n_data == 1:
        return x
    s = process_local_slice(x.shape[axis], mesh.data_rank, mesh.n_data)
    index = [slice(None)] * x.ndim
    index[axis] = s
    return x[tuple(index)]


def _to_device(mesh: Optional[Mesh], x):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(mesh.device) if mesh is not None else x


def shard_batch(mesh: Optional[Mesh], tree, *, process_local: bool = False):
    """This rank's rows of every array of a batch tree, on the mesh's
    device (mesh.py:70-90). ``process_local=False``: the leaves are the
    global batch and each rank takes its rows; ``process_local=True``: the
    leaves are already this rank's rows (``process_local_slice``)."""
    if process_local:
        return tree_map(lambda x: _to_device(mesh, x), tree)
    return tree_map(lambda x: _to_device(mesh, local_rows(mesh, x)), tree)


def row_sharding(mesh: Optional[Mesh], data):
    """This rank's row block of a resident split (1/n_data of it), for
    training.data_residency "sharded" (mesh.py:63-67)."""
    return _to_device(mesh, local_rows(mesh, data))


def replicated(mesh: Optional[Mesh], tree):
    """Every tensor leaf broadcast from the mesh's first rank, in place:
    one flat broadcast per (dtype, device)."""
    if mesh is None or mesh.size == 1:
        return tree
    buckets: dict = {}
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            buckets.setdefault((leaf.dtype, leaf.device), []).append(leaf)
    with torch.no_grad():
        for leaves in buckets.values():
            flat = torch.cat([x.detach().reshape(-1) for x in leaves])
            collectives.broadcast_(flat, src=mesh.root, group=mesh.group)
            offset = 0
            for x in leaves:
                x.detach().copy_(flat[offset:offset + x.numel()].view_as(x))
                offset += x.numel()
    return tree


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def _spec_for_param(path: str, leaf) -> Optional[str]:
    """MODEL_AXIS for a leaf sharded by output column, None when
    replicated (mesh.py:117-128): 2-D and 1-D leaves of the decoder, the
    generator and the discriminator whose last dimension is even and at
    least 512. ``path`` names the leaf as jax.tree_util.keystr does."""
    if not any(m in path for m in _TP_MODULES):
        return None
    if leaf.ndim in (1, 2) and leaf.shape[-1] % 2 == 0 \
            and leaf.shape[-1] >= 512:
        return MODEL_AXIS
    return None


def _keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_with_path(fn, v, path + (i,))
                 for i, v in enumerate(tree)]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    if tree is None:
        return None
    return fn(_keystr(path), tree)


def model_sharded_leaves(tree):
    """The tree of whether ``shard_model_for_mesh`` shards each leaf along
    "model" (the leaves whose JAX spec is not P())."""
    return _map_with_path(
        lambda p, x: hasattr(x, "ndim") and _spec_for_param(p, x) is not None,
        tree)


def is_model_sharded(t) -> bool:
    """Whether ``t`` holds this rank's columns of a column-sharded leaf."""
    return bool(getattr(t, "model_sharded", False))


def mark_model_sharded(t: torch.Tensor) -> torch.Tensor:
    t.model_sharded = True
    return t


def keep_mark(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst`` (a cast or copy of ``src``) marked as ``src`` is."""
    if is_model_sharded(src) and dst is not src:
        mark_model_sharded(dst)
    return dst


def column_block(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the last axis of ``x`` along "model"."""
    per = x.shape[-1] // mesh.n_model
    return x[..., mesh.model_rank * per:(mesh.model_rank + 1) * per]


def shard_model_for_mesh(mesh: Optional[Mesh], model_tree):
    """The params/state tree on the mesh (mesh.py:131-146): on a model
    axis wider than 1, the leaves ``_spec_for_param`` names become this
    rank's column block, contiguous and marked (``is_model_sharded``);
    every other leaf is replicated from rank 0. A leaf that requires grad
    keeps requiring it."""
    replicated(mesh, model_tree)
    if mesh is None or mesh.n_model == 1:
        return model_tree

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor) or \
                _spec_for_param(path, leaf) is None:
            return leaf
        block = column_block(mesh, leaf.detach()).contiguous()
        block.requires_grad_(leaf.requires_grad)
        return mark_model_sharded(block)

    return _map_with_path(place, model_tree)


def gather_model(mesh: Optional[Mesh], tree):
    """The tree with every column-sharded leaf gathered whole (detached,
    unmarked): what a checkpoint holds, equal to a single-device tree."""
    if mesh is None or mesh.n_model == 1:
        return tree

    def full(x):
        if not is_model_sharded(x):
            return x
        return collectives.gather_columns(x.detach(), mesh)

    return tree_map(full, tree)
