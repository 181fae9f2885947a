"""Checkpoints in the JAX package's two formats (gan_rl_3d_tpu/utils/
checkpoint.py:33-60), read and written without JAX, optax or orbax.

* A pickle of numpy trees: either package reads the other's file
  (``load_checkpoint(path, use_orbax=False)`` on the JAX side). The
  optimizer states and the RL replay ring of a JAX file unpickle into
  inert stand-ins (named tuples of numpy arrays); the port writes the
  stand-ins under the JAX package's module and class names
  (``save_checkpoint``), so the JAX package reads them back as optax's
  own states and its ``ReplayBuffer``.
* An orbax directory, the JAX trainer's default: ``_METADATA`` holds the
  tree (dict keys, sequence indices, empty dicts and Nones), and each
  array is a zarr v2 array (``<name>/.zarray`` and its chunks, zstd
  compressed) in an OCDBT key-value store (``utils.ocdbt``), decoded by
  ``utils.zstd``. ``load_checkpoint`` returns the tree that the JAX
  package's ``load_checkpoint(dir)`` restores without a target: nested
  dicts, sequences as lists, numpy arrays of the stored dtype and shape.
  The port writes pickles only.
"""

from __future__ import annotations

import itertools
import json
import math
import pickle
import shutil
from pathlib import Path
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from gan_rl_3d_tpu_torch.parallel.mesh import is_writer
from gan_rl_3d_tpu_torch.utils import zstd
from gan_rl_3d_tpu_torch.utils.ocdbt import OcdbtStore
from gan_rl_3d_tpu_torch.utils.tree import tree_map

PICKLE_PROTOCOL = 4


def to_numpy(x) -> np.ndarray:
    """A tensor (floating ones as float32) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32 if x.is_floating_point()
                             else x.dtype).numpy()
    return np.asarray(x)


class EmptyState(NamedTuple):
    """Stand-in for optax's EmptyState."""


class ScaleByAdamState(NamedTuple):
    """Stand-in for optax's ScaleByAdamState."""

    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """Stand-in for optax's ScaleByScheduleState."""

    count: Any


class ReplayBufferState(NamedTuple):
    """Stand-in for the JAX package's replay ring
    (gan_rl_3d_tpu/train/replay_buffer.py:26-33)."""

    states: Any
    actions: Any
    rewards: Any
    next_states: Any
    dones: Any
    ptr: Any
    size: Any


# the classes the stand-ins pickle as, and are read from
PICKLED_AS = {
    EmptyState: ("optax._src.base", "EmptyState"),
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    ScaleByScheduleState: ("optax._src.transform", "ScaleByScheduleState"),
    ReplayBufferState: ("gan_rl_3d_tpu.train.replay_buffer", "ReplayBuffer"),
}
# the optax state classes the JAX package's optimizers (adam, adamw,
# scale_by_adam, scale_by_learning_rate, chain) leave in a checkpoint
OPTAX_STAND_INS = {name: cls for cls, (module, name) in PICKLED_AS.items()
                   if module.startswith("optax")}


class _JaxLayoutPickler(pickle._Pickler):
    """The pure-Python pickler, writing each stand-in class under its JAX
    name (``PICKLED_AS``) without importing that module. The public C
    pickler imports a class's module to check its name, so this leans on
    CPython's private ``pickle._Pickler`` (``save``, ``write``,
    ``memoize``); tests/test_torch_port_resume.py::
    test_each_stand_in_unpickles_in_jax_as_its_class holds the output to
    the JAX package's reader."""

    def save_global(self, obj, name=None):
        alias = PICKLED_AS.get(obj) if isinstance(obj, type) else None
        if alias is None:
            return super().save_global(obj, name)
        module, qualname = alias
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class NumpyUnpickler(pickle.Unpickler):
    """Admits numpy arrays and scalars, and the optax states and replay
    ring above as stand-ins: checkpoints and engine files hold nothing
    else, and unpickling arbitrary classes runs arbitrary code. ``what``
    names the file in the error."""

    what = "checkpoint"
    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "scalar"),
                ("numpy.core.multiarray", "scalar")}

    def find_class(self, module, name):
        if module.split(".")[0] == "optax" and name in OPTAX_STAND_INS:
            return OPTAX_STAND_INS[name]
        if (module, name) == PICKLED_AS[ReplayBufferState]:
            return ReplayBufferState
        if (module, name) not in self._ALLOWED:
            raise ValueError(f"{self.what} file refers to {module}.{name}; "
                             f"{self.what} files hold numpy arrays only")
        return super().find_class(module, name)


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` (tensors, numpy arrays or numbers as leaves, the
    stand-ins as nodes) as a pickle of numpy arrays; floating tensors are
    written as float32. Under torch.distributed only rank 0 writes."""
    if not is_writer():
        return
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        _JaxLayoutPickler(f, PICKLE_PROTOCOL).dump(tree_map(to_numpy, tree))


# ---------------------------------------------------------------------------
# orbax directories
# ---------------------------------------------------------------------------

_DICT_KEY, _SEQUENCE_KEY = 2, 1  # orbax's key types in _METADATA
# the JAX package saves numpy leaves (gan_rl_3d_tpu/utils/checkpoint.py:
# _to_host); empty containers and None are metadata alone
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}


def _zarr_chunks(name: str, zarray: dict):
    """(dtype, shape, chunk shape, chunk keys) of a zarr v2 array, after
    checking that the port reads it."""
    if zarray.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {zarray.get('zarr_format')} "
                         "is not read; only zarr v2")
    compressor = zarray.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {compressor.get('id')!r} "
                         "is not read; only zstd")
    if zarray.get("filters"):
        raise ValueError(f"{name}: zarr filters {zarray['filters']} are not "
                         "read")
    try:
        dtype = np.dtype(zarray["dtype"])
    except TypeError:
        raise ValueError(f"{name}: zarr dtype {zarray['dtype']!r} is not "
                         "read") from None
    if dtype.kind not in "biuf":
        raise ValueError(f"{name}: zarr dtype {zarray['dtype']!r} is not "
                         "read")
    shape, chunks = tuple(zarray["shape"]), tuple(zarray["chunks"])
    sep = zarray.get("dimension_separator", ".")
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    keys = [sep.join(map(str, idx)) or "0" for idx in itertools.product(*grid)]
    return dtype, shape, chunks, keys


def _zarr_array(name: str, zarray: dict, chunks_data) -> np.ndarray:
    dtype, shape, chunks, keys = _zarr_chunks(name, zarray)
    fill = zarray.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill,
                  dtype.newbyteorder("="))
    order = zarray.get("order", "C")
    for key, data in zip(keys, chunks_data):
        if data is None:
            continue
        a = np.frombuffer(data, dtype)
        if a.size != math.prod(chunks):
            raise ValueError(f"{name}: chunk {key} holds {a.size} elements, "
                             f"not {math.prod(chunks)}")
        a = a.reshape(chunks, order=order)
        idx = [int(i) for i in key.split(zarray.get("dimension_separator",
                                                    "."))] if shape else []
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[dst] = a[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


class _Node(dict):
    """A tree node while the tree is built; ``sequence`` when its keys
    are sequence indices."""

    sequence = False


def _finish(node):
    if not isinstance(node, _Node):
        return node
    if node.sequence:
        if sorted(int(k) for k in node) != list(range(len(node))):
            raise ValueError("orbax metadata: sequence indices are not "
                             "0..n-1")
        return [_finish(node[k]) for k in sorted(node, key=int)]
    return {k: _finish(v) for k, v in node.items()}


def load_orbax_checkpoint(path: str) -> Dict[str, Any]:
    """The tree of an orbax checkpoint directory written with OCDBT and
    zarr v2 (the JAX package's default), as the JAX package restores it
    without a target."""
    p = Path(path)
    meta_path = p / "_METADATA"
    if not meta_path.exists():
        raise ValueError(f"{p} has no _METADATA: not an orbax checkpoint the "
                         "port reads")
    meta = json.loads(meta_path.read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{p} was written with use_zarr3: true; the port "
                         "reads zarr v2 arrays only")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{p} was written without OCDBT; the port reads "
                         "OCDBT checkpoints only")
    store = OcdbtStore(p)
    present = set(store.list_keys())
    entries, arrays, blobs, compressed = [], [], [], []
    for entry in meta["tree_metadata"].values():
        keys = []
        for k in entry["key_metadata"]:
            if k["key_type"] not in (_DICT_KEY, _SEQUENCE_KEY):
                raise ValueError(f"orbax metadata: key type {k['key_type']} "
                                 "is not read")
            keys.append((str(k["key"]), k["key_type"]))
        vtype = entry["value_metadata"]["value_type"]
        if vtype in _EMPTY:
            entries.append((keys, _EMPTY[vtype]()))
            continue
        if vtype != "np.ndarray":
            raise ValueError(f"orbax metadata: value type {vtype!r} is not "
                             "read")
        name = ".".join(k for k, _ in keys)
        zarray = json.loads(store.read(name + "/.zarray"))
        blob_ids = []
        for c in _zarr_chunks(name, zarray)[3]:
            key = f"{name}/{c}"
            blob_ids.append(len(blobs) if key in present else None)
            if key in present:
                blobs.append(store.read(key))
                compressed.append(zarray.get("compressor") is not None)
        arrays.append((len(entries), name, zarray, blob_ids))
        entries.append((keys, None))
    # every chunk of the checkpoint decodes in one batch
    decoded = iter(zstd.decompress_many(
        [b for b, c in zip(blobs, compressed) if c]))
    data = [next(decoded) if c else b for b, c in zip(blobs, compressed)]
    for i, name, zarray, blob_ids in arrays:
        entries[i] = (entries[i][0], _zarr_array(
            name, zarray, [None if b is None else data[b] for b in blob_ids]))
    root = _Node()
    for keys, value in entries:
        node = root
        for j, (k, ktype) in enumerate(keys):
            node.sequence = node.sequence or ktype == _SEQUENCE_KEY
            if j == len(keys) - 1:
                node[k] = value
            else:
                node = node.setdefault(k, _Node())
    return _finish(root)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint of either package as a tree of numpy arrays: a
    pickle file, or an orbax directory."""
    p = Path(path)
    if p.is_dir():
        return load_orbax_checkpoint(str(p))
    with open(p, "rb") as f:
        return NumpyUnpickler(f).load()


def remove_checkpoint(path: Path) -> None:
    """Remove a checkpoint, file or orbax directory, where there is one."""
    if path.is_dir():
        shutil.rmtree(path)
    elif path.exists():
        path.unlink()


def load_model_checkpoint(checkpoint_dir: str, name: str
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(model, meta) of the full-model checkpoint ``checkpoint_dir/name``,
    written by either package, pickle or orbax directory, as numpy trees.
    The serving GAN branch's ``<name>_ganpath`` sibling, when there is one,
    rides in as ``model["gan_path"]`` (gan_rl_3d_tpu/train/trainer.py:
    780-812)."""
    path = Path(checkpoint_dir) / name
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint {path}")
    tree = load_checkpoint(str(path))
    model = dict(tree["model"])
    gan_path = path.parent / (name + "_ganpath")
    if gan_path.exists():
        model["gan_path"] = load_checkpoint(str(gan_path))
    return model, tree["meta"]
