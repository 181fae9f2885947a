"""Checkpoints as pickles of numpy trees, the file format of
gan_rl_3d_tpu/utils/checkpoint.py:33-60 without orbax: either package
reads the other's file (``load_checkpoint(path, use_orbax=False)`` on the
JAX side). A full-model pickle of the JAX package holds the agent's optax
states under ``agent.opt``; they unpickle into inert stand-ins (named
tuples of numpy arrays), so reading one needs no optax. Reading orbax
directories is a later item (ROADMAP queue 1, item 1).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from gan_rl_3d_tpu_torch.utils.tree import tree_map


def to_numpy(x) -> np.ndarray:
    """A tensor (floating ones as float32) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32 if x.is_floating_point()
                             else x.dtype).numpy()
    return np.asarray(x)


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` (tensors, numpy arrays or numbers as leaves) as a
    pickle of numpy arrays; floating tensors are written as float32."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        pickle.dump(tree_map(to_numpy, tree), f)


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


# the optax state classes the JAX package's optimizers (adam, adamw,
# scale_by_adam, scale_by_learning_rate, chain) leave in a checkpoint
OPTAX_STAND_INS = {cls.__name__: cls for cls in
                   (EmptyState, ScaleByAdamState, ScaleByScheduleState)}


class NumpyUnpickler(pickle.Unpickler):
    """Admits numpy arrays and scalars, and the optax states above as
    stand-ins: checkpoints and engine files hold nothing else, and
    unpickling arbitrary classes runs arbitrary code. ``what`` names the
    file in the error."""

    what = "checkpoint"
    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "scalar"),
                ("numpy.core.multiarray", "scalar")}

    def find_class(self, module, name):
        if module.split(".")[0] == "optax" and name in OPTAX_STAND_INS:
            return OPTAX_STAND_INS[name]
        if (module, name) not in self._ALLOWED:
            raise ValueError(f"{self.what} file refers to {module}.{name}; "
                             f"{self.what} files hold numpy arrays only")
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a pickle checkpoint as a tree of numpy arrays."""
    p = Path(path)
    if p.is_dir():
        raise ValueError(f"{p} is an orbax checkpoint directory; the port "
                         "reads pickle checkpoints only (ROADMAP queue 1, "
                         "item 1)")
    with open(p, "rb") as f:
        return NumpyUnpickler(f).load()


def load_model_checkpoint(checkpoint_dir: str, name: str
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(model, meta) of the full-model checkpoint ``checkpoint_dir/name``,
    written by either package, as numpy trees. The serving GAN branch's
    ``<name>_ganpath`` sibling, when there is one, rides in as
    ``model["gan_path"]`` (gan_rl_3d_tpu/train/trainer.py:780-812)."""
    path = Path(checkpoint_dir) / name
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint {path}")
    tree = load_checkpoint(str(path))
    model = dict(tree["model"])
    gan_path = path.parent / (name + "_ganpath")
    if gan_path.exists():
        model["gan_path"] = load_checkpoint(str(gan_path))
    return model, tree["meta"]
