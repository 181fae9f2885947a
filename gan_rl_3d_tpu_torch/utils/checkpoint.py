"""Checkpoints as pickles of numpy trees, the file format of
gan_rl_3d_tpu/utils/checkpoint.py:33-60 without orbax: either package
reads the other's file (``load_checkpoint(path, use_orbax=False)`` on the
JAX side). Reading orbax directories is a later item (ROADMAP queue 1,
item 1).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict

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


class NumpyUnpickler(pickle.Unpickler):
    """Admits numpy arrays and scalars only: checkpoints and engine files
    hold nothing else, and unpickling arbitrary classes runs arbitrary
    code. ``what`` names the file in the error."""

    what = "checkpoint"
    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "scalar"),
                ("numpy.core.multiarray", "scalar")}

    def find_class(self, module, name):
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
