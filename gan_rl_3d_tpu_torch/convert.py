"""Weight bridge between the JAX package's trees and the port.

``model_from_numpy`` takes the JAX model tree with numpy leaves (for
example ``jax.tree.map(np.asarray, net.init_model(key, config))``) and
returns the port's model: the same nested dictionaries with tensors, kept
to what serving reads (``ae``, ``lgan``, ``agent.actor`` and an optional
``gan_path``). Critics, target networks and optimizer state are dropped.
``engine_from_numpy`` does the same for a folded engine tree, int8 or not;
``model_to_numpy`` maps the port's tree back to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch.models.inference import cast_engine
from gan_rl_3d_tpu_torch.utils.checkpoint import to_numpy
from gan_rl_3d_tpu_torch.utils.tree import tree_map

_ENGINE_KEYS = ("encoder", "decoder", "generator", "actor", "discriminator")


def _leaf(x, device: torch.device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.kind in "iub":
        return torch.from_numpy(np.array(x)).to(device)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def tree_from_numpy(tree, device: torch.device):
    """Numpy (or array-like) leaves -> tensors on ``device``: floating
    leaves as f32, integer and boolean leaves keep their type (the int8
    weights of an int8 engine); dicts, lists, tuples and None keep their
    structure."""
    return tree_map(lambda x: _leaf(x, device), tree)


def model_from_numpy(tree: dict, *, device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    model = {
        "ae": tree_from_numpy(tree["ae"], dev),
        "lgan": tree_from_numpy(tree["lgan"], dev),
        "agent": {"actor": tree_from_numpy(tree["agent"]["actor"], dev)},
    }
    if tree.get("gan_path") is not None:
        model["gan_path"] = tree_from_numpy(tree["gan_path"], dev)
    return model


def model_to_numpy(model: dict) -> dict:
    """The inverse of ``model_from_numpy``: the port's tree (any subset of
    ``ae``, ``lgan``, ``agent``, ``gan_path``) as f32 numpy arrays in the
    JAX package's layout."""
    return tree_map(to_numpy, model)


def engine_from_numpy(tree: dict, *, device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32) -> dict:
    """A JAX-layout engine tree -> the port's engine on ``device``, cast to
    ``dtype`` as prepare_inference_engine casts (``encoder_q`` stays as
    it is)."""
    dev = resolve_device(device)
    missing = [k for k in _ENGINE_KEYS if k not in tree]
    if missing:
        raise ValueError(f"not an inference engine: missing {missing}")
    return cast_engine(tree_from_numpy(tree, dev), dtype)
