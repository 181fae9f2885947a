"""Weight bridge between the JAX package's trees and the port.

``model_from_numpy`` takes the JAX model tree with numpy leaves (for
example ``jax.tree.map(np.asarray, net.init_model(key, config))``) and
returns the port's model: the same nested dictionaries with tensors, kept
to what serving reads (``ae``, ``lgan``, ``agent.actor`` and an optional
``gan_path``). ``agent_from_numpy`` builds the whole TD3 agent from such a
tree: networks, targets, the TD3 step and the Adam moments, which either
package's file carries under ``agent.opt``. ``engine_from_numpy`` does
the same for a folded engine tree, int8 or not; ``model_to_numpy`` and
``agent_to_numpy`` map the port's trees back to numpy.

The Adam moments: a JAX file holds per network the optax state (a
ScaleByAdamState and an EmptyState, read as the stand-ins of
``utils.checkpoint``); the port writes ``{"count", "mu", "nu"}`` as plain
numpy, so neither package needs optax to read the other's file. They map
to torch's Adam state leaf by leaf: count -> step, mu -> exp_avg, nu ->
exp_avg_sq.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models.inference import cast_engine
from gan_rl_3d_tpu_torch.utils.checkpoint import to_numpy
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

_ENGINE_KEYS = ("encoder", "decoder", "generator", "actor", "discriminator")


def _leaf(x, device: torch.device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == np.uint16:  # bf16 words (models.inference._EngineUnpickler)
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    if x.dtype.kind in "iub":
        return torch.from_numpy(np.array(x)).to(device)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def tree_from_numpy(tree, device: torch.device):
    """Numpy (or array-like) leaves -> tensors on ``device``: floating
    leaves as f32, integer and boolean leaves keep their type (the int8
    weights of an int8 engine), uint16 leaves (the raw words of a JAX bf16
    engine's arrays) are viewed as bfloat16; dicts, lists, tuples and None
    keep their structure."""
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
    JAX package's layout; a full agent as ``agent_to_numpy`` writes it."""
    return {k: agent_to_numpy(v) if k == "agent" else tree_map(to_numpy, v)
            for k, v in model.items()}


def _adam_to_numpy(opt, params: dict) -> dict:
    leaves = tree_leaves(params)
    states = [opt.state.get(p, {}) for p in leaves]
    count = int(states[0]["step"]) if states[0] else 0

    def moment(key):
        return tree_unflatten(params, [
            to_numpy(s[key]) if s else np.zeros(tuple(p.shape), np.float32)
            for p, s in zip(leaves, states)])

    return {"count": np.int32(count), "mu": moment("exp_avg"),
            "nu": moment("exp_avg_sq")}


def agent_to_numpy(agent: dict) -> dict:
    """The agent as numpy in the JAX layout: each network's ``params`` and
    ``state``, ``opt`` as ``{"count", "mu", "nu"}`` per online network
    and ``step`` as int32. A serving agent (the actor alone) passes
    through as it is."""
    out = {k: tree_map(to_numpy, v) for k, v in agent.items()
           if k not in ("opt", "step")}
    if "opt" in agent:
        out["opt"] = {name: _adam_to_numpy(opt, agent[name]["params"])
                      for name, opt in agent["opt"].items()}
        out["step"] = np.int32(agent["step"])
    return out


def _adam_moments(state) -> dict:
    """{"count", "mu", "nu"} from the port's dict or from optax's state as
    the stand-ins read it (a tuple holding a ScaleByAdamState)."""
    if isinstance(state, dict):
        return state
    for part in state:
        if hasattr(part, "mu"):
            return {"count": part.count, "mu": part.mu, "nu": part.nu}
    raise ValueError("no Adam moments in the optimizer state")


def agent_from_numpy(tree: dict, cfg: rl.TD3Config, *,
                     device: str | torch.device = "cuda") -> dict:
    """The whole TD3 agent from a JAX-layout tree with numpy leaves (either
    package's checkpoint): networks, targets, the step and the Adam
    moments of each online network."""
    dev = resolve_device(device)
    agent = rl.agent_from_networks(
        {name: tree_from_numpy(tree[name], dev) for name in rl.NETWORKS},
        cfg, dev)
    for name in rl.NETWORKS:
        agent[name + "_target"] = tree_from_numpy(tree[name + "_target"], dev)
        m = _adam_moments(tree["opt"][name])
        count = int(np.asarray(m["count"]))
        if count == 0:
            continue
        opt = agent["opt"][name]
        for p, mu, nu in zip(tree_leaves(agent[name]["params"]),
                             tree_leaves(m["mu"]), tree_leaves(m["nu"])):
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": _leaf(mu, dev),
                            "exp_avg_sq": _leaf(nu, dev)}
    agent["step"] = int(np.asarray(tree["step"]))
    return agent


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
