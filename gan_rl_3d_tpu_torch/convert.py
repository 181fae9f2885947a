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

The optimizer states: optax's ScaleByAdamState maps to torch's Adam
state leaf by leaf (count -> step, mu -> exp_avg, nu -> exp_avg_sq), the
parameters in ``tree_leaves`` order, which is optax's. A chain's
ScaleByScheduleState count is the port's LambdaLR step count. The
readers take a state as the pickle stand-ins of ``utils.checkpoint`` hold
it, or as an orbax directory restores it (lists and dicts);
``agent_to_numpy`` keeps ``opt`` as plain ``{"count", "mu", "nu"}`` per
network, and ``optax_layout`` turns a model tree into the optax states a
file carries (``adam_to_optax``, ``chain_to_optax``), which the JAX
package unpickles as optax's own classes.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models.inference import cast_engine
from gan_rl_3d_tpu_torch.train.replay_buffer import FIELDS, ReplayBuffer
from gan_rl_3d_tpu_torch.utils.checkpoint import (EmptyState,
                                                 ReplayBufferState,
                                                 ScaleByAdamState,
                                                 ScaleByScheduleState,
                                                 to_numpy)
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
    """{"count", "mu", "nu"} from the port's dict, from optax's state as
    the stand-ins read it (a ScaleByAdamState, alone or in a chain's
    tuple), or as orbax restores it (a dict, alone or in a list)."""
    if isinstance(state, dict) and "mu" in state:
        return state
    if hasattr(state, "mu") and hasattr(state, "nu"):  # optax's or a stand-in
        return {"count": state.count, "mu": state.mu, "nu": state.nu}
    if isinstance(state, (list, tuple)):
        for part in state:
            try:
                return _adam_moments(part)
            except ValueError:
                continue
    raise ValueError("no Adam moments in the optimizer state")


def _schedule_count(state) -> int:
    """The ScaleByScheduleState count of an optax chain's state."""
    for part in state:
        if isinstance(part, dict) and set(part) == {"count"}:
            return int(np.asarray(part["count"]))
        if getattr(part, "_fields", None) == ("count",):  # a named tuple
            return int(np.asarray(part.count))
    raise ValueError("no schedule count in the optimizer state")


def load_adam(opt: torch.optim.Optimizer, params, state) -> int:
    """Load an optax Adam state (``_adam_moments`` reads any layout) into
    ``opt``, a torch Adam over ``tree_leaves(params)``; the count."""
    m = _adam_moments(state)
    count = int(np.asarray(m["count"]))
    leaves = tree_leaves(params)
    mus, nus = tree_leaves(m["mu"]), tree_leaves(m["nu"])
    if not len(leaves) == len(mus) == len(nus):
        raise ValueError(f"optimizer state has {len(mus)} moments for "
                         f"{len(leaves)} parameters")
    opt.state.clear()
    if count == 0:
        return 0
    for p, mu, nu in zip(leaves, mus, nus):
        if tuple(np.shape(mu)) != tuple(p.shape):
            raise ValueError(f"Adam moment of shape {np.shape(mu)} for a "
                             f"parameter of shape {tuple(p.shape)}")
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": _leaf(mu, p.device),
                        "exp_avg_sq": _leaf(nu, p.device)}
    return count


def load_chain(opt: torch.optim.Optimizer, params, state,
               scheduler: "torch.optim.lr_scheduler.LambdaLR | None" = None
               ) -> int:
    """Load an optax chain state (add_decayed_weights, scale_by_adam,
    scale_by_learning_rate(schedule); gan_rl_3d_tpu/train/steps.py:80-84,
    688-692) into ``opt`` and, when given, set ``scheduler`` to the
    chain's schedule count; the Adam count."""
    count = load_adam(opt, params, state)
    if scheduler is not None:
        n = _schedule_count(state)
        scheduler.last_epoch = n
        for group, base, fn in zip(opt.param_groups, scheduler.base_lrs,
                                   scheduler.lr_lambdas):
            group["lr"] = base * fn(n)
        scheduler._last_lr = [g["lr"] for g in opt.param_groups]
    return count


def adam_to_optax(opt: torch.optim.Optimizer, params) -> tuple:
    """A torch Adam's state as optax.adam's, (ScaleByAdamState,
    EmptyState) as stand-ins."""
    m = _adam_to_numpy(opt, params)
    return ScaleByAdamState(m["count"], m["mu"], m["nu"]), EmptyState()


def chain_to_optax(opt: torch.optim.Optimizer, params,
                   scheduler: "torch.optim.lr_scheduler.LambdaLR | None" = None
                   ) -> tuple:
    """The state of optax.chain(add_decayed_weights, scale_by_adam,
    scale_by_learning_rate(schedule)): the schedule's count is
    ``scheduler``'s, or the Adam count where the lr is constant."""
    adam, _ = adam_to_optax(opt, params)
    count = adam.count if scheduler is None else np.int32(
        scheduler.last_epoch)
    return EmptyState(), adam, ScaleByScheduleState(count)


def optax_layout(model_np: dict) -> dict:
    """A numpy model tree with the agent's ``opt`` as optax.adam's state
    per network, (ScaleByAdamState, EmptyState), as the JAX package's
    agent carries it (gan_rl_3d_tpu/models/rl_agent.py)."""
    agent = model_np.get("agent", {})
    if "opt" not in agent:
        return model_np
    opt = {name: (ScaleByAdamState(m["count"], m["mu"], m["nu"]),
                  EmptyState()) for name, m in agent["opt"].items()}
    return {**model_np, "agent": {**agent, "opt": opt}}


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
        load_adam(agent["opt"][name], agent[name]["params"],
                  tree["opt"][name])
    agent["step"] = int(np.asarray(tree["step"]))
    return agent


def buffer_to_numpy(buffer: ReplayBuffer) -> ReplayBufferState:
    """The replay ring in the JAX package's layout (its ReplayBuffer, as
    the stand-in): the tensors, ``ptr`` and ``size`` as int32."""
    return ReplayBufferState(
        *(to_numpy(getattr(buffer, name)) for name in FIELDS),
        ptr=np.int32(buffer.ptr), size=np.int32(buffer.size))


def buffer_from_numpy(state, buffer: ReplayBuffer) -> ReplayBuffer:
    """Fill ``buffer`` (of the same capacity and widths) from the JAX
    layout: the stand-in, or the dict an orbax directory restores."""
    get = state.get if isinstance(state, dict) else (
        lambda k: getattr(state, k))
    for name in FIELDS:
        value = np.asarray(get(name), np.float32)
        dst = getattr(buffer, name)
        if value.shape != tuple(dst.shape):
            raise ValueError(f"replay buffer {name} of shape {value.shape}, "
                             f"expected {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(value))
    buffer.ptr = int(np.asarray(get("ptr")))
    buffer.size = int(np.asarray(get("size")))
    return buffer


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
