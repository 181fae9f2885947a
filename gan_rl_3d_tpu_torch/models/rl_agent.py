"""TD3 agent (gan_rl_3d_tpu/models/rl_agent.py).

The actor 128 -> [400, 400, 300, 300] (+BN+ReLU) -> action_dim + tanh,
scaled by ``action_bound``; the critic's state branch 128 -> 400
(+BN+ReLU) and action branch action_dim -> 32 (ReLU), concatenated, then
-> 300 -> 300 (+BN+ReLU) -> 1. Weights are xavier-uniform, biases 0.01.
Action selection runs the actor in eval mode with opt-in
Ornstein-Uhlenbeck exploration noise.

The agent is a dictionary in the JAX tree's layout: ``actor``,
``critic1``, ``critic2`` and their targets each hold ``params`` and
``state``; ``opt`` holds one ``torch.optim.Adam`` per online network
(optax.adam's defaults) and ``step`` the number of TD3 updates, a Python
int. ``agent_update`` runs one TD3 update in place, with the JAX
function's state handling: the targets run in training mode (their BN
running statistics advance), soft updates blend parameters only, critic
1 keeps the state of the actor loss's call, and the actor updates only
every ``policy_delay`` steps after ``actor_warmup``, its lr ramped by
``_actor_ramp_factor``. The target-policy noise is an argument, so a test
can feed the numbers JAX drew.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.models.common import (bn_mlp_apply, bn_mlp_init,
                                              grad_step)
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map

Tensor = torch.Tensor
NETWORKS = ("actor", "critic1", "critic2")


class TD3Config(NamedTuple):
    """Every field of the JAX config, with its defaults (rl_agent.py:39-76).
    ``actor_warmup`` skips the actor's updates for the first N TD3
    updates; ``actor_lr_ramp`` then ramps its lr over that many applied
    policy updates (0: constant)."""

    state_dim: int = 128
    action_dim: int = 1
    actor_hidden: Tuple[int, ...] = (400, 400, 300, 300)
    critic_hidden: Tuple[int, ...] = (400, 432, 300, 300)
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 64
    exploration_noise: float = 0.1
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    policy_delay: int = 2
    actor_warmup: int = 0
    actor_lr_ramp: int = 0
    action_bound: float = 1.0
    ou_mu: float = 0.0
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    ou_dt: float = 1e-2


# ---------------------------------------------------------------------------
# Actor and critic
# ---------------------------------------------------------------------------


def actor_init(generator: torch.Generator, state_dim: int = 128,
               action_dim: int = 1,
               hidden_dims: Sequence[int] = (400, 400, 300, 300)
               ) -> Tuple[dict, dict]:
    """(rl_agent.py:84-88)"""
    p, s = bn_mlp_init(generator, state_dim, list(hidden_dims) + [action_dim],
                       w_init=nn.xavier_uniform, bias_const=0.01,
                       final_plain=True)
    return {"mlp": p}, {"mlp": s}


def actor_apply(params: dict, state: dict, s: Tensor, *, cfg: TD3Config,
                training: bool = False) -> Tuple[Tensor, dict]:
    """(action, new BN state); training BN uses the centered statistics,
    as the JAX package's phases 3-4 do."""
    a, mlp_s = bn_mlp_apply(params["mlp"], state["mlp"], s,
                            training=training, final_activation=torch.tanh)
    return a * cfg.action_bound, {"mlp": mlp_s}


def _critic_widths(hidden: Sequence[int]) -> Tuple[int, int, int]:
    """(state, combined1, combined2) widths from critic_hidden: a 4-tuple's
    slot 1 only documents the 400 + 32 concat width and is ignored
    (rl_agent.py:107-120)."""
    if len(hidden) == 4:
        return hidden[0], hidden[2], hidden[3]
    if len(hidden) == 3:
        return hidden[0], hidden[1], hidden[2]
    raise ValueError(f"critic_hidden must have 3 or 4 entries, got {hidden}")


def critic_init(generator: torch.Generator, cfg: TD3Config
                ) -> Tuple[dict, dict]:
    """(rl_agent.py:123-140); the dense layers draw in the order state_fc,
    action_fc, comb_fc1, comb_fc2, out_fc."""
    h_state, h_comb1, h_comb2 = _critic_widths(cfg.critic_hidden)
    init = dict(w_init=nn.xavier_uniform, bias_const=0.01)
    params = {
        "state_fc": nn.dense_init(generator, cfg.state_dim, h_state, **init),
        "action_fc": nn.dense_init(generator, cfg.action_dim, 32, **init),
        "comb_fc1": nn.dense_init(generator, h_state + 32, h_comb1, **init),
        "comb_fc2": nn.dense_init(generator, h_comb1, h_comb2, **init),
        "out_fc": nn.dense_init(generator, h_comb2, 1, **init),
    }
    state = {}
    for name, dim in (("bn1", h_state), ("bn2", h_comb1), ("bn3", h_comb2)):
        params[name], state[name] = nn.batchnorm_init(dim)
    return params, state


def critic_apply(params: dict, state: dict, s: Tensor, a: Tensor, *,
                 training: bool = False) -> Tuple[Tensor, dict]:
    """Q(s, a) (B, 1) and the new BN state (rl_agent.py:143-160)."""
    new_state = {}

    def bn(name, x):
        if training:
            x, new_state[name] = nn.batchnorm_train(params[name], state[name],
                                                    x)
        else:
            x, new_state[name] = (nn.batchnorm_eval(params[name], state[name],
                                                    x), state[name])
        return torch.relu(x)

    x = bn("bn1", nn.dense(params["state_fc"], s))
    av = torch.relu(nn.dense(params["action_fc"], a))
    x = bn("bn2", nn.dense(params["comb_fc1"], torch.cat([x, av], dim=-1)))
    x = bn("bn3", nn.dense(params["comb_fc2"], x))
    return nn.dense(params["out_fc"], x), new_state


# ---------------------------------------------------------------------------
# Ornstein-Uhlenbeck exploration noise
# ---------------------------------------------------------------------------


def ou_init(cfg: TD3Config, batch_shape: Tuple[int, ...] = (),
            device: "str | torch.device" = "cpu") -> Tensor:
    return torch.full(tuple(batch_shape) + (cfg.action_dim,), cfg.ou_mu,
                      dtype=torch.float32, device=device)


def ou_step(ou_state: Tensor, cfg: TD3Config, normal: Tensor) -> Tensor:
    """One OU step given the standard-normal draw ``normal`` (same shape as
    ``ou_state``) (rl_agent.py:167-172)."""
    dx = (cfg.ou_theta * (cfg.ou_mu - ou_state) * cfg.ou_dt
          + cfg.ou_sigma * cfg.ou_dt ** 0.5 * normal)
    return ou_state + dx


# ---------------------------------------------------------------------------
# Agent bundle
# ---------------------------------------------------------------------------


def _trainable(tree, device) -> dict:
    return tree_map(lambda v: v.detach().to(device).clone()
                    .requires_grad_(True), tree)


def _copy(tree) -> dict:
    return tree_map(lambda v: v.detach().clone(), tree)


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 (rl_agent.py:179-181)."""
    return torch.optim.Adam(tree_leaves(params), lr=lr)


def _optims(agent: dict, cfg: TD3Config) -> dict:
    return {name: make_optimizer(agent[name]["params"],
                                 cfg.actor_lr if name == "actor"
                                 else cfg.critic_lr)
            for name in NETWORKS}


def _actor_ramp_factor(step: int, cfg: TD3Config) -> float:
    """Warmup-then-ramp multiplier of the actor's update, from the TD3
    step counter (rl_agent.py:184-199): about the number of policy updates
    fired since the warmup gate opened over ``actor_lr_ramp``, clipped to
    [1 / actor_lr_ramp, 1]. Scaling Adam's update is scaling its lr."""
    if cfg.actor_lr_ramp <= 0:
        return 1.0
    applied = max(float(step) - cfg.actor_warmup, 0.0) / max(
        cfg.policy_delay, 1)
    return min(max(applied / float(cfg.actor_lr_ramp),
                   1.0 / float(cfg.actor_lr_ramp)), 1.0)


def agent_from_networks(nets: dict, cfg: TD3Config,
                        device: "str | torch.device" = "cpu") -> dict:
    """The agent from ``{"actor", "critic1", "critic2"}`` (each ``params``
    and ``state`` tensors): online parameters on ``device`` taking a
    gradient, targets as copies (torch copy.deepcopy, rl_agent.py:227-229),
    fresh Adam optimizers and step 0."""
    agent = {name: {"params": _trainable(nets[name]["params"], device),
                    "state": tree_map(lambda v: v.detach().to(device)
                                      .clone(), nets[name]["state"])}
             for name in NETWORKS}
    for name in NETWORKS:
        agent[name + "_target"] = {"params": _copy(agent[name]["params"]),
                                   "state": _copy(agent[name]["state"])}
    agent["opt"] = _optims(agent, cfg)
    agent["step"] = 0
    return agent


def agent_init(generator: torch.Generator, cfg: TD3Config,
               device: "str | torch.device" = "cpu") -> dict:
    """(rl_agent.py:202-222): the actor, then critic 1, then critic 2 draw
    from ``generator`` (on the CPU, so a seed gives the same agent on
    every device)."""
    nets = {"actor": dict(zip(("params", "state"), actor_init(
        generator, cfg.state_dim, cfg.action_dim, cfg.actor_hidden)))}
    for name in ("critic1", "critic2"):
        nets[name] = dict(zip(("params", "state"),
                              critic_init(generator, cfg)))
    return agent_from_networks(nets, cfg, device)


def select_action(agent: dict, s: Tensor, cfg: TD3Config, *,
                  ou_state: Optional[Tensor] = None,
                  add_noise: bool = False,
                  normal: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  ) -> Tuple[Tensor, Optional[Tensor]]:
    """Batched action selection, actor in eval mode (rl_agent.py:225-252).

    With ``add_noise`` each row advances its own OU chain (``ou_state``
    (B, action_dim)) by the draw ``normal``, or by one drawn from
    ``generator``, and actions are clipped to [-1, 1]."""
    single = s.ndim == 1
    if single:
        s = s[None]
    actor = agent["actor"]
    with torch.no_grad():
        a, _ = actor_apply(actor["params"], actor["state"], s, cfg=cfg)
    new_ou = ou_state
    if add_noise:
        if ou_state is None:
            raise ValueError("add_noise=True needs an ou_state")
        if normal is None:
            normal = torch.randn(ou_state.shape, generator=generator,
                                 dtype=ou_state.dtype,
                                 device=ou_state.device)
        new_ou = ou_step(ou_state, cfg, normal)
        a = torch.clamp(a + cfg.exploration_noise * new_ou, -1.0, 1.0)
    if single:
        a = a[0]
    return a, new_ou


class TransitionBatch(NamedTuple):
    states: Tensor       # (B, state_dim)
    actions: Tensor      # (B, action_dim)
    rewards: Tensor      # (B, 1)
    next_states: Tensor  # (B, state_dim)
    dones: Tensor        # (B, 1) float 0/1


def _soft_update(target: dict, online: dict, tau: float) -> None:
    """target <- tau * online + (1 - tau) * target, parameters only."""
    with torch.no_grad():
        t_leaves = tree_leaves(target)
        torch._foreach_mul_(t_leaves, 1.0 - tau)
        torch._foreach_add_(t_leaves, tree_leaves(online), alpha=tau)


def agent_update(agent: dict, batch: TransitionBatch, noise: Tensor,
                 cfg: TD3Config) -> Tuple[dict, dict]:
    """One TD3 update in place (rl_agent.py:263-379); ``noise`` is the
    standard-normal draw (B, action_dim) of the target-policy smoothing.
    Returns (agent, {"critic_loss", "actor_loss"}), the losses as 0-d
    tensors (the actor's 0 when it did not update)."""
    opt = agent["opt"]
    step = agent["step"] + 1
    at, c1t, c2t = (agent["actor_target"], agent["critic1_target"],
                    agent["critic2_target"])
    with torch.no_grad():
        next_a, at_state = actor_apply(at["params"], at["state"],
                                       batch.next_states, cfg=cfg,
                                       training=True)
        noise = torch.clamp(cfg.policy_noise * noise, -cfg.noise_clip,
                            cfg.noise_clip)
        next_a = torch.clamp(next_a + noise, -1.0, 1.0)
        q1t, c1t_state = critic_apply(c1t["params"], c1t["state"],
                                      batch.next_states, next_a,
                                      training=True)
        q2t, c2t_state = critic_apply(c2t["params"], c2t["state"],
                                      batch.next_states, next_a,
                                      training=True)
        target_q = (batch.rewards + (1.0 - batch.dones) * cfg.gamma
                    * torch.minimum(q1t, q2t))

    losses = []
    for name in ("critic1", "critic2"):
        net = agent[name]
        q, new_state = critic_apply(net["params"], net["state"],
                                    batch.states, batch.actions,
                                    training=True)
        loss = (q - target_q).square().mean()
        grad_step(opt[name], loss, net["params"])
        net["state"] = new_state
        losses.append(loss.detach())
    critic_loss = (losses[0] + losses[1]) / 2.0

    # the targets keep their training-mode forwards' running statistics
    at["state"], c1t["state"], c2t["state"] = at_state, c1t_state, c2t_state
    actor_loss = torch.zeros((), device=critic_loss.device)
    if step % cfg.policy_delay == 0 and step > cfg.actor_warmup:
        actor, c1 = agent["actor"], agent["critic1"]
        act, a_state = actor_apply(actor["params"], actor["state"],
                                   batch.states, cfg=cfg, training=True)
        q, c1["state"] = critic_apply(c1["params"], c1["state"],
                                      batch.states, act, training=True)
        loss = -q.mean()
        for group in opt["actor"].param_groups:
            group["lr"] = cfg.actor_lr * _actor_ramp_factor(step, cfg)
        grad_step(opt["actor"], loss, actor["params"])
        actor["state"] = a_state
        actor_loss = loss.detach()
        for name in NETWORKS:
            _soft_update(agent[name + "_target"]["params"],
                         agent[name]["params"], cfg.tau)
    agent["step"] = step
    return agent, {"critic_loss": critic_loss, "actor_loss": actor_loss}
