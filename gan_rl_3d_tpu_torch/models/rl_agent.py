"""TD3 agent, inference half (gan_rl_3d_tpu/models/rl_agent.py).

The actor 128 -> [400, 400, 300, 300] (+BN+ReLU) -> action_dim + tanh,
scaled by ``action_bound``; action selection runs it in eval mode with
opt-in Ornstein-Uhlenbeck exploration noise. The critics and the TD3
update come with the RL-phase slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gan_rl_3d_tpu_torch.models.common import bn_mlp_apply

Tensor = torch.Tensor


class TD3Config(NamedTuple):
    """The TD3 fields inference reads, with the JAX defaults
    (rl_agent.py:39-76). The actor's widths come from its weights."""

    exploration_noise: float = 0.1
    action_bound: float = 1.0
    ou_mu: float = 0.0
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    ou_dt: float = 1e-2


def actor_apply(params: dict, state: dict, s: Tensor, *,
                cfg: TD3Config) -> Tensor:
    a, _ = bn_mlp_apply(params["mlp"], state["mlp"], s,
                        final_activation=torch.tanh)
    return a * cfg.action_bound


def ou_step(ou_state: Tensor, cfg: TD3Config, normal: Tensor) -> Tensor:
    """One OU step given the standard-normal draw ``normal`` (same shape as
    ``ou_state``) (rl_agent.py:167-172)."""
    dx = (cfg.ou_theta * (cfg.ou_mu - ou_state) * cfg.ou_dt
          + cfg.ou_sigma * cfg.ou_dt ** 0.5 * normal)
    return ou_state + dx


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
    a = actor_apply(actor["params"], actor["state"], s, cfg=cfg)
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
