"""RL-GAN-Net composite (gan_rl_3d_tpu/models/rl_gan_net.py).

``complete`` is the plain reference the folded engine
(models/inference.py::complete_fast) is held against: encoder -> actor z ->
generator -> decoder, the plain AE reconstruction, and the hybrid gate.
``env_reset`` / ``env_step`` are the batched RL environment of phase 4:
encode, then z -> G -> decode -> reward, whose Chamfer distance is K3 on
the card.

The model is a dictionary in the JAX tree's layout: ``ae`` and ``lgan``
each hold ``params`` and ``state``; ``agent`` is the TD3 agent
(``models.rl_agent``), or only its ``actor`` when
``convert.model_from_numpy`` builds the serving model; an optional
``gan_path`` snapshot holds the serving GAN branch's generator and decoder.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gan_rl_3d_tpu_torch.config import GATE_MODES
from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.models import latent_gan as lg
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.ops import losses as losses_ops
from gan_rl_3d_tpu_torch.utils.tree import tree_map

Tensor = torch.Tensor

PHASES = ("autoencoder", "lgan", "rl_agent", "joint")


def init_model(generator: torch.Generator, config,
               device: "str | torch.device" = "cpu") -> dict:
    """The full model with fresh weights (rl_gan_net.py:38-58): ``ae``,
    ``lgan``, the actor, then the two critics drawn from ``generator`` in
    that order (a seed gives the ``ae``, ``lgan`` and actor it gave before
    the critics were ported), on ``device``. The agent's targets start as
    copies and its optimizers fresh. ``config`` is a ``config.Config``."""
    a, g = config.model.autoencoder, config.model.lgan
    cfg = config.td3_config()
    ae_p, ae_s = ae.autoencoder_init(
        generator, a.input_dim, a.latent_dim, a.num_points, a.encoder_dims,
        a.decoder_dims, a.encoder_type, a.decoder_type)
    lg_p, lg_s = lg.lgan_init(generator, g.z_dim, g.latent_dim,
                              g.generator_dims, g.discriminator_dims,
                              spectral_norm=g.spectral_norm)
    move = lambda tree: tree_map(lambda v: v.to(device), tree)  # noqa: E731
    return {"ae": move({"params": ae_p, "state": ae_s}),
            "lgan": move({"params": lg_p, "state": lg_s}),
            "agent": rl.agent_init(generator, cfg, device)}


def encode(model: dict, pc: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Eval-mode GFV of either encoder (rl_gan_net.py:66-70)."""
    return ae.any_encoder_apply(model["ae"]["params"]["encoder"],
                                model["ae"]["state"]["encoder"], pc, mask)[0]


def decode(model: dict, gfv: Tensor) -> Tensor:
    """Eval-mode cloud of either decoder (rl_gan_net.py:73-77)."""
    return ae.any_decoder_apply(model["ae"]["params"]["decoder"],
                                model["ae"]["state"]["decoder"], gfv)[0]


def generate(model: dict, z: Tensor) -> Tensor:
    return lg.generator_apply(model["lgan"]["params"]["generator"],
                              model["lgan"]["state"]["generator"], z)[0]


def gan_generate(model: dict, z: Tensor) -> Tensor:
    """Generator of the serving GAN branch: the ``gan_path`` snapshot when
    present, else the live generator (rl_gan_net.py:99-108)."""
    snap = model.get("gan_path")
    if snap is not None:
        return lg.generator_apply(snap["generator"]["params"],
                                  snap["generator"]["state"], z)[0]
    return generate(model, z)


def gan_decode(model: dict, gfv: Tensor) -> Tensor:
    """Decoder of the serving GAN branch (rl_gan_net.py:111-120)."""
    snap = model.get("gan_path")
    if snap is not None:
        return ae.any_decoder_apply(snap["decoder"]["params"],
                                    snap["decoder"]["state"], gfv)[0]
    return decode(model, gfv)


def discriminate(model: dict, gfv: Tensor) -> Tensor:
    return lg.discriminator_apply(model["lgan"]["params"]["discriminator"],
                                  model["lgan"]["state"]["discriminator"],
                                  gfv)[0]


def select_z(model: dict, noisy_gfv: Tensor, cfg: rl.TD3Config, *,
             ou_state: Optional[Tensor] = None, add_noise: bool = False,
             normal: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Tensor:
    z, _ = rl.select_action(model["agent"], noisy_gfv, cfg,
                            ou_state=ou_state, add_noise=add_noise,
                            normal=normal, generator=generator)
    return z


def gate(completed: Tensor, ae_recon: Tensor, gate_mode: str,
         scores=None, gate_bias: float = 0.0) -> Dict[str, Tensor]:
    """The hybrid output for ``gate_mode`` (rl_gan_net.py:201-217).
    ``scores`` is a callable returning (rl_score, ae_score), evaluated only
    for the discriminator gate."""
    if gate_mode == "rl":
        return {"hybrid_output": completed}
    if gate_mode == "ae":
        return {"hybrid_output": ae_recon}
    if gate_mode == "union":
        return {"hybrid_output": torch.cat([completed, ae_recon], dim=1)}
    rl_score, ae_score = scores()
    better = (rl_score > ae_score + gate_bias).to(completed.dtype)[..., None]
    return {"hybrid_output": better * completed + (1.0 - better) * ae_recon,
            "rl_gan_score": rl_score, "ae_score": ae_score}


def check_gate_mode(gate_mode: str) -> None:
    if gate_mode not in GATE_MODES:
        raise ValueError(f"invalid gate_mode {gate_mode!r}")


@torch.no_grad()
def complete(model: dict, pc: Tensor, mask: Optional[Tensor] = None, *,
             cfg: rl.TD3Config = rl.TD3Config(),
             ou_state: Optional[Tensor] = None,
             add_noise: bool = False,
             normal: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None,
             hybrid: bool = True,
             gate_mode: str = "discriminator",
             gate_bias: float = 0.0) -> Dict[str, Tensor]:
    """Incomplete cloud (B, N, 3) -> completed cloud + all intermediates
    (rl_gan_net.py:148-218). ``gate_mode`` is "discriminator" (GAN path when
    D(clean) > D(noisy) + ``gate_bias``), "rl", "ae" or "union" (both
    paths' points, (B, 2N, 3))."""
    check_gate_mode(gate_mode)
    noisy_gfv = encode(model, pc, mask)
    z = select_z(model, noisy_gfv, cfg, ou_state=ou_state,
                 add_noise=add_noise, normal=normal, generator=generator)
    clean_gfv = gan_generate(model, z)
    completed = gan_decode(model, clean_gfv)
    ae_recon = decode(model, noisy_gfv)
    results = {
        "noisy_gfv": noisy_gfv,
        "z_vector": z,
        "clean_gfv": clean_gfv,
        "completed_pc": completed,
        "ae_reconstruction": ae_recon,
    }
    if hybrid:
        results.update(gate(
            completed, ae_recon, gate_mode,
            lambda: (discriminate(model, clean_gfv),
                     discriminate(model, noisy_gfv)), gate_bias))
    return results


@torch.no_grad()
def forward(model: dict, pc: Tensor, *, phase: str = "autoencoder",
            mode: str = "inference", mask: Optional[Tensor] = None,
            cfg: rl.TD3Config = rl.TD3Config(),
            z: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Phase-gated eval-mode forward (rl_gan_net.py:221-248). The lgan
    phase decodes G(z) for the standard-normal draw ``z`` (B, z_dim)."""
    if phase not in PHASES:
        raise ValueError(f"invalid phase {phase!r}; must be one of {PHASES}")
    if mode == "inference" or phase in ("rl_agent", "joint"):
        return complete(model, pc, mask, cfg=cfg,
                        hybrid=(mode == "inference"))
    noisy_gfv = encode(model, pc, mask)
    results = {"noisy_gfv": noisy_gfv}
    if phase == "autoencoder":
        results["ae_reconstruction"] = decode(model, noisy_gfv)
    elif phase == "lgan":
        if z is None:
            raise ValueError("the lgan-phase forward needs a z draw")
        results["z_vector"] = z
        results["clean_gfv"] = generate(model, z)
        results["completed_pc"] = decode(model, results["clean_gfv"])
    return results


@torch.no_grad()
def compute_reward(model: dict, pred_pc: Tensor, target_pc: Tensor,
                   pred_gfv: Tensor, target_gfv: Tensor, *,
                   w_chamfer: float = 100.0, w_gfv: float = 10.0,
                   w_discriminator: float = 0.01) -> Tensor:
    """Per-sample rewards (B,) (rl_gan_net.py:251-266). No gradient: K3
    saves nothing for a backward pass."""
    return losses_ops.completion_reward_batched(
        pred_pc, target_pc, pred_gfv, target_gfv,
        discriminate(model, pred_gfv), w_chamfer=w_chamfer, w_gfv=w_gfv,
        w_discriminator=w_discriminator)


class EnvState(NamedTuple):
    """Everything a step needs, batched (rl_gan_net.py:275-281)."""

    state: Tensor       # the observation: noisy GFVs (B, latent_dim)
    target_pc: Tensor   # (B, N, 3)
    target_gfv: Tensor  # (B, latent_dim)


@torch.no_grad()
def env_reset(model: dict, incomplete_pc: Tensor, complete_pc: Tensor,
              mask: Optional[Tensor] = None) -> EnvState:
    """(rl_gan_net.py:284-292)"""
    return EnvState(state=encode(model, incomplete_pc, mask),
                    target_pc=complete_pc,
                    target_gfv=encode(model, complete_pc))


@torch.no_grad()
def env_step(model: dict, env: EnvState, action: Tensor, *,
             w_chamfer: float = 100.0, w_gfv: float = 10.0,
             w_discriminator: float = 0.01
             ) -> Tuple[EnvState, Tensor, Tensor, Dict[str, Tensor]]:
    """z -> G -> decode -> reward (rl_gan_net.py:295-320). Returns
    (next env state, rewards (B,), dones (B,), info)."""
    clean_gfv = generate(model, action)
    completed = decode(model, clean_gfv)
    rewards = compute_reward(model, completed, env.target_pc, clean_gfv,
                             env.target_gfv, w_chamfer=w_chamfer,
                             w_gfv=w_gfv, w_discriminator=w_discriminator)
    next_env = EnvState(state=clean_gfv, target_pc=env.target_pc,
                        target_gfv=env.target_gfv)
    return (next_env, rewards, torch.ones_like(rewards),
            {"completed_pc": completed, "clean_gfv": clean_gfv})
