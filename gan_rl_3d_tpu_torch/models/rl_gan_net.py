"""RL-GAN-Net completion path, unfolded (gan_rl_3d_tpu/models/rl_gan_net.py).

``complete`` is the plain reference the folded engine
(models/inference.py::complete_fast) is held against: encoder -> actor z ->
generator -> decoder, the plain AE reconstruction, and the hybrid gate.

The model is a dictionary in the JAX tree's layout, as ``init_model`` and
``convert.model_from_numpy`` build it: ``ae``, ``lgan`` and
``agent.actor`` each hold ``params`` and ``state``, and an optional
``gan_path`` snapshot holds the serving GAN branch's generator and decoder.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gan_rl_3d_tpu_torch.config import GATE_MODES
from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.models import latent_gan as lg
from gan_rl_3d_tpu_torch.models import rl_agent as rl

Tensor = torch.Tensor


def init_model(generator: torch.Generator, config) -> dict:
    """The serving model with fresh weights (rl_gan_net.py:38-58): ``ae``,
    ``lgan`` and ``agent.actor``, drawn from ``generator`` in that order;
    the critics, target networks and optimizer state wait for the RL
    phase. ``config`` is a ``config.Config``."""
    a, g, r = config.model.autoencoder, config.model.lgan, config.model.rl_agent
    ae_p, ae_s = ae.autoencoder_init(
        generator, a.input_dim, a.latent_dim, a.num_points, a.encoder_dims,
        a.decoder_dims, a.encoder_type, a.decoder_type)
    lg_p, lg_s = lg.lgan_init(generator, g.z_dim, g.latent_dim,
                              g.generator_dims, g.discriminator_dims,
                              spectral_norm=g.spectral_norm)
    actor_p, actor_s = rl.actor_init(generator, r.state_dim, r.action_dim,
                                     r.hidden_dims)
    return {"ae": {"params": ae_p, "state": ae_s},
            "lgan": {"params": lg_p, "state": lg_s},
            "agent": {"actor": {"params": actor_p, "state": actor_s}}}


def encode(model: dict, pc: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    return ae.encoder_apply(model["ae"]["params"]["encoder"],
                            model["ae"]["state"]["encoder"], pc, mask)


def decode(model: dict, gfv: Tensor) -> Tensor:
    return ae.decoder_apply(model["ae"]["params"]["decoder"],
                            model["ae"]["state"]["decoder"], gfv)


def generate(model: dict, z: Tensor) -> Tensor:
    return lg.generator_apply(model["lgan"]["params"]["generator"],
                              model["lgan"]["state"]["generator"], z)


def gan_generate(model: dict, z: Tensor) -> Tensor:
    """Generator of the serving GAN branch: the ``gan_path`` snapshot when
    present, else the live generator (rl_gan_net.py:99-108)."""
    snap = model.get("gan_path")
    if snap is not None:
        return lg.generator_apply(snap["generator"]["params"],
                                  snap["generator"]["state"], z)
    return generate(model, z)


def gan_decode(model: dict, gfv: Tensor) -> Tensor:
    """Decoder of the serving GAN branch (rl_gan_net.py:111-120)."""
    snap = model.get("gan_path")
    if snap is not None:
        return ae.decoder_apply(snap["decoder"]["params"],
                                snap["decoder"]["state"], gfv)
    return decode(model, gfv)


def discriminate(model: dict, gfv: Tensor) -> Tensor:
    return lg.discriminator_apply(model["lgan"]["params"]["discriminator"],
                                  model["lgan"]["state"]["discriminator"], gfv)


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
