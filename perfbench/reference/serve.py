"""Plain completion: encoder -> actor z -> generator -> decoder, the plain
autoencoder reconstruction, and the discriminator gate, in eval mode."""

from typing import Dict

import torch

from perfbench.reference import nets

Tensor = torch.Tensor


@torch.no_grad()
def complete(model: dict, pc: Tensor, mask: Tensor, *, action_bound: float,
             gate_bias: float, block: int) -> Dict[str, Tensor]:
    """The outputs of one served batch, computed ``block`` clouds at a time
    so that the point MLP's activations fit beside the program's outputs.
    ``model`` holds ``ae``, ``lgan`` and ``actor``, each with ``params``
    and ``state``."""
    parts = [_complete(model, pc[i:i + block], mask[i:i + block],
                       action_bound, gate_bias)
             for i in range(0, pc.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _complete(model, pc, mask, action_bound, gate_bias):
    ae_p, ae_s = model["ae"]["params"], model["ae"]["state"]
    lg_p, lg_s = model["lgan"]["params"], model["lgan"]["state"]
    act = model["actor"]
    gfv = nets.encoder(ae_p["encoder"], ae_s["encoder"], pc, mask, False)[0]
    z = nets.actor(act["params"], act["state"], gfv, action_bound)
    clean = nets.generator(lg_p["generator"], lg_s["generator"], z)
    completed = nets.decoder(ae_p["decoder"], ae_s["decoder"], clean,
                             False)[0]
    recon = nets.decoder(ae_p["decoder"], ae_s["decoder"], gfv, False)[0]
    rl_score = nets.discriminator(lg_p["discriminator"],
                                  lg_s["discriminator"], clean)
    ae_score = nets.discriminator(lg_p["discriminator"],
                                  lg_s["discriminator"], gfv)
    gan_side = (rl_score > ae_score + gate_bias)[..., None]
    return {"noisy_gfv": gfv, "z_vector": z, "clean_gfv": clean,
            "completed_pc": completed, "ae_reconstruction": recon,
            "rl_gan_score": rl_score, "ae_score": ae_score,
            "hybrid_output": torch.where(gan_side, completed, recon)}
