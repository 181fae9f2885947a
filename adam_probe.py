#!/usr/bin/env python3
"""Why chip_smoke holds the LGAN step's update on the card against the
CPU from Adam moments one step old (chip_smoke.lgan_warm), on one NVIDIA
GPU: one ``lgan_combined_step`` at the flagship widths from fresh weights
(seeds 0, 4 and 7), on the card and on the CPU with the same draws, once
from a fresh Adam and once from moments one combined step old.

  python3 adam_probe.py

Prints, per seed and start, the losses' error, each network's update
error (chip_smoke.network_errs: the update's 2-norm error relative to the
CPU's) and the number of parameter elements whose update differs by more
than half the CPU's largest update element: a fresh Adam's first step is
lr times the sign of the gradient, so such an element is one whose
gradient sits at the rounding level.
"""

from __future__ import annotations

import subprocess
import sys

import torch

import chip_smoke

SEEDS = (0, 4, 7)


def flips(card: dict, cpu: dict, start: dict) -> int:
    n = 0
    for (path, a), (_, b), (_, s0) in zip(
            chip_smoke._named_leaves(card["params"]),
            chip_smoke._named_leaves(cpu["params"]),
            chip_smoke._named_leaves(start["params"])):
        if chip_smoke.adam_noise(path, card["params"]):
            continue
        moved = b.detach() - s0.detach()
        diff = a.detach().cpu() - b.detach()
        n += int((diff.abs() > 0.5 * moved.abs().max()).sum())
    return n


def fresh(lgan: dict, cfg) -> tuple:
    """``lgan_warm``'s triple with no step taken: fresh Adam states."""
    from gan_rl_3d_tpu_torch.train import steps
    lc = cfg.training.lgan
    cpu = torch.device("cpu")
    params = chip_smoke._on(lgan["params"], cpu, grad=True)
    g = steps.make_gan_optimizer(params["generator"], lc.generator_lr, lc)
    d = steps.make_gan_optimizer(params["discriminator"],
                                 lc.discriminator_lr, lc)
    return ({"params": params, "state": chip_smoke._on(lgan["state"], cpu)},
            g.state_dict(), d.state_dict())


def main() -> int:
    from gan_rl_3d_tpu_torch.device import resolve_device
    from gan_rl_3d_tpu_torch.models import rl_gan_net as net

    card = resolve_device("cuda")
    cpu = torch.device("cpu")
    cfg = chip_smoke._flagship()
    lc, m = cfg.training.lgan, cfg.model.lgan
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    for seed in SEEDS:
        lgan = net.init_model(torch.Generator().manual_seed(seed), cfg,
                              cpu)["lgan"]
        real = [torch.tanh(torch.randn(
            lc.d_steps, lc.batch_size, m.latent_dim,
            generator=torch.Generator().manual_seed(100 * seed + i)))
            for i in range(2)]
        draws = chip_smoke.lgan_draws(cfg, seed=100 * seed + 2)
        starts = {"fresh": fresh(lgan, cfg),
                  "one step old": chip_smoke.lgan_warm(lgan, cfg, real[0],
                                                       seed=100 * seed + 3)}
        for name, warm in starts.items():
            (sm, on_card), (rm, on_cpu) = (
                chip_smoke.lgan_step_on(dev, warm, cfg, real[1], draws)
                for dev in (card, cpu))
            line = f"seed {seed}, Adam {name}: losses " + ", ".join(
                f"{k} {chip_smoke._rel(sm[k], rm[k]):.3e}"
                for k in ("d_loss", "g_loss"))
            for k in on_card:
                start = {part: warm[0][part][k]
                         for part in ("params", "state")}
                update = chip_smoke.network_errs(on_card[k], on_cpu[k],
                                                 start)[0]
                n = sum(v.numel() for v in chip_smoke._leaves(
                    start["params"]))
                line += (f"; {k} update {update:.3e}, "
                         f"{flips(on_card[k], on_cpu[k], start)} of {n} "
                         "elements flipped")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
