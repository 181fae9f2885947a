"""Train RL-GAN-Net with the PyTorch port (the port of train_rl_gan_net.py).

  python -m gan_rl_3d_tpu_torch.train_rl_gan_net --config configs/config.yaml \
      --phase autoencoder [--device cuda|cpu]

Only the autoencoder phase is ported; the others raise and name their
ROADMAP.md items. Without ``data.data_dir`` on disk the trainer writes the
synthetic dataset there first. Checkpoints go to
``training.checkpoint_dir`` as pickles the JAX package reads.
"""

from __future__ import annotations

import argparse

PHASE_CHOICES = ("autoencoder", "lgan", "rl_agent", "joint", "full")
_NOT_PORTED = {
    "lgan": "queue 1, item 12 (GFV extraction and the LGAN phase)",
    "rl_agent": "queue 1, item 13 (the RL phase)",
    "joint": "queue 1, item 14 (the joint phase and gate calibration)",
    "full": "queue 1, items 12-15 (the phases after the autoencoder)",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train RL-GAN-Net (PyTorch port)")
    p.add_argument("--config", default="configs/config.yaml",
                   help="YAML config in the JAX package's schema")
    p.add_argument("--phase", choices=PHASE_CHOICES, default="full",
                   help="training phase to run; only autoencoder is ported")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p


def main(argv=None) -> float:
    args = _parser().parse_args(argv)
    if args.phase in _NOT_PORTED:
        raise NotImplementedError(
            f"--phase {args.phase} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED[args.phase]}")
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer

    return RLGANNetTrainer(args.config, device=args.device).train_autoencoder()


if __name__ == "__main__":
    main()
