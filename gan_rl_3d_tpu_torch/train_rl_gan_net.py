"""Train RL-GAN-Net with the PyTorch port (the port of train_rl_gan_net.py).

  python -m gan_rl_3d_tpu_torch.train_rl_gan_net --config configs/config.yaml \
      --phase autoencoder [--device cuda|cpu]
  python -m gan_rl_3d_tpu_torch.train_rl_gan_net --config configs/config.yaml \
      --phase lgan --resume autoencoder_best
  python -m gan_rl_3d_tpu_torch.train_rl_gan_net --config configs/config.yaml \
      --phase rl_agent --resume lgan_best

Phases 1-4 are ported: ``autoencoder``; ``lgan`` (GFV extraction, then
the latent WGAN-GP); ``rl_agent`` (the TD3 agent). ``--resume NAME`` loads
the model checkpoint NAME from ``training.checkpoint_dir`` before the
phase; a phase after the first starts from the one before it this way.
``joint`` and ``full`` raise and name their ROADMAP.md items. Without
``data.data_dir`` on disk the trainer writes the synthetic dataset there
first. Checkpoints go to ``training.checkpoint_dir`` as pickles the JAX
package reads.
"""

from __future__ import annotations

import argparse

PHASE_CHOICES = ("autoencoder", "lgan", "rl_agent", "joint", "full")
_NOT_PORTED = {
    "joint": "queue 1, item 14 (the joint phase and gate calibration)",
    "full": "queue 1, items 14-15 (the joint phase and the whole pipeline)",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train RL-GAN-Net (PyTorch port)")
    p.add_argument("--config", default="configs/config.yaml",
                   help="YAML config in the JAX package's schema")
    p.add_argument("--phase", choices=PHASE_CHOICES, default="full",
                   help="training phase to run; autoencoder, lgan and "
                        "rl_agent are ported")
    p.add_argument("--resume", default=None,
                   help="model checkpoint to load before the phase "
                        "(e.g. autoencoder_best, lgan_best)")
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

    trainer = RLGANNetTrainer(args.config, device=args.device)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    if args.phase == "lgan":
        trainer.generate_gfvs()
        return trainer.train_latent_gan()
    if args.phase == "rl_agent":
        return trainer.train_rl_agent()
    return trainer.train_autoencoder()


if __name__ == "__main__":
    main()
