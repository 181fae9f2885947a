"""Train RL-GAN-Net with the PyTorch port (the port of train_rl_gan_net.py).

  python -m gan_rl_3d_tpu_torch.train_rl_gan_net --config configs/config.yaml \
      [--phase full] [--resume NAME] [--device cuda|cpu]
  python -m gan_rl_3d_tpu_torch.train_rl_gan_net --config configs/config.yaml \
      --phase lgan --resume autoencoder_best

Every phase is ported: ``autoencoder``; ``lgan`` (GFV extraction, then the
latent WGAN-GP); ``rl_agent`` (the TD3 agent); ``joint`` (the joint
fine-tune, then phase 5.5: the D refresh and the gate calibration, saved
as ``joint_calibrated`` with ``gate_calibration.json``); ``full`` (the
default: the whole curriculum, ending with the ``final`` checkpoint).
``--resume NAME`` loads the model checkpoint NAME from
``training.checkpoint_dir`` before the phase; with ``--phase full`` the
curriculum then restarts at the phase the checkpoint records, skipping the
ones before it. Without ``data.data_dir`` on disk the trainer writes the
synthetic dataset there first. Checkpoints go to
``training.checkpoint_dir`` as pickles the JAX package reads.
"""

from __future__ import annotations

import argparse

PHASE_CHOICES = ("autoencoder", "lgan", "rl_agent", "joint", "full")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train RL-GAN-Net (PyTorch port)")
    p.add_argument("--config", default="configs/config.yaml",
                   help="YAML config in the JAX package's schema")
    p.add_argument("--phase", choices=PHASE_CHOICES, default="full",
                   help="training phase to run (full: the whole curriculum)")
    p.add_argument("--resume", default=None,
                   help="model checkpoint to load before the phase "
                        "(e.g. autoencoder_best, lgan_best)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p


def main(argv=None):
    """Run the phase; returns the phase's best loss or reward (for
    ``joint`` the best joint val loss; None for ``full``)."""
    args = _parser().parse_args(argv)
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer

    trainer = RLGANNetTrainer(args.config, device=args.device)
    resumed = bool(args.resume)
    if resumed:
        trainer.load_checkpoint(args.resume)
    if args.phase == "autoencoder":
        return trainer.train_autoencoder()
    if args.phase == "lgan":
        trainer.generate_gfvs()
        return trainer.train_latent_gan()
    if args.phase == "rl_agent":
        return trainer.train_rl_agent()
    if args.phase == "joint":
        best = trainer.joint_training()
        trainer.post_joint_refresh()
        return best
    trainer.train_full_pipeline(start_phase=None if resumed else "autoencoder")
    return None


if __name__ == "__main__":
    main()
