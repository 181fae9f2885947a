"""Curriculum trainer, phase 1 (gan_rl_3d_tpu/train/trainer.py).

``RLGANNetTrainer`` holds the data splits, the model tree and the
checkpoints. This slice runs the autoencoder phase: the train split lives
on the device for the whole phase, each epoch is a loop of
``steps.ae_train_step`` over a shuffled batch plan, validation runs with
fixed per-batch hole draws, and the best and periodic checkpoints are
written in the JAX package's pickle layout. The model tree holds ``ae``
only; the LGAN, RL and joint phases are later slices (ROADMAP queue 1,
items 12-15).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from gan_rl_3d_tpu_torch.config import Config, load_config
from gan_rl_3d_tpu_torch.convert import model_to_numpy, tree_from_numpy
from gan_rl_3d_tpu_torch.data.dataset import (BatchLoader, ShapeNetDataset,
                                              setup_dataset)
from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.train import steps
from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt_lib
from gan_rl_3d_tpu_torch.utils.tree import tree_map

PHASES = ("autoencoder", "lgan", "rl_agent", "joint")


class RLGANNetTrainer:
    def __init__(self, config: "Config | str", *,
                 device: "str | torch.device" = "cuda"):
        self.config = (load_config(config) if isinstance(config, str)
                       else config)
        cfg = self.config
        self.device = resolve_device(device)
        self.checkpoint_dir = Path(cfg.training.checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.preproc = cfg.preproc_spec()
        self.bidirectional = cfg.loss.bidirectional
        self.recon_loss = cfg.loss.reconstruction_loss
        self.compute_dtype, self.precision_selective = steps.compute_dtype_of(
            cfg.training.precision)
        self.bn_stats = cfg.training.bn_stats

        self._setup_data()

        # weights are drawn on the CPU, so a seed gives the same model on
        # every device; the transforms' draws come from a device generator
        a = cfg.model.autoencoder
        params, state = ae.autoencoder_init(
            torch.Generator().manual_seed(cfg.training.seed), a.input_dim,
            a.latent_dim, a.num_points, a.encoder_dims, a.decoder_dims,
            a.encoder_type, a.decoder_type)
        self.model = {"ae": self._on_device(params, state)}
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.training.seed + 1)
        self._save_freq = max(cfg.logging.save_model_frequency, 1)
        self.train_losses: list = []  # every AE step's loss, in order

    def _on_device(self, params, state) -> dict:
        return {"params": tree_map(lambda v: v.to(self.device)
                                   .requires_grad_(True), params),
                "state": tree_map(lambda v: v.to(self.device), state)}

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------

    def _setup_data(self):
        cfg = self.config
        data_dir = Path(cfg.data.data_dir)
        if not data_dir.exists():
            print(f"Dataset not found at {data_dir}; creating synthetic data")
            setup_dataset(str(data_dir), synthetic=True)
        fractions = None
        if not (data_dir / "train").exists():
            fractions = (cfg.data.train_split, cfg.data.val_split,
                         cfg.data.test_split)

        def make_loader(split, shuffle):
            return BatchLoader(
                ShapeNetDataset(str(data_dir), split,
                                cfg.model.autoencoder.num_points,
                                seed=cfg.training.seed,
                                split_fractions=fractions),
                cfg.training.batch_size, shuffle=shuffle,
                seed=cfg.training.seed)

        self.train_loader = make_loader("train", True)
        # best-checkpoint selection uses the val split when it has data
        self.val_loader = make_loader("val", False)
        self.test_loader = make_loader("test", False)
        if len(self.val_loader.dataset) == 0:
            self.val_loader = self.test_loader
        print(f"Training samples: {len(self.train_loader.dataset)}")
        print(f"Validation samples: {len(self.val_loader.dataset)}")
        print(f"Test samples: {len(self.test_loader.dataset)}")

    def _resident_train_data(self) -> torch.Tensor:
        """The train split on the device for the whole phase; per epoch
        only the batch plan, a few KB, crosses from the host."""
        return torch.from_numpy(self.train_loader.dataset.as_array()).to(
            self.device)

    # ------------------------------------------------------------------
    # phase 1: autoencoder
    # ------------------------------------------------------------------

    def train_autoencoder(self, num_epochs: Optional[int] = None) -> float:
        cfg = self.config.training.autoencoder
        num_epochs = num_epochs or cfg.epochs
        print(f"\n=== PHASE 1: autoencoder ({num_epochs} epochs) ===")
        params = self.model["ae"]["params"]
        bn_state = self.model["ae"]["state"]
        optimizer, scheduler = steps.make_ae_optimizer(
            params, cfg, len(self.train_loader))
        best_val = float("inf")
        eval_freq = max(self.config.evaluation.eval_frequency, 1)
        data = self._resident_train_data()
        for epoch in range(num_epochs):
            t0 = time.time()
            order, pads = self.train_loader.epoch_indices()
            bn_state, m = steps.ae_train_epoch(
                params, bn_state, optimizer, scheduler, data,
                torch.from_numpy(order).long().to(self.device),
                torch.from_numpy(pads).to(self.device), self.generator,
                spec=self._ae_train_spec(epoch, num_epochs),
                compute_dtype=self.compute_dtype,
                selective=self.precision_selective, bn_stats=self.bn_stats,
                recon_loss=self.recon_loss, bidirectional=self.bidirectional)
            losses = m["losses"].cpu().numpy()
            self.train_losses.extend(losses.tolist())
            train_loss = float(losses.mean())
            self.model["ae"] = {"params": params, "state": bn_state}
            # validate per evaluation.eval_frequency, and on the last epoch
            val_loss = None
            if (epoch + 1) % eval_freq == 0 or epoch == num_epochs - 1:
                val_loss = self._validate_ae(params, bn_state)
            dt = time.time() - t0
            val_txt = f"val {val_loss:.6f}" if val_loss is not None else ""
            print(f"AE epoch {epoch + 1}/{num_epochs} "
                  f"train {train_loss:.6f} {val_txt} ({dt:.1f}s)")
            if val_loss is not None and val_loss < best_val:
                best_val = val_loss
                self.save_checkpoint("autoencoder_best", epoch, "autoencoder")
            if (epoch + 1) % self._save_freq == 0:
                self.save_checkpoint(f"autoencoder_epoch_{epoch + 1}", epoch,
                                     "autoencoder")
        print(f"AE done; best val loss {best_val:.6f}")
        return best_val

    def _ae_train_spec(self, epoch: int, num_epochs: int
                       ) -> pc_ops.PreprocSpec:
        """With autoencoder.hole_curriculum the hole bounds grow easy ->
        target in 3 equal stages, (s + 1) / 3 of the configured range;
        validation always uses the target spec (trainer.py:254-267)."""
        if not self.config.training.autoencoder.hole_curriculum:
            return self.preproc
        stage = min(3 * epoch // max(num_epochs, 1), 2)
        frac = (stage + 1) / 3.0
        return dataclasses.replace(
            self.preproc, hole_min=round(self.preproc.hole_min * frac, 6),
            hole_max=round(self.preproc.hole_max * frac, 6))

    def _validate_ae(self, params, bn_state) -> float:
        """Mean eval loss over the val split, batch i's holes drawn from a
        generator seeded with i (fixed holes, comparable epochs)."""
        losses = []
        for i, batch in enumerate(self.val_loader):
            pc = torch.from_numpy(batch["complete_pc"]).to(self.device)
            draws = pc_ops.draw_training_batch(
                torch.Generator(self.device).manual_seed(i), pc.shape[0],
                pc.shape[1], spec=self.preproc, augment=False)
            m = steps.ae_eval_step(
                params, bn_state,
                {"complete_pc": pc,
                 "pad": torch.from_numpy(batch["pad"]).to(self.device)},
                draws, spec=self.preproc, recon_loss=self.recon_loss,
                bidirectional=self.bidirectional)
            losses.append(m["loss"])
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, name: str, epoch: int, phase: str) -> None:
        """{"model": {"ae": ...}, "meta": {"epoch", "phase_idx"}} as a
        pickle of numpy arrays, the JAX trainer's layout
        (trainer.py:735-778 with use_orbax=False)."""
        ckpt_lib.save_checkpoint(
            str(self.checkpoint_dir / name),
            {"model": model_to_numpy(self.model),
             "meta": {"epoch": np.int32(epoch),
                      "phase_idx": np.int32(PHASES.index(phase))}})

    def load_checkpoint(self, name: str) -> Tuple[int, str]:
        """Restore the ``ae`` subtree of a pickle checkpoint (this
        package's or the JAX package's); other subtrees are not ported
        yet and are left out."""
        tree = ckpt_lib.load_checkpoint(str(self.checkpoint_dir / name))
        a = tree["model"]["ae"]
        self.model = {"ae": self._on_device(
            tree_from_numpy(a["params"], torch.device("cpu")),
            tree_from_numpy(a["state"], torch.device("cpu")))}
        epoch = int(tree["meta"]["epoch"])
        phase = PHASES[int(tree["meta"]["phase_idx"])]
        print(f"loaded checkpoint {self.checkpoint_dir / name} "
              f"(epoch {epoch}, phase {phase})")
        return epoch, phase
