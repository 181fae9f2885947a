"""Curriculum trainer, phases 1-5 (gan_rl_3d_tpu/train/trainer.py).

``RLGANNetTrainer`` holds the data splits, the model tree and the
checkpoints. The model tree holds ``ae``, ``lgan``, the whole TD3 agent
and, from a checkpoint that has one or a joint phase that takes one,
``gan_path``; ``evaluate`` and ``complete_clouds --checkpoint`` read its
serving part. Phase 1 trains the autoencoder: the train split lives on the
device for the whole phase, each epoch is a loop of
``steps.ae_train_step`` over a shuffled batch plan, validation runs with
fixed per-batch hole draws. Phase 2 extracts the train split's (clean,
noisy) GFV pairs; phase 3 trains the latent WGAN-GP on the clean ones;
phase 4 trains the TD3 agent in batched environments whose reward runs
K3, with a greedy eval on a fixed, evenly spread validation batch. Phase
5 fine-tunes the encoder, decoder and generator against the frozen actor
(``steps.joint_train_step``) and validates through the hybrid gate; phase
5.5 (``post_joint_refresh``) retrains D on the post-joint GFVs and
calibrates the gate on the val split, writing ``gate_calibration.json``.
``train_full_pipeline`` runs the curriculum, restarting at the phase a
loaded checkpoint records, and ends with ``final``. Each model family
(the PointNet encoder and MLP decoder, the attention encoder and adaptive
decoder, or PCN's two-stage encoder and folding decoder, of
``model.autoencoder.{encoder,decoder}_type``) runs through every phase;
with ``model.autoencoder.input_points`` (PCN) every phase's encoder input
is that many rows drawn from each target, and a clean GFV encodes them
before the hole is cut. Each phase writes its scalars with the JAX trainer's
tags and steps (AE/*, GAN/*, RL/*, Joint/*) to ``metrics.jsonl`` under
``training.log_dir`` (``utils.metrics_logging``); ``close()`` closes the
log.

The best and periodic checkpoints are written in the JAX package's pickle
layout; ``load_checkpoint`` reads either package's, pickle or orbax
directory. A periodic checkpoint carries a ``<name>_trainstate`` sibling
with the JAX package's fields and optax layout (trainer.py:246,394,503,
593): the AE and joint optimizer states with ``best_val`` and ``epoch``,
the LGAN's two with ``best_g`` and ``epoch``, the RL phase's replay ring
and OU state with ``best_avg`` and ``it`` (the agent's Adam rides in the
model). Resuming from such a checkpoint (``load_checkpoint``, then the
phase) restores the sibling once, into the phase the checkpoint records,
and continues at the next epoch or iteration; the RL phase replays its
data-sampling draws to that iteration. As in the JAX package, nothing
else is replayed: the loader's permutations and the device generator
start from the seed, so a resumed run follows the JAX package's resumed
run, not an uninterrupted one (trainer.py:814-831).

Under ``torchrun`` the trainer runs on the mesh of every rank on "data"
(``parallel.mesh.make_mesh()``, trainer.py:72-82): each rank trains on its
rows of every global batch, draws the global batch's random numbers from
the same seeded generator, and so follows the single-device trajectory.
The resident split is replicated, or row-sharded under
``training.data_residency: sharded`` when the sizes align (else the
replication is printed). Rank 0 alone writes checkpoints, their siblings,
the gate sidecar, the GFV cache and the metrics log, and prints; every
save ends in a barrier. Without a process group the mesh is 1x1 and
nothing communicates.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gan_rl_3d_tpu_torch.config import Config, load_config
from gan_rl_3d_tpu_torch.convert import (adam_to_optax, agent_from_numpy,
                                         buffer_from_numpy, buffer_to_numpy,
                                         chain_to_optax, load_adam,
                                         load_chain, model_from_numpy,
                                         model_to_numpy, optax_layout,
                                         tree_from_numpy)
from gan_rl_3d_tpu_torch.data.dataset import (BatchLoader, ShapeNetDataset,
                                              setup_dataset)
from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
from gan_rl_3d_tpu_torch.train import gate as gate_lib
from gan_rl_3d_tpu_torch.train import replay_buffer as rb
from gan_rl_3d_tpu_torch.train import steps
from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt_lib
from gan_rl_3d_tpu_torch.utils.metrics_logging import MetricsLogger
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map

PHASES = net.PHASES
EVAL_HOLES_SEED = 777  # the greedy eval's fixed holes (trainer.py:460)
# streams of fixed per-batch holes, as the JAX trainer's validation keys
# PRNGKey(0), (1), (2) folded with the batch index (trainer.py:271,573,674)
AE_VAL_HOLES, JOINT_VAL_HOLES, GATE_HOLES = 0, 1, 2
HOLE_STREAMS = 3


def _print(*args, **kwargs) -> None:
    """print on the writing rank (rank 0) alone."""
    if mesh_lib.is_writer():
        print(*args, **kwargs)


def fixed_holes_seed(stream: int, i: int) -> int:
    """The seed of batch i's holes in a stream: distinct for every
    (stream, batch) pair within the low 32 bits, the only bits the CPU
    generator keeps."""
    return HOLE_STREAMS * i + stream


class RLGANNetTrainer:
    def __init__(self, config: "Config | str", *,
                 device: "str | torch.device" = "cuda"):
        self.config = (load_config(config) if isinstance(config, str)
                       else config)
        cfg = self.config
        self.device = resolve_device(device)
        # every rank on "data" (trainer.py:72-82); 1x1 without a group
        self.mesh = mesh_lib.make_mesh(device=self.device)
        # joint.w_ae_recon > 0 decodes two batches in one pass
        nn.validate_bn_stats_mesh(
            cfg.training.bn_stats, self.mesh.n_data,
            segments=2 if cfg.training.joint.w_ae_recon > 0.0 else 1)
        self.checkpoint_dir = Path(cfg.training.checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.logger = MetricsLogger(
            cfg.training.log_dir,
            use_tensorboard=cfg.logging.use_tensorboard,
            use_wandb=cfg.logging.use_wandb,
            project_name=cfg.logging.project_name)
        self.preproc = cfg.preproc_spec()
        self.bidirectional = cfg.loss.bidirectional
        self.recon_loss = cfg.loss.reconstruction_loss
        self.compute_dtype, self.precision_selective = steps.compute_dtype_of(
            cfg.training.precision)
        self.bn_stats = cfg.training.bn_stats
        self.td3 = cfg.td3_config()
        # PCN's input: this many rows drawn from each target
        self.input_points = cfg.model.autoencoder.input_points or None

        self._setup_data()

        # weights are drawn on the CPU, so a seed gives the same model on
        # every device; the transforms' draws come from a device generator
        model = net.init_model(torch.Generator().manual_seed(cfg.training.seed),
                               cfg, self.device)
        self.model = mesh_lib.shard_model_for_mesh(
            self.mesh, {**model, "ae": self._on_device(**model["ae"])})
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.training.seed + 1)
        self._save_freq = max(cfg.logging.save_model_frequency, 1)
        self._gfv_path = self.checkpoint_dir / "gfv" / "gfvs_train.npz"
        self.gfvs: Optional[Dict[str, np.ndarray]] = None
        self.train_losses: list = []  # every AE step's loss, in order
        self.lgan_losses: list = []   # (G, D) loss of every LGAN epoch
        # per RL iteration: the mean episode reward (float) and the last
        # update's critic and actor losses (0-d tensors, read without a
        # sync); and the greedy evals as (episode, reward, chamfer)
        self.rl_history: list = []
        self.rl_evals: list = []
        self.joint_losses: list = []  # (train, val) loss of every epoch
        self.refresh_d_losses: list = []  # every D refresh step's loss
        self.gate_report: Optional[dict] = None
        self.epoch = 0  # the last AE epoch trained in this run
        self.current_phase = "autoencoder"  # set by load_checkpoint
        # set by load_checkpoint, consumed by the phase it names
        # (_restore_train_state)
        self._resume: Optional[dict] = None
        # whether this run calibrated the gate: a sidecar of an earlier run
        # must not stay scoped to a checkpoint this run overwrites
        self._gate_calibrated = False

    def _on_device(self, params, state) -> dict:
        return {"params": tree_map(lambda v: v.to(self.device)
                                   .requires_grad_(True), params),
                "state": tree_map(lambda v: v.to(self.device), state)}

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------

    def _setup_data(self):
        # rank 0 writes a missing dataset and the split index files first;
        # the other ranks wait at the barrier, then read them
        if not mesh_lib.is_writer():
            mesh_lib.barrier()
        self._make_loaders()
        if mesh_lib.is_writer():
            mesh_lib.barrier()

    def _make_loaders(self):
        cfg = self.config
        data_dir = Path(cfg.data.data_dir)
        if not data_dir.exists():
            _print(f"Dataset not found at {data_dir}; creating synthetic data")
            setup_dataset(str(data_dir), synthetic=True,
                          num_points=cfg.model.autoencoder.num_points)
        fractions = None
        if not (data_dir / "train").exists():
            fractions = (cfg.data.train_split, cfg.data.val_split,
                         cfg.data.test_split)
        # the shard-aligned plan of a row-sharded split (trainer.py:117-131)
        groups = (mesh_lib.DATA_SHARD_GROUPS
                  if cfg.training.data_residency == "sharded" else 1)

        def make_loader(split, shuffle):
            return BatchLoader(
                ShapeNetDataset(str(data_dir), split,
                                cfg.model.autoencoder.num_points,
                                seed=cfg.training.seed,
                                split_fractions=fractions,
                                workers=cfg.training.num_workers),
                cfg.training.batch_size, shuffle=shuffle,
                seed=cfg.training.seed,
                shard_groups=groups if shuffle else 1)

        self.train_loader = make_loader("train", True)
        # best-checkpoint selection uses the val split when it has data
        self.val_loader = make_loader("val", False)
        self.test_loader = make_loader("test", False)
        if len(self.val_loader.dataset) == 0:
            self.val_loader = self.test_loader
        _print(f"Training samples: {len(self.train_loader.dataset)}")
        _print(f"Validation samples: {len(self.val_loader.dataset)}")
        _print(f"Test samples: {len(self.test_loader.dataset)}")

    def _put(self, batch: dict) -> dict:
        """This rank's rows of a host batch, on the device
        (trainer.py:145-146)."""
        return mesh_lib.shard_batch(self.mesh, batch)

    def _resident_train_data(self, replicate: bool = False
                             ) -> Tuple[torch.Tensor, bool]:
        """The train split on the device for the whole phase, as (data,
        data_sharded); per epoch only the batch plan, a few KB, crosses
        from the host. Replicated, or this rank's row block under
        training.data_residency "sharded" when the shard-aligned plan
        holds (trainer.py:148-170); misaligned sizes replicate, and say
        so."""
        data = self.train_loader.dataset.as_array()
        n, bs = len(data), self.train_loader.batch_size
        n_data = self.mesh.n_data
        groups = self.train_loader.shard_groups
        sharded = self.config.training.data_residency == "sharded"
        aligned = (sharded and groups > 1 and n % groups == 0
                   and bs % groups == 0 and groups % n_data == 0)
        if aligned and not replicate:
            # one rank's block is the whole split: it is taken as before
            return mesh_lib.row_sharding(self.mesh, data), n_data > 1
        if sharded and not replicate:
            _print(f"data_residency=sharded: sizes (n={n}, B={bs}, "
                   f"mesh data={n_data}) not aligned to "
                   f"{mesh_lib.DATA_SHARD_GROUPS} groups; replicating")
        return torch.from_numpy(data).to(self.device), False

    # ------------------------------------------------------------------
    # phase 1: autoencoder
    # ------------------------------------------------------------------

    def train_autoencoder(self, num_epochs: Optional[int] = None) -> float:
        cfg = self.config.training.autoencoder
        num_epochs = num_epochs or cfg.epochs
        _print(f"\n=== PHASE 1: autoencoder ({num_epochs} epochs) ===")
        params = self.model["ae"]["params"]
        bn_state = self.model["ae"]["state"]
        optimizer, scheduler = steps.make_ae_optimizer(
            params, cfg, len(self.train_loader))
        best_val = float("inf")
        start_epoch = 0
        rst = self._restore_train_state("autoencoder")
        if rst is not None:
            load_chain(optimizer, params, rst["opt_state"], scheduler)
            best_val = float(rst["best_val"])
            start_epoch = int(rst["epoch"]) + 1
        eval_freq = max(self.config.evaluation.eval_frequency, 1)
        log_freq = max(self.config.logging.log_frequency, 1)
        global_step = start_epoch * len(self.train_loader)
        data, data_sharded = self._resident_train_data()
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            order, pads = self.train_loader.epoch_indices()
            bn_state, m = steps.ae_train_epoch(
                params, bn_state, optimizer, scheduler, data,
                torch.from_numpy(order).long().to(self.device),
                torch.from_numpy(pads).to(self.device), self.generator,
                data_sharded=data_sharded, mesh=self.mesh,
                spec=self._ae_train_spec(epoch, num_epochs),
                compute_dtype=self.compute_dtype,
                selective=self.precision_selective, bn_stats=self.bn_stats,
                recon_loss=self.recon_loss, bidirectional=self.bidirectional,
                input_points=self.input_points, alpha=cfg.alpha)
            losses = m["losses"].cpu().numpy()
            self.train_losses.extend(losses.tolist())
            for i, loss in enumerate(losses):
                if (global_step + i) % log_freq == 0:
                    self.logger.log_scalar("AE/Batch_Loss", float(loss),
                                           global_step + i)
            global_step += len(losses)
            train_loss = float(losses.mean())
            self.logger.log_scalar("AE/Train_Loss", train_loss, epoch)
            self.model["ae"] = {"params": params, "state": bn_state}
            self.epoch = epoch
            # validate per evaluation.eval_frequency, and on the last epoch
            val_loss = None
            if (epoch + 1) % eval_freq == 0 or epoch == num_epochs - 1:
                val_loss = self._validate_ae(params, bn_state)
                self.logger.log_scalar("AE/Val_Loss", val_loss, epoch)
            dt = time.time() - t0
            val_txt = f"val {val_loss:.6f}" if val_loss is not None else ""
            _print(f"AE epoch {epoch + 1}/{num_epochs} "
                  f"train {train_loss:.6f} {val_txt} ({dt:.1f}s)")
            if val_loss is not None and val_loss < best_val:
                best_val = val_loss
                self.save_checkpoint("autoencoder_best", epoch, "autoencoder")
            if (epoch + 1) % self._save_freq == 0:
                self.save_checkpoint(
                    f"autoencoder_epoch_{epoch + 1}", epoch, "autoencoder",
                    train_state={
                        "opt_state": chain_to_optax(optimizer, params,
                                                    scheduler),
                        "best_val": np.float32(best_val),
                        "epoch": np.int32(epoch)})
        _print(f"AE done; best val loss {best_val:.6f}")
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

    def _fixed_holes(self, stream: int, i: int, bsz: int, n: int
                     ) -> Dict[str, torch.Tensor]:
        """Batch i's holes in a stream of fixed per-batch draws (no
        augmentation), the same in every epoch."""
        return pc_ops.draw_training_batch(
            torch.Generator(self.device).manual_seed(
                fixed_holes_seed(stream, i)),
            bsz, n, spec=self.preproc, augment=False,
            input_points=self.input_points)

    def _validate_ae(self, params, bn_state) -> float:
        """Mean eval loss over the val split, batch i's holes fixed
        (comparable epochs)."""
        losses = []
        for i, batch in enumerate(self.val_loader):
            bsz, n = batch["complete_pc"].shape[:2]
            m = steps.ae_eval_step(
                params, bn_state, self._put(batch),
                self._fixed_holes(AE_VAL_HOLES, i, bsz, n), spec=self.preproc,
                recon_loss=self.recon_loss, bidirectional=self.bidirectional,
                mesh=self.mesh)
            losses.append(m["loss"])
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------
    # phase 2: GFV extraction
    # ------------------------------------------------------------------

    def generate_gfvs(self) -> Dict[str, np.ndarray]:
        """(clean, noisy) GFVs of the train split with the frozen encoder,
        padded rows left out, saved to ``<checkpoint_dir>/gfv/
        gfvs_train.npz`` (trainer.py:285-303)."""
        _print("\n=== PHASE 2: GFV extraction ===")
        ae_m = self.model["ae"]
        gen = torch.Generator(self.device).manual_seed(
            self.config.training.seed + 1)
        clean_all, noisy_all = [], []
        for batch in self.train_loader:
            bsz, n = batch["complete_pc"].shape[:2]
            draws = pc_ops.draw_training_batch(gen, bsz, n, spec=self.preproc,
                                               augment=False,
                                               input_points=self.input_points)
            clean, noisy = steps.gfv_extract_step(
                ae_m["params"], ae_m["state"],
                self._put({"complete_pc": batch["complete_pc"]}), draws,
                spec=self.preproc, mesh=self.mesh)
            keep = batch["pad"] == 0
            clean_all.append(clean.cpu().numpy()[keep])
            noisy_all.append(noisy.cpu().numpy()[keep])
        self.gfvs = {"clean": np.concatenate(clean_all),
                     "noisy": np.concatenate(noisy_all)}
        if mesh_lib.is_writer():
            self._gfv_path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(self._gfv_path, **self.gfvs)
        mesh_lib.barrier()
        _print(f"extracted {len(self.gfvs['clean'])} GFV pairs "
              f"-> {self._gfv_path}")
        return self.gfvs

    def _load_gfvs(self) -> Dict[str, np.ndarray]:
        """The GFVs in memory, else this run's file, else the legacy
        ``<data_dir>/gfv/gfvs_train.npz``, else a fresh extraction
        (trainer.py:305-319)."""
        if self.gfvs is None:
            legacy = Path(self.config.data.data_dir) / "gfv" / "gfvs_train.npz"
            path = self._gfv_path if self._gfv_path.exists() else legacy
            if path.exists():
                loaded = np.load(path)
                self.gfvs = {"clean": loaded["clean"],
                             "noisy": loaded["noisy"]}
            else:
                self.generate_gfvs()
        return self.gfvs

    # ------------------------------------------------------------------
    # phase 3: latent WGAN-GP
    # ------------------------------------------------------------------

    def train_latent_gan(self, num_epochs: Optional[int] = None) -> float:
        """d_steps D updates (one fresh real batch each; at d_steps 1 an
        epoch is one pass over the permuted GFVs) and one G update per
        step; ``lgan_best`` by the lowest epoch G loss, as the reference
        picks it (trainer.py:325-406)."""
        cfg = self.config.training.lgan
        num_epochs = num_epochs or cfg.epochs
        _print(f"\n=== PHASE 3: latent GAN ({num_epochs} epochs, "
              f"d_steps={cfg.d_steps}) ===")
        gfvs = torch.from_numpy(self._load_gfvs()["clean"]).to(self.device)
        bs = cfg.batch_size or self.config.training.batch_size
        m = self.config.model.lgan
        params = self.model["lgan"]["params"]
        state = self.model["lgan"]["state"]
        for v in tree_leaves(params):
            v.requires_grad_(True)
        g_opt = steps.make_gan_optimizer(params["generator"],
                                         cfg.generator_lr, cfg)
        d_opt = steps.make_gan_optimizer(params["discriminator"],
                                         cfg.discriminator_lr, cfg)
        best_g = float("inf")
        start_epoch = 0
        rst = self._restore_train_state("lgan")
        if rst is not None:
            load_adam(g_opt, params["generator"], rst["g_opt_state"])
            load_adam(d_opt, params["discriminator"], rst["d_opt_state"])
            best_g = float(rst["best_g"])
            start_epoch = int(rst["epoch"]) + 1
        rng = np.random.RandomState(self.config.training.seed)
        n = len(gfvs)
        d_steps = max(cfg.d_steps, 1)
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            order = rng.permutation(n)
            g_losses, d_losses = [], []
            for si in range(max(n // bs, 1)):
                if d_steps == 1:
                    idx = order[si * bs:(si + 1) * bs][None, :]
                else:
                    idx = rng.randint(0, n, size=(d_steps, bs))
                # the real batch sharded along axis 1 (trainer.py:363-368)
                real = gfvs[torch.from_numpy(mesh_lib.local_rows(
                    self.mesh, idx, axis=1)).to(self.device)]
                draws = steps.draw_lgan_combined(
                    self.generator, idx.shape[1], m.z_dim,
                    m.discriminator_dims, d_steps)
                state, sm = steps.lgan_combined_step(
                    params, state, d_opt, g_opt, real, draws,
                    lambda_gp=cfg.lambda_gp, mesh=self.mesh)
                g_losses.append(sm["g_loss"])
                d_losses.append(sm["d_loss"])
            g_loss = float(torch.stack(g_losses).mean())
            d_loss = float(torch.stack(d_losses).mean())
            self.lgan_losses.append((g_loss, d_loss))
            self.logger.log_scalar("GAN/Generator_Loss", g_loss, epoch)
            self.logger.log_scalar("GAN/Discriminator_Loss", d_loss, epoch)
            _print(f"GAN epoch {epoch + 1}/{num_epochs} G {g_loss:.6f} "
                  f"D {d_loss:.6f} ({time.time() - t0:.1f}s)")
            self.model["lgan"] = {"params": params, "state": state}
            if g_loss < best_g:
                best_g = g_loss
                self.save_checkpoint("lgan_best", epoch, "lgan")
            if (epoch + 1) % self._save_freq == 0:
                self.save_checkpoint(
                    f"lgan_epoch_{epoch + 1}", epoch, "lgan", train_state={
                        "g_opt_state": adam_to_optax(
                            g_opt, params["generator"]),
                        "d_opt_state": adam_to_optax(
                            d_opt, params["discriminator"]),
                        "best_g": np.float32(best_g),
                        "epoch": np.int32(epoch)})
        self.save_checkpoint("lgan_final", num_epochs - 1, "lgan")
        _print(f"LGAN done; best G loss {best_g:.6f}")
        return best_g

    # ------------------------------------------------------------------
    # phase 4: RL agent
    # ------------------------------------------------------------------

    def _eval_batch(self) -> Tuple[dict, dict]:
        """The greedy eval's fixed batch: up to 64 val clouds spread evenly
        over the split (it is sorted by path, so the first 64 would be one
        category), wrap-padded to a multiple of the data axis (the padded
        rows carry pad 1), and its fixed holes (trainer.py:436-460). The
        batch is this rank's rows, the holes the global batch's."""
        val = self.val_loader.dataset.as_array()
        n_real = int(min(64, len(val)))
        spread = np.linspace(0, len(val) - 1, n_real).astype(np.int64)
        n_data = self.mesh.n_data
        n_eval = -(-n_real // n_data) * n_data
        idx = spread[np.arange(n_eval) % n_real]
        pad = (np.arange(n_eval) >= n_real).astype(np.float32)
        draws = pc_ops.draw_training_batch(
            torch.Generator(self.device).manual_seed(EVAL_HOLES_SEED),
            n_eval, val.shape[1], spec=self.preproc, augment=False,
            input_points=self.input_points)
        return self._put({"complete_pc": val[idx], "pad": pad}), draws

    def train_rl_agent(self, num_episodes: Optional[int] = None) -> float:
        """``num_episodes // envs`` iterations of ``steps.rl_step`` over
        ``envs_per_step`` parallel environments of
        min(steps_per_episode, max_steps_per_episode) steps; a greedy eval
        on the fixed batch about 20 times; ``rl_agent_best`` by the mean
        reward of the last 10 iterations (trainer.py:408-515)."""
        cfg = self.config.training.rl_agent
        num_episodes = num_episodes or cfg.episodes
        envs = min(cfg.envs_per_step, self.config.training.batch_size)
        iters = max(num_episodes // envs, 1)
        n_steps = min(max(cfg.steps_per_episode, 1),
                      cfg.max_steps_per_episode)
        updates = max(cfg.updates_per_step, 1)
        _print(f"\n=== PHASE 4: RL agent ({num_episodes} episodes = "
              f"{iters} x {envs} parallel envs) ===")
        buffer = rb.ReplayBuffer(self.config.model.rl_agent.buffer_size,
                                 self.td3.state_dim, self.td3.action_dim,
                                 self.device)
        ou = rl.ou_init(self.td3, (envs,), self.device)
        data, _ = self._resident_train_data(replicate=True)
        rng = np.random.RandomState(self.config.training.seed)
        loss_cfg = self.config.loss
        weights = dict(w_chamfer=loss_cfg.w_chamfer, w_gfv=loss_cfg.w_gfv,
                       w_discriminator=loss_cfg.w_discriminator)
        eval_batch, eval_draws = self._eval_batch()
        eval_every = max(1, iters // 20)
        best_avg = float("-inf")
        rewards = []
        start_it = 0
        rst = self._restore_train_state("rl_agent")
        if rst is not None:
            buffer_from_numpy(rst["buffer"], buffer)
            ou = torch.from_numpy(np.asarray(rst["ou"], np.float32)).to(
                self.device)
            best_avg = float(rst["best_avg"])
            start_it = int(rst["it"]) + 1
            for _ in range(start_it):  # replay the data-sampling draws
                rng.randint(0, len(data), size=envs)

        def log_eval(episode):
            m = steps.rl_eval_reward(self.model, eval_batch, eval_draws,
                                     cfg=self.td3, spec=self.preproc,
                                     mesh=self.mesh, **weights)
            r, cd = float(m["reward"]), float(m["chamfer"])
            self.rl_evals.append((episode, r, cd))
            self.logger.log_scalar("RL/Eval_Reward", r, episode)
            self.logger.log_scalar("RL/Eval_Chamfer", cd, episode)
            _print(f"  eval reward (greedy, fixed batch) @ep {episode}: "
                  f"{r:.4f}  chamfer {cd:.4f}")

        log_eval(start_it * envs)
        for it in range(start_it, iters):
            idx = torch.from_numpy(mesh_lib.local_rows(
                self.mesh, rng.randint(0, len(data), size=envs)))
            batch = {"complete_pc": data[idx.to(self.device)],
                     "pad": torch.zeros(len(idx), device=self.device)}
            draws = steps.draw_rl_step(
                self.generator, envs, data.shape[1], cfg=self.td3,
                buffer_size=min(buffer.size + envs * n_steps,
                                buffer.capacity),
                steps_per_episode=n_steps, updates_per_step=updates,
                spec=self.preproc, input_points=self.input_points)
            self.model, buffer, ou, m = steps.rl_step(
                self.model, buffer, ou, batch, draws, cfg=self.td3,
                start_training_size=cfg.start_training_steps,
                steps_per_episode=n_steps, updates_per_step=updates,
                spec=self.preproc, mesh=self.mesh, **weights)
            rewards.append(float(m["reward"]))
            self.rl_history.append({"reward": rewards[-1],
                                    "critic_loss": m["critic_loss"],
                                    "actor_loss": m["actor_loss"]})
            episode = (it + 1) * envs
            if (it + 1) % eval_every == 0 or it == iters - 1:
                log_eval(episode)
            if it % 10 == 0 or it == iters - 1:
                avg = float(np.mean(rewards[-10:]))
                for tag, value in (("Episode_Reward", rewards[-1]),
                                   ("Average_Reward", avg),
                                   ("Critic_Loss", m["critic_loss"]),
                                   ("Actor_Loss", m["actor_loss"])):
                    self.logger.log_scalar(f"RL/{tag}", float(value), episode)
                _print(f"RL iter {it + 1}/{iters} (episode {episode}) "
                      f"reward {rewards[-1]:.4f} avg {avg:.4f} critic "
                      f"{float(m['critic_loss']):.4f} actor "
                      f"{float(m['actor_loss']):.4f}")
                if avg > best_avg:
                    best_avg = avg
                    self.save_checkpoint("rl_agent_best", episode,
                                         "rl_agent")
            if (it + 1) % self._save_freq == 0:
                self.save_checkpoint(
                    f"rl_agent_episode_{episode}", episode, "rl_agent",
                    train_state={"buffer": buffer_to_numpy(buffer), "ou": ou,
                                 "best_avg": np.float32(best_avg),
                                 "it": np.int32(it)})
        self.save_checkpoint("rl_agent_final", num_episodes, "rl_agent")
        _print(f"RL done; best avg reward {best_avg:.4f}")
        return best_avg

    # ------------------------------------------------------------------
    # phase 5: joint fine-tune
    # ------------------------------------------------------------------

    def joint_training(self, num_epochs: Optional[int] = None) -> float:
        """Epochs of ``steps.joint_train_step`` over the device-resident
        train split, each validated through the hybrid gate (the config's
        gate_mode and gate_bias) on fixed holes; ``joint_best`` on the best
        val loss, ``joint_epoch_N`` every save_model_frequency epochs
        (trainer.py:516-600). With ``preserve_gan_path`` the serving GAN
        branch (G and the decoder as they are now) is first copied into
        ``gan_path``."""
        cfg = self.config.training.joint
        num_epochs = num_epochs or cfg.epochs
        _print(f"\n=== PHASE 5: joint fine-tune ({num_epochs} epochs) ===")
        if cfg.freeze_generator:
            _print("joint: generator FROZEN (phase-3 G preserved; "
                  "joint.freeze_generator)")
        if cfg.preserve_gan_path and "gan_path" not in self.model:
            # copies: Adam updates the live tensors in place
            snap = lambda tree: tree_map(  # noqa: E731
                lambda v: v.detach().clone(), tree)
            self.model["gan_path"] = {
                "generator": snap({
                    "params": self.model["lgan"]["params"]["generator"],
                    "state": self.model["lgan"]["state"]["generator"]}),
                "decoder": snap({
                    "params": self.model["ae"]["params"]["decoder"],
                    "state": self.model["ae"]["state"]["decoder"]}),
            }
            _print("joint: serving GAN branch SNAPSHOTTED (pre-joint G + "
                  "decoder; joint.preserve_gan_path)")
        trainable = steps.joint_trainable(self.model, cfg.freeze_generator)
        for v in tree_leaves(trainable):
            v.requires_grad_(True)
        optimizer = steps.make_joint_optimizer(trainable, cfg)
        best_val = float("inf")
        start_epoch = 0
        rst = self._restore_train_state("joint")
        if rst is not None:
            load_chain(optimizer, trainable, rst["opt_state"])
            best_val = float(rst["best_val"])
            start_epoch = int(rst["epoch"]) + 1
        step_kw = dict(
            cfg=self.td3, compute_dtype=self.compute_dtype, spec=self.preproc,
            bidirectional=self.bidirectional, w_ae_recon=cfg.w_ae_recon,
            selective=self.precision_selective, bn_stats=self.bn_stats,
            freeze_generator=cfg.freeze_generator,
            # the folding decoder's fine term at the alpha schedule's end
            fine_weight=self.config.training.autoencoder.alpha_values[-1],
            input_points=self.input_points)
        data, data_sharded = self._resident_train_data()
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            order, pads = self.train_loader.epoch_indices()
            self.model, m = steps.joint_train_epoch(
                self.model, optimizer, data,
                torch.from_numpy(order).long().to(self.device),
                torch.from_numpy(pads).to(self.device), self.generator,
                data_sharded=data_sharded, mesh=self.mesh, **step_kw)
            train_loss = float(m["losses"].mean())
            val_loss = self._validate_joint()
            self.joint_losses.append((train_loss, val_loss))
            self.logger.log_scalar("Joint/Train_Loss", train_loss, epoch)
            self.logger.log_scalar("Joint/Val_Loss", val_loss, epoch)
            _print(f"Joint epoch {epoch + 1}/{num_epochs} "
                  f"train {train_loss:.6f} val {val_loss:.6f} "
                  f"({time.time() - t0:.1f}s)")
            if val_loss < best_val:
                best_val = val_loss
                self.save_checkpoint("joint_best", epoch, "joint")
            if (epoch + 1) % self._save_freq == 0:
                self.save_checkpoint(
                    f"joint_epoch_{epoch + 1}", epoch, "joint", train_state={
                        "opt_state": chain_to_optax(optimizer, trainable),
                        "best_val": np.float32(best_val),
                        "epoch": np.int32(epoch)})
        _print(f"Joint done; best val loss {best_val:.6f}")
        return best_val

    def _validate_joint(self) -> float:
        """Mean hybrid-output Chamfer over the val split, fixed holes."""
        losses = []
        for i, batch in enumerate(self.val_loader):
            bsz, n = batch["complete_pc"].shape[:2]
            m = steps.joint_eval_step(
                self.model, self._put(batch),
                self._fixed_holes(JOINT_VAL_HOLES, i, bsz, n),
                cfg=self.td3, spec=self.preproc,
                bidirectional=self.bidirectional,
                gate_mode=self.config.model.gate_mode,
                gate_bias=self.config.model.gate_bias, mesh=self.mesh)
            losses.append(m["loss"])
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------
    # phase 5.5: discriminator refresh + gate calibration
    # ------------------------------------------------------------------

    def refresh_discriminator(self, num_steps: Optional[int] = None
                              ) -> float:
        """Retrain D on the post-joint GFV distribution
        (trainer.py:606-663): re-extract the clean GFVs with the fine-tuned
        encoder, then ``num_steps`` WGAN-GP D steps with a fresh Adam and
        the generator frozen (``steps.lgan_d_refresh``), real batches from
        RandomState(seed + 5), as the JAX trainer draws them. With a
        ``gan_path`` snapshot the fakes come from the snapshot's G, and the
        live model keeps only the refreshed D."""
        cfg = self.config.training.joint
        lgan_cfg = self.config.training.lgan
        m = self.config.model.lgan
        num_steps = num_steps or cfg.refresh_d_steps
        _print(f"\n=== PHASE 5.5a: discriminator refresh "
              f"({num_steps} D steps) ===")
        self.generate_gfvs()
        gfvs = self.gfvs["clean"]
        bs = lgan_cfg.batch_size or self.config.training.batch_size
        rng = np.random.RandomState(self.config.training.seed + 5)
        idx = rng.randint(0, len(gfvs), size=(num_steps, bs))
        # the real batches sharded along axis 1 (trainer.py:625-630)
        real = torch.from_numpy(
            mesh_lib.local_rows(self.mesh, gfvs[idx], axis=1)).to(self.device)
        live = self.model["lgan"]
        d_params = live["params"]["discriminator"]
        for v in tree_leaves(d_params):
            v.requires_grad_(True)
        d_opt = steps.make_gan_optimizer(d_params, lgan_cfg.discriminator_lr,
                                         lgan_cfg)
        snap = self.model.get("gan_path")
        params, state = live["params"], live["state"]
        if snap is not None:
            _print("D refresh: fakes from the PRESERVED serving generator "
                  "(joint.preserve_gan_path)")
            params = dict(params, generator=snap["generator"]["params"])
            state = dict(state, generator=snap["generator"]["state"])
        draws = [steps.draw_lgan_d(self.generator, bs, m.z_dim,
                                   m.discriminator_dims)
                 for _ in range(num_steps)]
        t0 = time.time()
        state, sm = steps.lgan_d_refresh(params, state, d_opt, real, draws,
                                         lambda_gp=lgan_cfg.lambda_gp,
                                         mesh=self.mesh)
        if snap is not None:
            state = dict(state, generator=live["state"]["generator"])
        self.model["lgan"] = {"params": live["params"], "state": state}
        d_losses = sm["d_losses"].cpu().numpy()
        self.refresh_d_losses = d_losses.tolist()
        _print(f"D refresh done in {time.time() - t0:.1f}s: loss "
              f"{d_losses[0]:.4f} -> {d_losses[-1]:.4f}")
        self.logger.log_scalar("GAN/Refresh_D_Loss", float(d_losses[-1]), 0)
        return float(d_losses[-1])

    def calibrate_gate(self) -> Dict[str, object]:
        """Sweep the gate's threshold on the val split (fixed holes) and
        write the val-Chamfer-minimising (gate_mode, gate_bias) as
        ``gate_calibration.json``, scoped to ``joint_calibrated`` and
        ``final``, the checkpoints that carry this discriminator
        (trainer.py:665-695)."""
        _print("\n=== PHASE 5.5b: gate calibration (val split) ===")
        stats = gate_lib.gate_statistics(
            self.model, self.val_loader,
            lambda i, bsz, n: self._fixed_holes(GATE_HOLES, i, bsz, n),
            cfg=self.td3, device=self.device, spec=self.preproc,
            bidirectional=self.bidirectional, mesh=self.mesh)
        report = gate_lib.calibrate_gate(stats)
        report["checkpoints"] = ["joint_calibrated", "final"]
        path = self.checkpoint_dir / gate_lib.GATE_FILE
        if mesh_lib.is_writer():
            path = gate_lib.save_gate_calibration(str(self.checkpoint_dir),
                                                  report)
        mesh_lib.barrier()
        self._gate_calibrated = True
        self.gate_report = report
        _print(f"gate: mode={report['gate_mode']} "
              f"bias={report['gate_bias']:.4f} "
              f"val chamfer {report['val_chamfer_raw_gate']:.6f} (raw) -> "
              f"{report['val_chamfer_calibrated']:.6f} (calibrated); "
              f"paths rl {report['val_chamfer_rl']:.6f} / "
              f"ae {report['val_chamfer_ae']:.6f}, "
              f"oracle {report['oracle_chamfer']:.6f} -> {path}")
        return report

    def post_joint_refresh(self) -> None:
        """Phase 5.5 when configured: on ``joint_best``, the D refresh and
        the gate calibration, saved as ``joint_calibrated``
        (trainer.py:720-733)."""
        t = self.config.training.joint
        if not (t.refresh_d_steps > 0 or t.calibrate_gate):
            return
        self.load_checkpoint("joint_best")
        self._resume = None  # not a mid-phase resume
        if t.refresh_d_steps > 0:
            self.refresh_discriminator(t.refresh_d_steps)
        if t.calibrate_gate:
            self.calibrate_gate()
        self.save_checkpoint("joint_calibrated", self.epoch, "joint")

    # ------------------------------------------------------------------
    # the curriculum
    # ------------------------------------------------------------------

    def train_full_pipeline(self, start_phase: Optional[str] = None) -> None:
        """Phases 1-5 and 5.5, then ``final`` (trainer.py:697-718). From a
        loaded checkpoint the phases before the one it records are skipped
        and training restarts at that phase (``start_phase=None``)."""
        t = self.config.training
        order = ("autoencoder", "lgan", "rl_agent", "joint")
        start_idx = order.index(start_phase or self.current_phase)
        if start_idx > 0:
            _print(f"resuming pipeline at phase {order[start_idx]!r}")
        if start_idx <= 0:
            self.train_autoencoder(t.autoencoder.epochs)
            self.generate_gfvs()
        if start_idx <= 1:
            self.train_latent_gan(t.lgan.epochs)
        if start_idx <= 2:
            self.train_rl_agent(t.rl_agent.episodes)
        if start_idx <= 3 and t.joint.enabled:
            self.joint_training(t.joint.epochs)
            self.post_joint_refresh()
        _print("\n=== TRAINING COMPLETE ===")
        self.save_checkpoint("final", self.epoch, "joint")

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, name: str, epoch: int, phase: str,
                        train_state: Optional[dict] = None) -> None:
        """{"model": {"ae", "lgan", "agent"}, "meta": {"epoch",
        "phase_idx"}} as a pickle of numpy arrays, the JAX trainer's layout
        (trainer.py:735-778 with use_orbax=False): the agent whole, with
        its targets, step and optax Adam states. A ``gan_path`` snapshot
        goes to the ``<name>_ganpath`` sibling and ``train_state`` to the
        ``<name>_trainstate`` sibling. Whatever stands at those three paths
        goes first, file or directory (a JAX orbax run's, resumed in
        place), so a sibling this save does not write outlives no
        checkpoint it belonged to. Unless this run calibrated the gate,
        ``name`` is first taken out of a gate sidecar's scope. Rank 0 alone
        writes, the column-sharded leaves gathered whole, and every rank
        waits for the files at a barrier."""
        model = dict(mesh_lib.gather_model(self.mesh, self.model))
        if not mesh_lib.is_writer():
            mesh_lib.barrier()
            return
        if not self._gate_calibrated:
            gate_lib.descope_gate_calibration(str(self.checkpoint_dir), name)
        gan_path = model.pop("gan_path", None)
        main = {"model": optax_layout(model_to_numpy(model)),
                "meta": {"epoch": np.int32(epoch),
                         "phase_idx": np.int32(PHASES.index(phase))}}
        if gan_path is not None:
            gan_path = model_to_numpy(gan_path)
        for suffix, tree in (("", main), ("_ganpath", gan_path),
                             ("_trainstate", train_state)):
            path = self.checkpoint_dir / (name + suffix)
            ckpt_lib.remove_checkpoint(path)
            if tree is not None:
                ckpt_lib.save_checkpoint(str(path), tree)
        mesh_lib.barrier()

    def load_checkpoint(self, name: str) -> Tuple[int, str]:
        """Restore the model (``ae``, ``lgan``, the agent and the
        ``<name>_ganpath`` sibling when there is one) from a checkpoint of
        this package or the JAX package, pickle or orbax directory. The
        agent comes back whole: networks, targets, step and Adam moments.
        The checkpoint's phase becomes ``current_phase``, where
        ``train_full_pipeline`` restarts, and that phase restores the
        ``<name>_trainstate`` sibling when it starts."""
        model, meta = ckpt_lib.load_model_checkpoint(str(self.checkpoint_dir),
                                                     name)
        cpu = torch.device("cpu")
        a = model["ae"]
        self.model = {**model_from_numpy(model, device=self.device),
                      "agent": agent_from_numpy(model["agent"], self.td3,
                                                device=self.device),
                      "ae": self._on_device(tree_from_numpy(a["params"], cpu),
                                            tree_from_numpy(a["state"], cpu))}
        # placed on the mesh again (trainer.py:806)
        self.model = mesh_lib.shard_model_for_mesh(self.mesh, self.model)
        epoch = int(meta["epoch"])
        phase = PHASES[int(meta["phase_idx"])]
        self.current_phase = phase
        self._resume = {"name": name, "phase": phase, "epoch": epoch}
        _print(f"loaded checkpoint {self.checkpoint_dir / name} "
              f"(epoch {epoch}, phase {phase})")
        return epoch, phase

    def _restore_train_state(self, phase: str) -> Optional[dict]:
        """The ``_trainstate`` sibling of the checkpoint last loaded, when
        it is ``phase``'s and exists (pickle or orbax directory, either
        package's), as a numpy tree; consumed once, so a later phase
        starts fresh (trainer.py:814-831)."""
        if not self._resume or self._resume["phase"] != phase:
            return None
        resume, self._resume = self._resume, None
        path = self.checkpoint_dir / (resume["name"] + "_trainstate")
        if not path.exists():
            _print(f"no train state at {path}: {phase} starts from its first "
                  "epoch with a fresh optimizer")
            return None
        state = ckpt_lib.load_checkpoint(str(path))
        _print(f"restored {phase} train state from {path} "
              f"(epoch {resume['epoch']})")
        return state

    def close(self) -> None:
        """Close the metrics log (trainer.py:832-833)."""
        self.logger.close()
