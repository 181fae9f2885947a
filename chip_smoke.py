#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gan_rl_3d_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each failing the run if it fails:
  1. device: require CUDA, print the card's name and power limit, build
     every kernel from csrc/ with nvcc (sm_90a), one process per source,
     and print each kernel's registers, stack and spills (no instance of
     K1, K6, K3 or K2 may spill); build the host data loader
     (runtime/cpp/loader.cpp) with g++ and print its seconds;
  2. kernels vs their plain PyTorch versions at the main paths' shapes
     (B=64, N=M=2048, masked and unmasked): every instance of K1 (f32; bf16
     on the tensor cores and on the CUDA cores, also at odd widths with a
     fully masked cloud, at B=1, and above 256 for the CUDA-core one; f32
     and the tensor-core bf16 at B=65,537), K2-K5 at B=65,537 (N=M=16),
     K6 bit for bit (also at B=3, N=1500 with a fully masked cloud, at
     ragged widths, after an in-place weight edit, at every width list of
     INT8_WIDTHS through the instance its widths pick, and its wide
     instance at the main shapes), K3, K2 (also: K2's distances equal
     K3's bit for bit, a mask of ones equals no mask, exact duplicates
     within a sub-tile and across the sub-tile and tile boundaries give
     the first copy, ragged shapes with a fully masked cloud); K4 (gather)
     and K5
     (scatter), K5 bit for bit, also on adversarial targets (all on one,
     all distinct, M > N, N > M, past shared memory, B=2 with
     N=M=20000) and twice for identical bits; the Chamfer gradient by the
     kernels against the same autograd Function on CPU copies;
  3. the serving path at full width: the flagship config with random
     weights from a fixed seed, ``complete`` against ``complete_fast``
     (f32, all gate modes), the bf16 engine against f32, the int8 engine
     against f32 and ``complete`` (all gate modes), f32 and int8 engine
     files served by ``gan_rl_3d_tpu_torch.complete_clouds --engine`` on
     .txt and .ply clouds, and the completions scored by
     ``evaluate_completion``; K1, K6, K3 and K2 must launch in this phase;
  4. the training path at full width: a synthetic dataset written by the
     port, ``RLGANNetTrainer(...).train_autoencoder()`` for 2 epochs of
     2 steps at B=64 with the flagship recipe (bf16_selective), every
     loss finite, K3, K4 and K5 launched, the best checkpoint reloaded;
     then one f32 ``ae_train_step`` at B=8 on the card against the same
     step on the CPU (same weights and draws, K3's near-tie picks shared):
     loss and every gradient;
     then mid-phase resume: ``train_rl_gan_net --phase autoencoder
     --resume autoencoder_epoch_1`` runs epoch index 1 alone from the
     ``_trainstate`` sibling, whose Adam moments load onto the card bit
     for bit at the saved step; without the sibling it starts fresh;
     then the serving side on that checkpoint: ``gan_rl_3d_tpu_torch.
     evaluate --checkpoint autoencoder_best --export-engine``, and
     ``complete_clouds --checkpoint`` and ``--engine`` (the exported
     engine) on a few files (K3 and K2 must launch);
  5. phases 2-4 of the curriculum at full width from phase 1's
     checkpoint, through the trainer the CLI calls (``--phase lgan
     --resume autoencoder_best``, ``--phase rl_agent``): GFV extraction
     over the train split, 1 epoch of the latent WGAN-GP at the recipe
     (batch 16, 3 D steps a G step, z 8), 6 RL iterations at the recipe
     (64 environments, 1-step episodes, 64 TD3 updates an iteration from
     256 transitions on, so 192 updates; the critic warmup cut to 96 and
     the ramp to 24 so the actor updates), finite losses and rewards, the
     actor changed, K3 launched in the reward, ``rl_agent_final``
     reloaded bit for bit into a fresh trainer and ``complete`` run on it;
     then one ``lgan_combined_step``, one ``agent_update`` and one
     ``rl_step`` (64 updates, from the agent after two more TD3 updates
     on the CPU) on the card against the same on CPU copies, with the same
     draws;
  6. phases 5 and 5.5 at full width from ``rl_agent_final``, through the
     trainer as ``--phase joint`` drives it: the recipe's joint block
     (bf16_selective, B=64, lr 1e-4, weight decay 1e-5, w_ae_recon 1)
     cut to 1 epoch of 2 steps, then the D refresh (16 steps, the
     recipe's 400) and the gate calibration on the val split; finite
     losses, ``joint_best``, ``joint_calibrated`` and the sidecar scoped
     to them and ``final``, the calibrated gate no worse than a fixed one,
     only D changed by the refresh; then the default command
     ``train_rl_gan_net --phase full --resume rl_agent_final`` (phases
     1-3 skipped, ``final`` written) and the calibrated ``final`` served
     by ``evaluate --export-engine`` and ``complete_clouds --checkpoint``
     / ``--engine``, each printing and using the sidecar's gate; K1-K5
     must launch on this path; then one f32 ``joint_train_step`` at B=8
     and one ``gate_stats_step`` on the card against CPU copies;
  7. the repo's trained weights, the JAX trainer's orbax directories
     under runs/best7/probe_lgan30/ckpt_lgan30, copied and read by the
     port's own reader (zstd, OCDBT, zarr v2; the load seconds printed):
     350 arrays, ``lgan_best``'s meta, its GFVs against a random init's;
     the f32, bf16 and int8 engines on ``lgan_best`` at B=64, N=2048
     against the serving limits, each error beside the random weights';
     ``evaluate --checkpoint lgan_best --export-engine``,
     ``complete_clouds --checkpoint`` and ``--engine``; ``joint_checks``
     on its weights; K1 (f32 and bf16), K6, K2, K3, K4, K5 must launch
     (the ``trained`` path);
  8. the data path on best7's dataset regenerated at full size: ``python -m
     gan_rl_3d_tpu_torch.setup_dataset --synthetic --samples-per-category
     1600 --test`` (12,800 / 3,200 / 3,200 clouds; its seconds and bytes),
     each split cached at config_lgan30's 2 workers (seconds), 64 clouds a
     split equal to their files' rows as sets, bit for bit, the 8-group
     shard-aligned plan inside its row groups; the committed
     ``autoencoder_best`` (epoch 191) validated by the trainer on the val
     split, within 1% of the JAX package's f32 figure 0.024710 (K3 must
     launch: the ``data`` path), two other hole streams reading other
     means, and with the Chamfer cross term's operands in bf16 within 1%
     of the TPU's published 0.022436; ``generate_gfvs`` over the train
     split matched order-free and one to one with the committed clean
     GFVs (largest gap 3e-2, 99.9th percentile 2e-2, median 1e-2 of the
     committed set's largest element); ``python -m
     gan_rl_3d_tpu_torch.test_rl_gan_net`` on the card;
  9. times: each kernel (every instance of K1 and K6 at the flagship
     widths), its plain version, the least time the card could take
     (bound) and a library yardstick (registers a thread and shared memory
     beside their times; K3 and K2 also as CUDA-graph device time, with
     R and C), at B=64 (and
     B=4096 for the serving kernels, B=512 for K4 and K5), the time per
     ``complete_fast`` call at B=64 and B=4096 (f32, bf16 and int8 engines), and per
     ``ae_train_step`` at B=64 in f32 and bf16_selective, with a
     torch.profiler trace of the step (device busy time, idle share,
     launches, top kernels); the same for ``lgan_combined_step``,
     ``agent_update`` and ``rl_step``, with K3's share of the RL step;
     per ``joint_train_step`` at B=64 in f32 and bf16_selective with its
     trace and K3/K4/K5's share, per D refresh step, per
     ``gate_stats_step`` batch; per variant ``ae_train_step`` (the
     attention encoder and adaptive decoder) at B=64 in f32 and
     bf16_selective with its trace, per unfolded variant ``complete`` at
     B=64 and B=4096;
  10. the variant family (runs/variant/config_variant.yaml's model block:
     the attention encoder, the adaptive decoder with its refinement) at
     the flagship widths, random weights from seed 0: the whole
     curriculum through ``train_rl_gan_net --phase full --profile`` at
     the recipe (bf16_selective) cut as the joint path is (AE 1 epoch of
     2 steps at B=64, 1 LGAN epoch of 8 steps, 2 RL iterations, joint 1
     epoch of 2 steps, 16 D refresh steps); its metrics.jsonl holds the
     AE/*, GAN/*, RL/*, Joint/* tags, its profile names K3's kernel,
     ``final`` and the gate sidecar are written; ``final`` served by
     ``complete_clouds --checkpoint`` and ``evaluate``; K3, K4, K5 and
     K2 must launch (the ``variant`` path); the engine fold and
     ``--export-pth`` refuse the family; one f32 variant
     ``ae_train_step`` and ``joint_checks`` on its ``final``, card
     against CPU from Adam moments one step old, lr 0 failing; then the
     reference .pth bridge on the joint path's ``final``: ``evaluate
     --export-pth``, ``load_reference_checkpoint``, ``complete`` bit for
     bit on the card;
  11. the multi path, the ("data", "model") mesh over torch.distributed
     (run after phase 8): (a) ``python -m torch.distributed.run
     --nproc-per-node 1`` runs this script's ``--torchrun-child`` mode,
     which drives the training CLI over the whole curriculum cut as the
     variant path is, on NCCL at world size 1; its ``final`` equals a
     plain one-process run's bit for bit; one ``ae_train_step`` and one
     ``joint_train_step`` at B=64 timed on both routes, with the
     collectives a step and the device time from a torch.profiler trace;
     (b) 2 and 4 ranks sharing the one card over gloo (the port stages
     CUDA tensors through host memory for gloo): from the same weights and
     draws, 3 ``ae_train_step``s in both BN modes (each from the
     one-process state before it), one ``lgan_combined_step``, one
     ``rl_step`` of 64 environments, one ``joint_train_step`` (and at 4
     ranks the same on a 2x2 mesh, the decoder head column-sharded) and
     DP serving of the f32 engine, held against the one-process run on the
     card (losses 1e-4 relative; each network's update 1e-2 of the one
     process's in the 2-norm, the joint step's 5e-2 as in phase 6; Adam's
     noise leaves 2 lr an update; lr 0 must fail; serving 1e-5); K1, K3, K4
     and K5 must launch on the path (every rank's and (a)'s launches);
     step times per rank count, not a scaling figure; (c) the same over
     NCCL when two or more cards are visible, else one line saying why
     not;
  12. the training BatchNorm + ReLU op (ops/bn_train.py) at each
     activation shape of the attn-adaptive-train-ae cell's step (B=2048,
     N=2048): against the composite it replaces, twice for identical
     bits, its forward and backward beside their byte bounds and the
     composite's time; then one f32 AE step (the flagship) and one variant
     AE step and one joint step on fresh weights, card against CPU, lr 0
     and twice the lr failing the last two (run before the times of 9).

The next-to-last line is a JSON object describing every kernel; the last
line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on
# the tensor cores, HBM3 bandwidth. They assume the full 700 W limit.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

TOL_F32 = 1e-4      # f32 kernel / engine vs plain, scaled by max(1, |ref|)
TOL_BF16 = 2e-2     # bf16 vs its reference, relative to max |ref|
# K6 vs its plain version: equal bit for bit (torch.equal), since the int32
# sums are exact in any order and every rounding step is the plain version's
# the int8 engine against f32: the GFV within 2e-2 of its largest element
# (the JAX package's pooled-feature bound, test_fused_encoder.py:98-100),
# clouds within 0.1 of the unfolded complete (test_fused_encoder.py:119-121)
TOL_INT8_GFV = 2e-2
TOL_INT8_PC = 0.1
# on the trained lgan_best the JAX package's own int8 engine reads 2.2749e-2
# of f32 (tests/test_torch_port_orbax.py::test_trained_int8_engine_matches_
# jax holds the port's to it): the limit sits just above that reading
TOL_INT8_GFV_TRAINED = 2.4e-2
# the int8 engine on the card against the same engine on the CPU, of the
# largest element: the int32 sums are exact, and only a last-bit difference
# of a row's f32 scale can move an int8 level (1.165e-6 read on lgan_best)
TOL_INT8_CARD = 1e-4
# the repo's trained weights: orbax directories the JAX trainer wrote
TRAINED_DIR = (Path(__file__).resolve().parent / "runs" / "best7"
               / "probe_lgan30" / "ckpt_lgan30")
TRAINED_ARRAYS = 350
# the data path: best7's dataset regenerated (setup_dataset --synthetic
# --samples-per-category 1600, seed 0; runs/best7/RESULTS.md:8-12): 12,800
# train, 3,200 val, 3,200 test clouds; clouds per split held to their files
DATA_SAMPLES = 1600
DATA_CHECKED = 64
# autoencoder_best's val Chamfer on that split: the JAX package's own f32
# figure on the CPU (its holes, PRNGKey(0) folded per batch), and the TPU's
# published one (runs/ae_frontier/ae_cos200.log:199), whose K3 takes the
# cross term -2a.b in one bf16 pass; each held within 1% (the card's holes
# are its own: over 3,200 clouds other draws moved the mean by 0.03%)
VAL_F32_JAX, VAL_BF16_TPU, TOL_VAL = 0.024710, 0.022436, 1e-2
# the card's clean train GFVs against the committed ones (the TPU's bf16
# products; gfv/gfvs_train.npz in best7's shuffle), matched order-free:
# each pair's largest difference as a share of the committed set's largest
# element (the port on a CPU read 2.195e-2 / 1.509e-2 / 4.57e-3)
TOL_GFV_MAX, TOL_GFV_P999, TOL_GFV_MEDIAN = 3e-2, 2e-2, 1e-2
TOL_DIST = 1e-3     # |a|^2+|b|^2-2ab cancellation in f32
TIE_GAP = 1e-4      # squared-distance gap below which an index may differ
# K4 vs plain, scaled by max(1, |ref|): K4 rounds as its plain version does
# (K5 and its plain version sum in the same order and must be equal)
TOL_GRAD_KERNEL = 1e-5
# Chamfer gradient, card vs CPU copies, relative to the largest element:
# K3's distances differ from the plain version's in the last bits (another
# order of |a|^2 + |b|^2 - 2ab), and g / dist carries that into da
TOL_CHAMFER_GRAD = 1e-4
# one f32 AE step, card vs CPU: cuBLAS and the CPU's BLAS sum in other
# orders, and at a random init a nearest-neighbour near-tie can flip under
# last-bit differences of the reconstruction, which moves that point's
# gradient (such a flip measured 4.3e-4 of the largest gradient element
# between the JAX package and the port on the CPU); relative to the
# largest gradient element, and to the loss
TOL_STEP_GRAD = 2e-3
TOL_STEP_LOSS = 1e-4
B_MAIN, N_MAIN = 64, 2048
B_BIG = 4096
B_GRAD_BIG = 512
B_STEP_CHECK = 8
BIG_BATCH = 65537   # one more cloud than a grid's y dimension holds
INT8_RAGGED = (3, 20, 36, 100, 8)  # K6 widths off every multiple of 32
INT8_FLAGSHIP = (64, 128, 128, 256, 128)  # K6's compile-time instance
# width lists every instance of K1 and K6 must take (K6: two on the
# mma.sync instance, three on the wide one)
INT8_WIDTHS = ((3, 24, 40, 72, 200, 8), (3, 64, 512, 128), (3, 512, 512, 96),
               (3, 907, 907, 8), (3, 100))
INT8_DIVIDE_PAIRS = 1 << 31  # K6's divide against __fdiv_rn (about 0.5 s)
# K3/K2: (N, M) off every tile boundary, checked at B=3 against the plain
# version; pairs (j, j') with b[j'] = b[j] within one 8-point sub-tile, and
# straddling the sub-tile and the 256-point tile boundaries (M = 2048)
NN_RAGGED = ((1, 1), (7, 3000), (1001, 777), (2048, 2048))
NN_TIES = ((5, 11), (250, 260), (252, 253), (255, 256), (678, 690),
           (1020, 1030), (1000, 1500), (0, 2047))
TRACE_STEPS = 5     # ae_train_steps traced by torch.profiler
TRACE_TOP = 12      # kernels listed by their device time
# phases 2-4, card against CPU with the same draws and the same start
# (cuBLAS and the CPU's BLAS sum in other orders, as for the AE step):
# losses and rewards relative to the CPU's; each network's update (new
# parameters - start) in the 2-norm relative to the CPU's update, so that
# a step that skipped the optimizer or took the wrong lr reads about 1;
# state leaves (BN variances, spectral-norm vectors), buffer rows and the
# OU state relative to their own largest element. Adam divides each
# gradient element by its own RMS, and the biases ahead of a training
# BatchNorm have a true gradient of 0 (the BN subtracts them again), so
# their last-bit gradients become steps of up to lr either way: those
# biases and the BN running means that take them in (adam_noise) are
# held to 2 lr an update, absolute (tests/test_torch_port_rl.py and
# tests/test_torch_port_lgan.py measure this against JAX).
TOL_RL_LOSS = 1e-4
TOL_GATE_MARGIN = 1e-5  # D(clean) - D(noisy), of the largest margin
# one joint step (B=8), each network's update card vs CPU in the 2-norm:
# not TOL_RL_UPDATE. The step is conditioned worse than the phase 3-4
# steps: the decoder's training BatchNorm divides by the spread of G's
# outputs over 8 rows, the max-pool and the Chamfer loss pick one point
# each, and Adam divides each element by its own RMS, so the CPU's own
# update moves by about 1e-2 when the input clouds are scaled by 1 + 1e-7
# (joint_checks prints this floor each run: 6.8e-3, 1.36e-2, 1.29e-2 on
# an H100 80GB HBM3 at 700 W, against the card's 8.8e-3, 1.79e-2,
# 1.57e-2). A step with lr 0 or twice the lr reads 1.
TOL_JOINT_UPDATE = 5e-2
TOL_RL_UPDATE = 1e-2
TOL_RL_PARAM = 2e-3
RL_ITERS = 6        # iterations of train_rl_agent: 256 transitions at the
                    # 4th, so iterations 4-6 run 64 TD3 updates each
RL_WARMUP, RL_RAMP = 96, 24  # the recipe's 2000 / 1500, cut to the run
RL_PREFILL = 256    # buffer rows before the rl_step checked and timed
TRACE_RL = 2        # rl_steps traced (64 updates each)
# phases 5 and 5.5 at the shipped recipe's joint block (bf16_selective,
# B=64, lr 1e-4, weight decay 1e-5, w_ae_recon 1, calibrate_gate), cut to
# the run: 1 epoch (the recipe's 4) of 2 steps on the 128 synthetic train
# clouds, and 16 D refresh steps (the recipe's 400)
JOINT_EPOCHS = 1
JOINT_REFRESH = 16
TRACE_JOINT = 5     # joint_train_steps traced per precision
# the variant family (runs/variant/config_variant.yaml's model block) at
# the flagship widths through the whole curriculum, cut as the joint path:
# 2 RL iterations (128 transitions, under the recipe's 256 before the
# first TD3 update)
VARIANT_TYPES = {"encoder_type": "attention", "decoder_type": "adaptive"}
VARIANT_RL_ITERS = 2
TRACE_VARIANT = 5   # variant ae_train_steps traced per precision


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def scaled_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max(1, max |ref|): absolute for O(1) outputs."""
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / max(1.0, float(ref.abs().max())))


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / ref.abs().max())


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _bn_mlp(rng, d_in, dims, final_plain=False, xavier=False):
    params, state = [], []
    for i, d_out in enumerate(dims):
        bound = (np.sqrt(6.0 / (d_in + d_out)) if xavier
                 else 1.0 / np.sqrt(d_in))
        p = {"dense": {"w": rng.uniform(-bound, bound, (d_in, d_out)),
                       "b": rng.uniform(-1 / np.sqrt(d_in), 1 / np.sqrt(d_in),
                                        d_out)}}
        s = {}
        if not (final_plain and i == len(dims) - 1):
            p["bn"] = {"scale": rng.uniform(0.8, 1.2, d_out),
                       "bias": rng.uniform(-0.1, 0.1, d_out)}
            s["bn"] = {"mean": rng.uniform(-0.1, 0.1, d_out),
                       "var": rng.uniform(0.5, 2.0, d_out)}
        params.append(p)
        state.append(s)
        d_in = d_out
    return params, state


def init_numpy_model(config, seed: int = 0) -> dict:
    """A model tree in the JAX package's layout (numpy leaves) with random
    weights from ``seed``: torch-default weight ranges, BN running
    statistics jittered around the init values (mean 0, var 1) so folding
    is exercised, and spectral-norm u, v set to the top singular vectors,
    as the power iteration leaves them."""
    rng = np.random.RandomState(seed)
    m = config.model
    a, g, r = m.autoencoder, m.lgan, m.rl_agent
    enc_p, enc_s = _bn_mlp(rng, a.input_dim, a.encoder_dims)
    head_p, head_s = _bn_mlp(rng, a.encoder_dims[-1], [a.latent_dim])
    dec_p, dec_s = _bn_mlp(rng, a.latent_dim, a.decoder_dims, final_plain=True)
    gen_p, gen_s = _bn_mlp(rng, g.z_dim, g.generator_dims, final_plain=True)
    act_p, act_s = _bn_mlp(rng, r.state_dim,
                           list(r.hidden_dims) + [r.action_dim],
                           final_plain=True, xavier=True)
    d_layers_p, d_layers_s = [], []
    d_in = g.latent_dim
    for i, d_out in enumerate(g.discriminator_dims):
        bound = 1.0 / np.sqrt(d_in)
        w = rng.uniform(-bound, bound, (d_in, d_out))
        p = {"dense": {"w": w, "b": rng.uniform(-bound, bound, d_out)}}
        if i < len(g.discriminator_dims) - 1:
            p["ln"] = {"scale": rng.uniform(0.8, 1.2, d_out),
                       "bias": rng.uniform(-0.1, 0.1, d_out)}
        left, _, right = np.linalg.svd(w, full_matrices=False)
        d_layers_p.append(p)
        d_layers_s.append({"sn": {"u": right[0], "v": left[:, 0]}})
        d_in = d_out
    tree = {
        "ae": {"params": {"encoder": {"point_mlp": enc_p, "head": head_p},
                          "decoder": {"mlp": dec_p}},
               "state": {"encoder": {"point_mlp": enc_s, "head": head_s},
                         "decoder": {"mlp": dec_s}}},
        "lgan": {"params": {"generator": {"mlp": gen_p},
                            "discriminator": {"layers": d_layers_p}},
                 "state": {"generator": {"mlp": gen_s},
                           "discriminator": {"layers": d_layers_s}}},
        "agent": {"actor": {"params": {"mlp": act_p},
                            "state": {"mlp": act_s}}},
    }
    return _as_f32(tree)


def _as_f32(tree):
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_f32(v) for v in tree]
    return np.asarray(tree, np.float32)


def make_clouds(bsz: int, n: int, seed: int, device) -> tuple:
    """Complete clouds on noisy ellipsoid surfaces, and masks that cut a
    random share of each cloud (the padded tail the serving CLI produces)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(bsz, n, 3, generator=g, device=device)
    x = x / x.norm(dim=-1, keepdim=True)
    axes = 0.4 + 0.6 * torch.rand(bsz, 1, 3, generator=g, device=device)
    pc = x * axes + 0.01 * torch.randn(bsz, n, 3, generator=g, device=device)
    keep = torch.randint(n // 2, n + 1, (bsz, 1), generator=g, device=device)
    mask = (torch.arange(n, device=device)[None, :] < keep).float()
    return pc.contiguous(), mask


def timed_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def graph_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Device time per call of a short kernel: ``reps`` calls captured in
    one CUDA graph and replayed, so the host's per-call work (argument
    checks, allocation, the ctypes call) is left out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return timed_ms(graph.replay, reps=1, repeats=repeats) / reps


def chunked(fn, bsz: int, chunk: int):
    """fn(lo, hi) over batch chunks: the plain distance versions and the
    library call materialise (B, N, M), too large to hold at B=4096."""
    def run():
        for lo in range(0, bsz, chunk):
            fn(lo, min(bsz, lo + chunk))
    return run


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def ptxas_report(log: str) -> dict:
    """nvcc -Xptxas -v output -> {kernel: "N registers, F B stack frame, S
    B spill stores, L B spill loads"}, with the template arguments of K1
    (encoder_pool_kernel<tile, bf16, masked>), K1 bf16's tensor-core
    instance, K6's instances and K5 spelled out."""
    names = (
        (r"encoder_pool_kernelILi(\d+)ELb(\d)ELb(\d)E",
         "encoder_pool_kernel<{}, bf16={}, masked={}>"),
        (r"encoder_pool_bf16_kernelILb(\d)ELb(\d)E",
         "encoder_pool_bf16_kernel<masked={}, flagship={}>"),
        (r"encoder_pool_int8_kernelILb(\d)ELb(\d)E",
         "encoder_pool_int8_kernel<masked={}, flagship={}>"),
        (r"encoder_pool_int8_wide_kernelILb(\d)E",
         "encoder_pool_int8_wide_kernel<masked={}>"),
        (r"scatter_kernelILb(\d)E", "scatter_kernel<shared={}>"),
        (r"nn_kernelILb(\d)ELb(\d)E", "nn_kernel<keep_idx={}, masked={}>"),
        (r"\d+(pool_init|pool_decode|[a-z_]+_kernel)", "{}"))
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            for pattern, form in names:
                k = re.search(pattern, fn)
                if k:
                    fn = form.format(*k.groups())
                    break
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = (f"{m.group(1)} B stack frame, {m.group(2)} B spill "
                       f"stores, {m.group(3)} B spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, " + out.get(fn, "")
            fn = None
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on a GPU only")
    from gan_rl_3d_tpu_torch import runtime
    from gan_rl_3d_tpu_torch.device import resolve_device
    from gan_rl_3d_tpu_torch.ops import _cuda

    device = resolve_device("cuda")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _cuda.build()
    print(f"built {sorted(_cuda.SOURCES)} in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    runtime.build()
    print(f"built the data loader ({runtime.SOURCE.name}, g++ "
          f"{' '.join(runtime.CXX_FLAGS)}) in {time.perf_counter() - t0:.2f}s")
    for name in _cuda.SOURCES:
        for fn, info in ptxas_report(_cuda.build_log(name)).items():
            print(f"  {name} {fn}: {info}")
            expect(not fn.startswith(NO_SPILL)
                   or "0 B spill stores, 0 B spill loads" in info,
                   f"{fn} spills: {info}")
    torch.cuda.synchronize()
    return device


def _k1_case(x, layers, m, dtype, what):
    """K1 against its plain version on one input: the same -inf, within
    TOL_F32 scaled (f32) or TOL_BF16 relative (bf16) elsewhere. Returns
    (the instance that ran, differing elements, the largest absolute
    error, the output)."""
    from gan_rl_3d_tpu_torch.ops import _cuda, encoder_kernel as ek

    before = _cuda.launch_counts.copy()
    out = ek.fused_encoder_pool(x, layers, m, compute_dtype=dtype)
    ran = [k for k, v in _cuda.launch_counts.items() if v > before[k]]
    ref = ek.fused_encoder_pool_plain(x, layers, m, compute_dtype=dtype)
    fin = torch.isfinite(ref)
    expect(out.shape == ref.shape and len(ran) == 1
           and torch.equal(torch.isneginf(out), torch.isneginf(ref))
           and bool(fin.any()), f"K1 {what} {dtype}: bad output ({ran})")
    e = (scaled_err(out[fin], ref[fin]) if dtype == torch.float32
         else rel_err(out[fin], ref[fin]))
    expect(e <= (TOL_F32 if dtype == torch.float32 else TOL_BF16),
           f"K1 {what} {dtype}: err {e:.3e}")
    return (ran[0], int((out != ref).sum()),
            float((out[fin] - ref[fin]).abs().max()), out)


def odd_width_k1(device):
    """K1 on engines of odd widths against the plain version, each instance
    picked by the widths: (3, 24, 40, 72, 200, 8) (f32 on the CUDA cores,
    bf16 on the tensor cores) at N=1000, masked, at B=1 and at B=3 with a
    fully masked cloud (-inf); and (3, 64, 512, 128), past the tensor-core
    instance's 256, through the CUDA-core bf16 instance at N=700 the same
    way. Returns the largest absolute error of each instance."""
    errs = {}
    for dims, n, dtypes in (((3, 24, 40, 72, 200, 8), 1000,
                             (torch.float32, torch.bfloat16)),
                            ((3, 64, 512, 128), 700, (torch.bfloat16,))):
        g = torch.Generator(device="cpu").manual_seed(17)
        layers = [((torch.rand(k, c, generator=g) * 2 - 1) / k ** 0.5,
                   (torch.rand(c, generator=g) * 2 - 1) * 0.1)
                  for k, c in zip(dims[:-1], dims[1:])]
        pc, mask = make_clouds(3, n, seed=18, device=device)
        mask[1] = 0.0
        for dtype in dtypes:
            lay = [(w.to(device, dtype), b.to(device, dtype))
                   for w, b in layers]
            for x, m in ((pc[:1], mask[:1]), (pc, mask)):
                ran, n_diff, err, out = _k1_case(x, lay, m, dtype,
                                                 f"widths {dims}")
                errs[ran] = max(errs.get(ran, 0.0), err)
            expect(bool(torch.isneginf(out[1]).all()),
                   "K1: a fully masked cloud is not -inf")
            tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
            print(f"{ran} at widths {dims}, N={n}, masked, B=1 and B=3 "
                  f"with a fully masked cloud: {n_diff} of {out.numel()} "
                  f"elements differ from the plain version, max abs err "
                  f"{err:.3e} (tol {tol:g}); the masked cloud is -inf")
    return errs


def _int8_case(x, qenc, m, what):
    """K6 against its plain version, bit for bit: (differing elements,
    elements, the output)."""
    from gan_rl_3d_tpu_torch.ops import encoder_kernel as ek

    out = ek.fused_encoder_pool_int8(x, qenc, m)
    ref = ek.fused_encoder_pool_int8_plain(x, qenc, m)
    n_diff = int((out != ref).sum())
    expect(out.shape == ref.shape and torch.equal(out, ref),
           f"encoder_pool_int8 {what}: {n_diff} of {ref.numel()} elements "
           "differ from the plain version (expected 0)")
    return n_diff, out.numel(), out


def int8_checks(device, qenc, pc, mask):
    """K6 against its plain version with torch.equal: the main path's
    shapes masked and unmasked, B=3 at N=1500 with a fully masked cloud,
    the ragged widths INT8_RAGGED at N=1000 (B=1, and B=3 with a fully
    masked cloud), a call after an in-place edit of one wq (the memo
    repacks), every width list of INT8_WIDTHS at N=1000 through the
    instance its widths pick (B=3, masked with a fully masked cloud, and
    unmasked), and the wide instance at the main path's shapes; and K6's
    divide against the IEEE one on INT8_DIVIDE_PAIRS quotients. Returns
    the largest absolute difference (0)."""
    from gan_rl_3d_tpu_torch.ops import _cuda, encoder_kernel as ek
    from gan_rl_3d_tpu_torch.ops.quantize import quantize_encoder

    rpc, rmask = make_clouds(3, 1500, seed=9, device=device)
    rmask[0] = 0.0  # a fully masked cloud pools to -inf
    n_diff, n_all = 0, 0
    for x, m in ((pc, None), (pc, mask), (rpc, None), (rpc, rmask)):
        d, n, out = _int8_case(x, qenc, m, f"B={x.shape[0]}")
        n_diff, n_all = n_diff + d, n_all + n
    expect(bool(torch.isneginf(out[0]).all()),
           "encoder_pool_int8: a fully masked cloud is not -inf")
    g = torch.Generator(device="cpu").manual_seed(19)
    ragged = quantize_encoder([
        ((torch.rand(k, c, generator=g) * 2 - 1) / k ** 0.5,
         (torch.rand(c, generator=g) * 2 - 1) * 0.1)
        for k, c in zip(INT8_RAGGED[:-1], INT8_RAGGED[1:])])
    ragged = {"layer0": tuple(x.to(device) for x in ragged["layer0"]),
              "layers_q": [tuple(x.to(device) for x in layer)
                           for layer in ragged["layers_q"]]}
    qpc, qmask = make_clouds(3, 1000, seed=20, device=device)
    qmask[2] = 0.0
    for x, m in ((qpc[:1], qmask[:1]), (qpc, qmask)):
        d, n, out = _int8_case(x, ragged, m, f"widths {INT8_RAGGED}")
        n_diff, n_all = n_diff + d, n_all + n
    expect(bool(torch.isneginf(out[2]).all()),
           "encoder_pool_int8 ragged: a fully masked cloud is not -inf")
    before = out
    packs = ek.packed_int8_encoder.packs
    wq = ragged["layers_q"][1][0]
    wq.copy_(-wq)
    d, n, after = _int8_case(qpc, ragged, qmask, "after an in-place edit")
    expect(ek.packed_int8_encoder.packs == packs + 1
           and not torch.equal(after, before),
           "encoder_pool_int8: an in-place weight edit did not repack")
    for dims in INT8_WIDTHS:
        g = torch.Generator(device="cpu").manual_seed(29)
        qw = quantize_encoder([
            ((torch.rand(k, c, generator=g) * 2 - 1) / k ** 0.5,
             (torch.rand(c, generator=g) * 2 - 1) * 0.1)
            for k, c in zip(dims[:-1], dims[1:])])
        qw = {"layer0": tuple(x.to(device) for x in qw["layer0"]),
              "layers_q": [tuple(x.to(device) for x in layer)
                           for layer in qw["layers_q"]]}
        name = ("encoder_pool_int8" if ek.int8_instance(dims) == "mma"
                else "encoder_pool_int8_wide")
        for x, m in ((qpc, None), (qpc, qmask)):
            before = _cuda.launch_counts[name]
            d, n, out = _int8_case(x, qw, m, f"widths {dims}")
            expect(_cuda.launch_counts[name] == before + 1,
                   f"widths {dims} did not run {name}")
            n_diff, n_all = n_diff + d, n_all + n
        expect(bool(torch.isneginf(out[2]).all()),
               f"encoder_pool_int8 {dims}: a fully masked cloud is not -inf")
        print(f"{name} at widths {dims}, B=3, N=1000, masked (a fully "
              "masked cloud) and unmasked: equal to the plain version")
    wide = ek.pack_int8_encoder(qenc, "wide")
    for m in (None, mask):
        out = ek.encoder_pool_int8_packed(pc, wide, m)
        ref = ek.fused_encoder_pool_int8_plain(pc, qenc, m)
        expect(torch.equal(out, ref), "encoder_pool_int8_wide at the "
               f"flagship widths: {int((out != ref).sum())} elements differ "
               "from the plain version")
    print(f"encoder_pool_int8_wide at the flagship widths (B={B_MAIN}, "
          f"N={N_MAIN}, masked and unmasked): equal to the plain version")
    bad = ek.int8_divide_mismatches(INT8_DIVIDE_PAIRS, 0, device)
    expect(bad == 0, f"encoder_pool_int8: its divide differs from the IEEE "
           f"one on {bad} of {INT8_DIVIDE_PAIRS} quotients")
    print(f"encoder_pool_int8: its divide equals __fdiv_rn bit for bit on "
          f"{INT8_DIVIDE_PAIRS} quotients (near-ties and all-ones mantissas "
          "included)")
    print(f"encoder_pool_int8: equal to its plain version bit for bit, "
          f"{n_diff} of {n_all} elements differ (B={B_MAIN}, N={N_MAIN} and "
          f"B=3, N=1500, masked and unmasked; widths {INT8_RAGGED} and "
          f"{', '.join(map(str, INT8_WIDTHS))}, N=1000, B=1 and B=3 with a "
          "fully masked cloud); after an in-place edit of one wq the bundle "
          "repacked and the result equals the plain version's")
    return 0.0


def big_batch_checks(device, masked):
    """B = BIG_BATCH clouds of N = M = 16 points, one more than grid.y
    holds: K1 f32 (TOL_F32 scaled) and bf16 on the tensor cores (TOL_BF16
    relative), K3 and K2 (TOL_DIST, settled indices equal), K4
    (TOL_GRAD_KERNEL scaled) and K5 (bit for bit) against their plain
    versions, the whole Chamfer backward."""
    from gan_rl_3d_tpu_torch.ops import chamfer, encoder_kernel as ek

    bsz, n = BIG_BATCH, 16
    a, a_mask = make_clouds(bsz, n, seed=21, device=device)
    b, b_mask = make_clouds(bsz, n, seed=22, device=device)
    am, bm = (a_mask, b_mask) if masked else (None, None)
    g = torch.Generator(device="cpu").manual_seed(23)
    layers = [((torch.rand(k, c, generator=g) * 2 - 1) / k ** 0.5)
              .to(device) for k, c in ((3, 16), (16, 32))]
    layers = [(w, torch.zeros(w.shape[1], device=device)) for w in layers]
    e = scaled_err(ek.fused_encoder_pool(a, layers, am),
                   ek.fused_encoder_pool_plain(a, layers, am))
    expect(e <= TOL_F32, f"encoder_pool_f32 at B={bsz}: err {e:.3e}")
    _k1_case(a, [(w.bfloat16(), z.bfloat16()) for w, z in layers], am,
             torch.bfloat16, f"B={bsz}")
    d, i = chamfer.nearest_distances(a, b, b_mask=bm)
    rd, ri = chamfer.nearest_distances_plain(a, b, bm)
    top2 = chamfer._sqdist(a, b, bm).topk(2, dim=-1, largest=False).values
    settled = (top2[..., 1] - top2[..., 0]) > TIE_GAP
    expect(float((d - rd).abs().max()) <= TOL_DIST
           and int(((i != ri) & settled).sum()) == 0,
           f"nn_dist at B={bsz} disagrees")
    e = float((chamfer.nearest_min_distances(a, b)
               - chamfer.nearest_min_distances_plain(a, b)).abs().max())
    expect(e <= TOL_DIST, f"nn_min at B={bsz}: err {e:.3e}")
    cot = 0.5 + torch.rand(bsz, n, generator=g).to(device)
    da = chamfer.nearest_grad_a(a, b, i, d, cot)
    e = scaled_err(da, chamfer.nearest_grad_a_plain(a, b, i, d, cot))
    expect(e <= TOL_GRAD_KERNEL, f"nn_gather at B={bsz}: err {e:.3e}")
    expect(torch.equal(chamfer.nearest_grad_b(i, da, n),
                       chamfer.nearest_grad_b_plain(i, da, n)),
           f"nn_scatter at B={bsz} differs from its plain version")


def nn_vs_plain(a, b, bm):
    """K3 and K2 against their plain versions: (K3's largest distance
    error, over its distances and those of the neighbours it chose; K2's;
    the settled query points, those whose two nearest squared distances
    are more than TIE_GAP apart, whose index differs)."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    d, i = chamfer.nearest_distances(a, b, b_mask=bm)
    rd, ri = chamfer.nearest_distances_plain(a, b, bm)
    d2 = chamfer._sqdist(a, b, bm)
    top2 = d2.topk(min(2, b.shape[1]), dim=-1, largest=False).values
    settled = (top2[..., -1] - top2[..., 0]) > TIE_GAP
    mismatched = int(((i != ri) & settled).sum())
    # where the index may differ, the chosen neighbours' distances agree
    chosen = torch.sqrt(torch.clamp(
        d2.gather(-1, i.long()[..., None])[..., 0], min=1e-12))
    e3 = max(float((d - rd).abs().max()), float((chosen - rd).abs().max()))
    e2 = float((chamfer.nearest_min_distances(a, b)
                - chamfer.nearest_min_distances_plain(a, b)).abs().max())
    return e3, e2, mismatched


def nn_k2_equals_k3(device):
    """K2's distances equal K3's unmasked ones bit for bit (the same min),
    at B=64, N=M=2048 and at every NN_RAGGED shape."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    shapes = [(B_MAIN, N_MAIN, N_MAIN)] + [(3, n, m) for n, m in NN_RAGGED]
    for k, (bsz, n, m) in enumerate(shapes):
        a, _ = make_clouds(bsz, n, seed=40 + k, device=device)
        b, _ = make_clouds(bsz, m, seed=50 + k, device=device)
        expect(torch.equal(chamfer.nearest_min_distances(a, b),
                           chamfer.nearest_distances(a, b)[0]),
               f"nn_min differs from nn_dist's distances at B={bsz}, N={n}, "
               f"M={m}")


def nn_ones_mask(device):
    """K3 with a b_mask of all ones equals K3 unmasked bit for bit, in dist
    and idx, at B=64, N=M=2048."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    a, _ = make_clouds(B_MAIN, N_MAIN, seed=41, device=device)
    b, _ = make_clouds(B_MAIN, N_MAIN, seed=51, device=device)
    ones = torch.ones(B_MAIN, N_MAIN, device=device)
    d, i = chamfer.nearest_distances(a, b)
    dm, im = chamfer.nearest_distances(a, b, b_mask=ones)
    expect(torch.equal(d, dm) and torch.equal(i, im),
           "nn_dist with a mask of ones differs from unmasked")


def nn_tie_inputs(device, masked):
    """B=64 clouds of 2048 points where b[j'] = b[j] for each (j, j') of
    NN_TIES and query point 3 + 37 t of a sits on pair t's point; masked:
    a tenth of b masked, never a copy."""
    a, _ = make_clouds(B_MAIN, N_MAIN, seed=42, device=device)
    b, _ = make_clouds(B_MAIN, N_MAIN, seed=52, device=device)
    queries = [3 + 37 * t for t in range(len(NN_TIES))]
    for q, (j, dup) in zip(queries, NN_TIES):
        b[:, dup] = b[:, j]
        a[:, q] = b[:, j]
    bm = None
    if masked:
        g = torch.Generator(device=device).manual_seed(53)
        bm = (torch.rand(B_MAIN, N_MAIN, generator=g, device=device)
              > 0.1).float()
        bm[:, [p for pair in NN_TIES for p in pair]] = 1.0
    return a, b, bm, queries


def nn_duplicate_ties(device):
    """Exact duplicates in b within a sub-tile and straddling the sub-tile
    and tile boundaries (NN_TIES): K3 returns the first copy for the query
    point on it, as the plain version does, with the same distance; masked
    and unmasked."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    firsts = torch.tensor([j for j, _ in NN_TIES], device=device)
    for masked in (False, True):
        a, b, bm, queries = nn_tie_inputs(device, masked)
        rd, ri = chamfer.nearest_distances_plain(a, b, bm)
        expect(bool((ri[:, queries] == firsts).all()),
               "the plain version does not return the first copy")
        d, i = chamfer.nearest_distances(a, b, b_mask=bm)
        expect(bool((i[:, queries] == firsts).all()),
               f"nn_dist (masked {masked}) does not return the first copy "
               "of a duplicated point")
        expect(float((d - rd).abs().max()) <= TOL_DIST,
               f"nn_dist on duplicates (masked {masked}): distances")


def nn_ragged(device):
    """K3 and K2 at every (N, M) of NN_RAGGED, B=3, masked with one cloud
    fully masked, and unmasked, against the plain version (TOL_DIST, no
    settled index differing); the fully masked cloud's indices are 0, as
    the plain version's. Returns the largest distance errors of K3 and
    K2."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    worst = [0.0, 0.0]
    for k, (n, m) in enumerate(NN_RAGGED):
        a, _ = make_clouds(3, n, seed=60 + k, device=device)
        b, bm = make_clouds(3, m, seed=70 + k, device=device)
        bm[1] = 0.0
        for mask in (None, bm):
            e3, e2, mismatched = nn_vs_plain(a, b, mask)
            expect(max(e3, e2) <= TOL_DIST and mismatched == 0,
                   f"nn_dist/nn_min at N={n}, M={m} (masked "
                   f"{mask is not None}): err {e3:.3e} / {e2:.3e}, "
                   f"{mismatched} settled indices differ")
            worst = [max(worst[0], e3), max(worst[1], e2)]
        _, i = chamfer.nearest_distances(a, b, b_mask=bm)
        expect(bool((i[1] == 0).all()), f"nn_dist at N={n}, M={m}: a fully "
               "masked cloud's indices are not 0")
    return worst


def nn_checks(device):
    """Every K3/K2 check past the main shapes; returns the largest
    distance errors of K3 and K2 against their plain versions."""
    nn_k2_equals_k3(device)
    nn_ones_mask(device)
    nn_duplicate_ties(device)
    worst = nn_ragged(device)
    print(f"nn_dist/nn_min: K2 equals K3's unmasked distances bit for bit "
          f"(B={B_MAIN}, N=M={N_MAIN} and N, M in {NN_RAGGED}); a mask of "
          "ones equals no mask; duplicates at " + str(NN_TIES) + " give the "
          "first copy; ragged "
          f"shapes with a fully masked cloud: max dist err {max(worst):.3e} "
          f"(tol {TOL_DIST:g}), no settled index differs")
    return worst


def phase_kernels(device, engine_f32, engine_bf16, engine_int8):
    """Each kernel against its plain version at the main path's shapes,
    each instance of K1 and K6 also at the widths that pick it."""
    from gan_rl_3d_tpu_torch.ops import _cuda, chamfer, encoder_kernel as ek

    errs = {}
    pc, mask = make_clouds(B_MAIN, N_MAIN, seed=1, device=device)
    for name, eng, dtype, kernel in (
            ("encoder_pool_f32", engine_f32, torch.float32,
             ek.fused_encoder_pool),
            ("encoder_pool_bf16", engine_bf16, torch.bfloat16,
             ek.fused_encoder_pool),
            ("encoder_pool_bf16_wide", engine_bf16, torch.bfloat16,
             ek.encoder_pool_cuda_cores)):
        worst, worst_abs, n_diff, n_all = 0.0, 0.0, 0, 0
        for m in (None, mask):
            before = _cuda.launch_counts[name]
            out = kernel(pc, eng["encoder"]["layers"], m, compute_dtype=dtype)
            expect(_cuda.launch_counts[name] == before + 1,
                   f"{name} did not run at the flagship widths")
            ref = ek.fused_encoder_pool_plain(pc, eng["encoder"]["layers"], m,
                                              compute_dtype=dtype)
            expect(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                   f"{name}: bad output")
            e = (scaled_err(out, ref) if dtype == torch.float32
                 else rel_err(out, ref))
            worst = max(worst, e)
            worst_abs = max(worst_abs, float((out - ref).abs().max()))
            n_diff += int((out != ref).sum())
            n_all += out.numel()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        kind = "scaled" if dtype == torch.float32 else "relative"
        print(f"{name}: {kind} err vs plain {worst:.3e} (tol {tol:g}), "
              f"max abs err {worst_abs:.3e}, {n_diff} of {n_all} elements "
              f"differ (B={B_MAIN}, N={N_MAIN}, masked and unmasked)")
        expect(worst <= tol, f"{name} disagrees with its plain version")
        errs[name] = worst_abs
    for name, e in odd_width_k1(device).items():
        errs[name] = max(errs[name], e)
    for masked in (False, True):
        big_batch_checks(device, masked)
    print(f"B={BIG_BATCH}, N=M=16, masked and unmasked: encoder_pool_f32, "
          "encoder_pool_bf16, nn_dist, nn_min, nn_gather and nn_scatter "
          "agree with their plain versions (nn_scatter bit for bit)")
    torch.cuda.synchronize()

    errs["encoder_pool_int8"] = int8_checks(device, engine_int8["encoder_q"],
                                            pc, mask)
    errs["encoder_pool_int8_wide"] = 0.0
    torch.cuda.synchronize()

    a, _ = make_clouds(B_MAIN, N_MAIN, seed=2, device=device)
    b, b_mask = make_clouds(B_MAIN, N_MAIN, seed=3, device=device)
    e3, e2, worst_i = 0.0, 0.0, 0
    for bm in (None, b_mask):
        d3, d2, mismatched = nn_vs_plain(a, b, bm)
        e3, e2, worst_i = max(e3, d3), max(e2, d2), max(worst_i, mismatched)
    print(f"nn_dist: max dist err {e3:.3e}, nn_min {e2:.3e} (tol "
          f"{TOL_DIST:g}), {worst_i} settled index mismatches (B={B_MAIN}, "
          f"N=M={N_MAIN}, masked and unmasked)")
    expect(max(e3, e2) <= TOL_DIST and worst_i == 0, "nn_dist disagrees")
    r3, r2 = nn_checks(device)
    errs["nn_dist"], errs["nn_min"] = max(e3, r3), max(e2, r2)
    torch.cuda.synchronize()
    return errs


def grad_inputs(bsz, n, m, seed, device, masked):
    """K3's outputs on two clouds and a cotangent g ~ U(0.5, 1.5), the
    inputs K4 and K5 see in the Chamfer backward."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    a, _ = make_clouds(bsz, n, seed=seed, device=device)
    b, b_mask = make_clouds(bsz, m, seed=seed + 1, device=device)
    bm = b_mask if masked else None
    dist, idx = chamfer.nearest_distances(a, b, b_mask=bm)
    g = 0.5 + torch.rand(bsz, n, generator=torch.Generator(device=device)
                         .manual_seed(seed + 2), device=device)
    return a, b, bm, dist, idx, g


def chamfer_grad_vs_cpu(a, b, b_mask=None):
    """The Chamfer gradient w.r.t. both clouds by the autograd Function on
    ``a``'s device (the kernels) against the same Function on CPU copies
    (the plain versions). A query point whose neighbour differs (a
    near-tie: K3 and the plain version round |a|^2 + |b|^2 - 2ab
    differently) moves the gradient of it and of both candidate
    neighbours, so those are left out. Returns (the largest difference
    relative to the largest gradient element, the number of points left
    out, the largest |gradient| of a masked b point)."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    grads = []
    for dev in (a.device, torch.device("cpu")):
        x = a.detach().to(dev).requires_grad_(True)
        y = b.detach().to(dev).requires_grad_(True)
        bm = None if b_mask is None else b_mask.to(dev)
        chamfer.chamfer_distance(x, y, b_mask=bm).sum().backward()
        i_ab = chamfer.nearest_distances(x.detach(), y.detach(), b_mask=bm)[1]
        i_ba = chamfer.nearest_distances(y.detach(), x.detach())[1]
        grads.append((x.grad.cpu(), y.grad.cpu(), i_ab.cpu(), i_ba.cpu()))
    (ga, gb, ia, ib), (ra, rb, ria, rib) = grads
    bad_a, bad_b = ia != ria, ib != rib
    for q, p, bad_target in ((ia, ria, bad_b), (ib, rib, bad_a)):
        rows, cols = (q != p).nonzero(as_tuple=True)
        bad_target[rows, q[rows, cols].long()] = True
        bad_target[rows, p[rows, cols].long()] = True
    scale = float(torch.maximum(ra.abs().max(), rb.abs().max()))
    err = max(float((ga - ra).abs()[~bad_a].max()),
              float((gb - rb).abs()[~bad_b].max())) / scale
    masked_grad = 0.0
    if b_mask is not None and bool((b_mask == 0).any()):
        masked_grad = float(gb[(b_mask == 0).cpu()].abs().max())
    return err, int(bad_a.sum() + bad_b.sum()), masked_grad


SCATTER_CASES = {  # name: (B, N, M, targets)
    "all on target 0": (4, 2048, 2048, "zero"),
    "all distinct": (4, 2048, 2048, "perm"),
    "M > N": (4, 500, 3000, "rand"),
    "N > M": (4, 3000, 100, "rand"),
    "global scratch": (3, 5000, 4000, "rand"),
    "B=2, N=M=20000": (2, 20000, 20000, "rand"),
}


def scatter_cases(device):
    """(name, idx, da, m): adversarial inputs for K5, from a fixed seed."""
    out = []
    for k, (name, (bsz, n, m, kind)) in enumerate(SCATTER_CASES.items()):
        g = torch.Generator(device=device).manual_seed(30 + k)
        if kind == "zero":
            idx = torch.zeros(bsz, n, dtype=torch.int32, device=device)
        elif kind == "perm":
            idx = torch.stack([torch.randperm(n, generator=g, device=device)
                               for _ in range(bsz)]).to(torch.int32)
        else:
            idx = torch.randint(0, m, (bsz, n), generator=g, device=device,
                                dtype=torch.int32)
        da = torch.randn(bsz, n, 3, generator=g, device=device)
        out.append((name, idx, da, m))
    return out


def phase_grad_kernels(device):
    """K4 and K5 against their plain versions (K5 bit for bit, also on
    adversarial targets), K5's repeatability, and the Chamfer gradient by
    the kernels against the same Function on the CPU."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    errs = {"nn_gather": 0.0, "nn_scatter": 0.0}
    for masked in (False, True):
        a, b, _, dist, idx, g = grad_inputs(B_MAIN, N_MAIN, N_MAIN, 10,
                                            device, masked)
        da = chamfer.nearest_grad_a(a, b, idx, dist, g)
        ref = chamfer.nearest_grad_a_plain(a, b, idx, dist, g)
        e = scaled_err(da, ref)
        errs["nn_gather"] = max(errs["nn_gather"],
                                float((da - ref).abs().max()))
        expect(e <= TOL_GRAD_KERNEL, f"nn_gather disagrees ({e:.3e})")
        db = chamfer.nearest_grad_b(idx, da, N_MAIN)
        ref = chamfer.nearest_grad_b_plain(idx, da, N_MAIN)
        errs["nn_scatter"] = max(errs["nn_scatter"],
                                 float((db - ref).abs().max()))
        expect(torch.equal(db, ref), "nn_scatter differs from its ordered "
               f"plain version ({int((db != ref).sum())} elements)")
        expect(torch.equal(db, chamfer.nearest_grad_b(idx, da, N_MAIN)),
               "nn_scatter: two launches on the same inputs differ")
        # ragged sizes, off every tile and chunk boundary
        ra, rb, _, rd, ri, rg = grad_inputs(3, 2501, 777, 11, device, masked)
        rda = chamfer.nearest_grad_a(ra, rb, ri, rd, rg)
        expect(scaled_err(rda, chamfer.nearest_grad_a_plain(ra, rb, ri, rd,
                                                            rg))
               <= TOL_GRAD_KERNEL, "nn_gather ragged disagrees")
        expect(torch.equal(chamfer.nearest_grad_b(ri, rda, 777),
                           chamfer.nearest_grad_b_plain(ri, rda, 777)),
               "nn_scatter ragged differs from its plain version")
    for name, idx, da, m in scatter_cases(device):
        db = chamfer.nearest_grad_b(idx, da, m)
        expect(torch.equal(db, chamfer.nearest_grad_b_plain(idx, da, m))
               and torch.equal(db, chamfer.nearest_grad_b(idx, da, m)),
               f"nn_scatter {name}: differs from its plain version or "
               "between launches")
    print(f"nn_gather: max abs err vs plain {errs['nn_gather']:.3e} (tol "
          f"{TOL_GRAD_KERNEL:g} scaled); nn_scatter equal to its ordered "
          f"plain version bit for bit and bitwise repeatable (B={B_MAIN} "
          "masked and unmasked, ragged, " + ", ".join(SCATTER_CASES) + ")")

    worst = 0.0
    for masked in (False, True):
        a, _ = make_clouds(B_MAIN, N_MAIN, seed=12, device=device)
        b, b_mask = make_clouds(B_MAIN, N_MAIN, seed=13, device=device)
        e, flipped, masked_grad = chamfer_grad_vs_cpu(
            a, b, b_mask if masked else None)
        worst = max(worst, e)
        print(f"chamfer grad ({'masked' if masked else 'unmasked'}): "
              f"card vs CPU {e:.3e} of max |grad| (tol "
              f"{TOL_CHAMFER_GRAD:g}); {flipped} of {2 * B_MAIN * N_MAIN} "
              "points left out for a flipped neighbour")
        expect(flipped <= 64, "too many flipped neighbours")
        expect(masked_grad == 0.0, "masked b points got a gradient")
    expect(worst <= TOL_CHAMFER_GRAD, "chamfer gradient disagrees")
    torch.cuda.synchronize()
    return errs


def write_scans(folder: Path, seed: int) -> list:
    """Three scans of 1500, 2048 and 3000 points (.txt, .ply, .txt) far
    from the origin, as a user's files would be."""
    from gan_rl_3d_tpu_torch.utils.ply import save_ply

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    inputs = []
    for i, n in enumerate((1500, 2048, 3000)):
        pts = (rng.randn(n, 3) * [1.0, 0.5, 0.3] + SCAN_CENTRE)
        path = folder / f"scan_{i}.{'ply' if i == 1 else 'txt'}"
        if path.suffix == ".ply":
            save_ply(str(path), pts)
        else:
            np.savetxt(path, pts)
        inputs.append(path)
    return inputs


def serve_files(inputs, out_dir: Path, args, n_out: int) -> None:
    """Run ``complete_clouds`` on ``inputs`` with ``args`` and check every
    PLY it writes: ``n_out`` finite points in the input's frame."""
    from gan_rl_3d_tpu_torch import complete_clouds
    from gan_rl_3d_tpu_torch.data.dataset import load_ply

    complete_clouds.main([*map(str, inputs), *args, "--output-dir",
                          str(out_dir)])
    for src in inputs:
        pts = load_ply(out_dir / f"{src.stem}_completed.ply")
        expect(pts.shape == (n_out, 3) and np.isfinite(pts).all(),
               f"served {src.name} ({args}): {pts.shape}")
        # written in the input's frame: centred near the input's centroid
        expect(np.abs(pts.mean(0) - SCAN_CENTRE).max() < 5.0,
               f"served {src.name} not in the input frame")


def engine_checks(model, target, mask, cfg, int8_gfv_tol=TOL_INT8_GFV):
    """The three engines of ``model`` against the unfolded ``complete``:
    the f32 engine within TOL_F32 in every gate mode, the bf16 engine
    within TOL_BF16 of f32, the int8 engine's GFV within ``int8_gfv_tol``
    of f32 and its clouds within TOL_INT8_PC of ``complete``. Returns the
    engines and the largest errors."""
    from gan_rl_3d_tpu_torch.models import inference, rl_gan_net

    errs = {"f32": 0.0, "int8_gfv": 0.0, "int8_pc": 0.0}
    engine = inference.prepare_inference_engine(model)
    for mode in ("discriminator", "rl", "ae", "union"):
        ref = rl_gan_net.complete(model, target, mask, cfg=cfg, gate_mode=mode)
        fast = inference.complete_fast(engine, target, mask, gate_mode=mode)
        expect(set(ref) == set(fast), f"{mode}: output keys differ")
        for k in ref:
            r, f = ref[k], fast[k]
            if k == "hybrid_output" and mode == "discriminator":
                margin = (ref["rl_gan_score"] - ref["ae_score"])[:, 0].abs()
                r, f = r[margin > 1e-4], f[margin > 1e-4]
            e = scaled_err(f, r)
            errs["f32"] = max(errs["f32"], e)
            expect(e <= TOL_F32, f"complete_fast {mode} {k}: err {e:.3e}")
        print(f"complete_fast f32 == complete, gate {mode} "
              f"(hybrid {tuple(fast['hybrid_output'].shape)})")

    engine_bf16 = inference.prepare_inference_engine(model,
                                                     dtype=torch.bfloat16)
    f32 = inference.complete_fast(engine, target, mask, gate_mode="rl")
    bf = inference.complete_fast(engine_bf16, target, mask, gate_mode="rl")
    errs["bf16"] = max(rel_err(bf[k], f32[k]) for k in
                       ("noisy_gfv", "z_vector", "clean_gfv", "completed_pc",
                        "ae_reconstruction"))
    print(f"complete_fast bf16 vs f32: max rel err {errs['bf16']:.3e} "
          f"(tol {TOL_BF16:g})")
    expect(errs["bf16"] <= TOL_BF16, "bf16 engine disagrees with f32")

    engine_q = inference.prepare_inference_engine(model, quantize_int8=True)
    for mode in ("discriminator", "rl", "ae", "union"):
        ref = rl_gan_net.complete(model, target, mask, cfg=cfg, gate_mode=mode)
        f32 = inference.complete_fast(engine, target, mask, gate_mode=mode)
        q = inference.complete_fast(engine_q, target, mask, gate_mode=mode)
        expect(set(q) == set(ref), f"int8 {mode}: output keys differ")
        gfv = rel_err(q["noisy_gfv"], f32["noisy_gfv"])
        pc_err = max(float((q[k] - ref[k]).abs().max())
                     for k in ("completed_pc", "ae_reconstruction"))
        hq, hr, ties = q["hybrid_output"], ref["hybrid_output"], 0
        if mode == "discriminator":
            # a row's gate cannot flip where the reference margin exceeds
            # how far the int8 engine moved the two scores
            margin = (ref["rl_gan_score"] - ref["ae_score"])[:, 0].abs()
            shift = ((q["rl_gan_score"] - ref["rl_gan_score"]).abs()
                     + (q["ae_score"] - ref["ae_score"]).abs())[:, 0]
            settled = margin > shift
            hq, hr, ties = hq[settled], hr[settled], int((~settled).sum())
        hyb = float((hq - hr).abs().max()) if hq.numel() else 0.0
        errs["int8_gfv"] = max(errs["int8_gfv"], gfv)
        errs["int8_pc"] = max(errs["int8_pc"], pc_err, hyb)
        print(f"complete_fast int8, gate {mode}: noisy_gfv vs f32 engine "
              f"{gfv:.3e} of max (tol {int8_gfv_tol}); completed_pc / "
              f"ae_reconstruction vs complete {pc_err:.3e}, hybrid_output "
              f"{hyb:.3e} (tol {TOL_INT8_PC:g}; {ties} near-tie rows left "
              "out)")
        expect(gfv <= int8_gfv_tol and pc_err <= TOL_INT8_PC
               and hyb <= TOL_INT8_PC,
               f"int8 engine disagrees ({mode})")
    return engine, engine_bf16, engine_q, errs


def phase_main(device, model, tmp: Path):
    """The completion path at full width, counted launch by launch."""
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.ops.metrics import evaluate_completion

    target, mask = make_clouds(B_MAIN, N_MAIN, seed=4, device=device)
    _cuda.launch_counts.clear()
    engine, engine_bf16, engine_q, errs = engine_checks(
        model, target, mask, _flagship().td3_config())

    # serve files through the CLI, as a user would
    eng_path, q_path = tmp / "engine.pkl", tmp / "engine_q.pkl"
    inference.save_engine(str(eng_path), engine)
    inference.save_engine(str(q_path), engine_q)
    inputs = write_scans(tmp / "scans", seed=5)
    for path, mode, n_out in ((eng_path, "discriminator", N_MAIN),
                              (eng_path, "union", 2 * N_MAIN),
                              (q_path, "discriminator", N_MAIN)):
        serve_files(inputs, tmp / f"out_{path.stem}_{mode}",
                    ["--engine", str(path), "--gate-mode", mode, "--device",
                     device.type], n_out)
    print(f"complete_clouds --engine served {len(inputs)} files: f32 engine "
          "x 2 gate modes, int8 engine")

    completion = inference.complete_fast(engine, target, mask)["hybrid_output"]
    scores = evaluate_completion(
        completion, target,
        metrics=("chamfer_distance", "completion_ratio",
                 "hausdorff_distance", "f_score"))
    expect(all(bool(torch.isfinite(v)) for v in scores.values()),
           "non-finite metric")
    print("evaluate_completion: " + ", ".join(
        f"{k}={float(v):.6f}" for k, v in scores.items()))
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    print(f"serving-path launches: {counts}")
    for name in SERVING_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "serving path")
    return engine, engine_bf16, engine_q, counts, errs


def _flagship():
    from gan_rl_3d_tpu_torch.config import flagship_config
    return flagship_config()


def phase_train(device, tmp: Path):
    """The training path at full width: phase 1 of the curriculum through
    the trainer the CLI calls, counted launch by launch; then one f32 step
    on the card against the same step on the CPU."""
    import dataclasses

    from gan_rl_3d_tpu_torch.data.dataset import setup_dataset
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer

    t0 = time.perf_counter()
    # 8 categories x 16 train clouds: 2 steps per epoch at B=64
    setup_dataset(str(tmp / "data"), synthetic=True, samples_per_category=16)
    print(f"synthetic dataset written in {time.perf_counter() - t0:.1f}s")
    cfg = _flagship()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_dir=str(tmp / "data")),
        training=dataclasses.replace(
            cfg.training, checkpoint_dir=str(tmp / "ckpt"),
            autoencoder=dataclasses.replace(cfg.training.autoencoder,
                                            epochs=2)))
    # a checkpoint and its train state every epoch, for resume_checks; the
    # later phases keep the recipe's frequency
    every_epoch = dataclasses.replace(cfg, logging=dataclasses.replace(
        cfg.logging, save_model_frequency=1))
    trainer = RLGANNetTrainer(every_epoch, device=device)
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    best = trainer.train_autoencoder()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    losses = trainer.train_losses
    print(f"training-path launches: {counts}")
    print(f"train_autoencoder: {len(losses)} steps ({dt:.2f}s with "
          f"validation), losses {[round(x, 6) for x in losses]}, best val "
          f"{best:.6f}")
    expect(len(losses) == 4 and all(np.isfinite(losses)) and np.isfinite(best),
           "non-finite or missing training loss")
    for name in TRAINING_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "training path")
    saved = trainer.model["ae"]
    expect((tmp / "ckpt" / "autoencoder_best").exists(),
           "autoencoder_best was not written")
    epoch, phase = trainer.load_checkpoint("autoencoder_best")
    expect((epoch, phase) == (1, "autoencoder"), f"checkpoint meta {epoch}, "
           f"{phase}")
    for a, b in zip(_leaves(saved), _leaves(trainer.model["ae"])):
        expect(torch.equal(a.detach(), b.detach()),
               "reloaded checkpoint differs from the trained model")
    print("autoencoder_best reloaded through the port's load_checkpoint")
    step_check(device, trainer.model["ae"])
    resume_checks(device, tmp, every_epoch)
    return counts, cfg


def resume_checks(device, tmp: Path, cfg):
    """Mid-phase resume on the card: ``train_rl_gan_net --phase autoencoder
    --resume autoencoder_epoch_1`` in a copy of phase 4's checkpoints runs
    only epoch index 1 from the restored train state, whose Adam moments,
    loaded onto the card, equal the saved ones bit for bit, with Adam's
    step and the schedule at the saved count; with the sibling deleted the
    same command starts with a fresh optimizer and runs both epochs."""
    import dataclasses
    import shutil

    from gan_rl_3d_tpu_torch.convert import load_chain
    from gan_rl_3d_tpu_torch.train import steps
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
    from gan_rl_3d_tpu_torch.train_rl_gan_net import main as train_main
    from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt_lib
    from gan_rl_3d_tpu_torch.utils.tree import tree_leaves

    src, ckpt = Path(cfg.training.checkpoint_dir), tmp / "ckpt_resume"
    ckpt.mkdir()
    for name in ("autoencoder_epoch_1", "autoencoder_epoch_1_trainstate"):
        expect((src / name).is_file(), f"phase 4 did not write {name}")
        shutil.copy(src / name, ckpt / name)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, checkpoint_dir=str(ckpt)))
    cfg_path = tmp / "resume.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(cfg)))
    saved = ckpt_lib.load_checkpoint(str(ckpt / "autoencoder_epoch_1_"
                                         "trainstate"))
    adam = saved["opt_state"][1]
    count = int(adam.count)
    trainer = RLGANNetTrainer(cfg, device=device)
    spe = len(trainer.train_loader)
    expect(count == spe and int(saved["epoch"]) == 0,
           f"train state: count {count}, epoch {int(saved['epoch'])}")
    trainer.load_checkpoint("autoencoder_epoch_1")
    params = trainer.model["ae"]["params"]
    opt, sched = steps.make_ae_optimizer(params, cfg.training.autoencoder, spe)
    load_chain(opt, params, trainer._restore_train_state("autoencoder")[
        "opt_state"], sched)
    mus, nus = tree_leaves(adam.mu), tree_leaves(adam.nu)
    same = all(
        opt.state[p]["exp_avg"].device.type == device.type
        and float(opt.state[p]["step"]) == count
        and torch.equal(opt.state[p]["exp_avg"].cpu(), torch.from_numpy(mu))
        and torch.equal(opt.state[p]["exp_avg_sq"].cpu(),
                        torch.from_numpy(nu))
        for p, mu, nu in zip(tree_leaves(params), mus, nus))
    print(f"autoencoder_epoch_1_trainstate: {len(mus)} Adam moments of "
          f"{sum(m.size for m in mus)} elements loaded onto the card bit for "
          f"bit: {same}; step {count}, schedule step {sched.last_epoch}, lr "
          f"{opt.param_groups[0]['lr']:.6e}")
    expect(same and sched.last_epoch == count,
           "restored Adam state differs from the saved one")

    argv = ["--config", str(cfg_path), "--phase", "autoencoder", "--resume",
            "autoencoder_epoch_1", "--device", device.type]
    t0 = time.perf_counter()
    _, out = captured(train_main, argv)
    epochs = re.findall(r"^AE epoch (\d+)/", out, re.M)
    print(f"resumed run: epochs {epochs} in {time.perf_counter() - t0:.2f}s")
    expect("restored autoencoder train state" in out and epochs == ["2"],
           "the resumed run did not run epoch index 1 alone")
    (ckpt / "autoencoder_epoch_1_trainstate").unlink()
    _, out = captured(train_main, argv)
    epochs = re.findall(r"^AE epoch (\d+)/", out, re.M)
    print(f"control, the sibling deleted: epochs {epochs}")
    expect("fresh optimizer" in out and epochs == ["1", "2"],
           "without its train state the resume did not start fresh")


def phase_eval(device, tmp: Path, cfg):
    """The serving side on phase 1's checkpoint, through the CLIs a user
    calls: ``evaluate --checkpoint autoencoder_best --export-engine``, then
    ``complete_clouds --checkpoint`` and ``--engine`` (the exported
    engine) on a few files; counted launch by launch."""
    import dataclasses

    from gan_rl_3d_tpu_torch import evaluate
    from gan_rl_3d_tpu_torch.config import load_config
    from gan_rl_3d_tpu_torch.ops import _cuda

    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, results_dir=str(tmp / "results")))
    cfg_path = tmp / "run.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(cfg)))
    expect(load_config(str(cfg_path)) == cfg, "config JSON round trip")
    engine_path = tmp / "engine_eval.pkl"
    inputs = write_scans(tmp / "scans_eval", seed=6)
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    stats = evaluate.main(["--config", str(cfg_path), "--checkpoint",
                           "autoencoder_best", "--num-export", "2",
                           "--export-engine", str(engine_path), "--device",
                           device.type])
    dt = time.perf_counter() - t0
    expect(len(stats) >= 5 and all(np.isfinite(v) for v in stats.values()),
           f"evaluate: non-finite or missing metrics {stats}")
    expect((tmp / "results" / "results_viewer.html").exists()
           and len(list((tmp / "results" / "point_clouds").glob("*.ply")))
           == 6, "evaluate: report or PLY samples missing")
    print(f"evaluate --checkpoint autoencoder_best: {len(stats)} metrics in "
          f"{dt:.2f}s, " + ", ".join(f"{k}={v:.6f}" for k, v in stats.items()))
    for args in (["--checkpoint", "autoencoder_best"],
                 ["--engine", str(engine_path)]):
        serve_files(inputs, tmp / f"out_eval_{args[0][2:]}",
                    [*args, "--config", str(cfg_path), "--device",
                     device.type], N_MAIN)
    print(f"complete_clouds --checkpoint autoencoder_best and --engine "
          f"{engine_path.name} served {len(inputs)} files each")
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    print(f"evaluation-path launches: {counts}")
    for name in EVAL_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "evaluation path")
    return counts


def synthetic_clouds(bsz: int, n: int, seed: int, device) -> tuple:
    """``bsz`` clouds of the port's synthetic categories
    (``data/synthetic.py``, in turn), on the unit sphere as the dataset
    serves them, with masks that cut a random share of each (the padded
    tail the serving CLI produces)."""
    from gan_rl_3d_tpu_torch.data.synthetic import (CATEGORIES,
                                                    generate_synthetic_cloud)
    from gan_rl_3d_tpu_torch.ops.pointcloud import normalize_unit_sphere

    rng = np.random.RandomState(seed)
    pc = np.stack([generate_synthetic_cloud(CATEGORIES[i % len(CATEGORIES)],
                                            n, rng) for i in range(bsz)])
    keep = rng.randint(n // 2, n + 1, (bsz, 1))
    mask = (np.arange(n)[None, :] < keep).astype(np.float32)
    return (normalize_unit_sphere(torch.from_numpy(pc)).to(device)
            .contiguous(), torch.from_numpy(mask).to(device))


def int8_card_vs_cpu(engine_q, tree, target, mask) -> None:
    """The int8 engine's GFVs on the card against the same engine built
    and run on the CPU (the plain K6, which equals the JAX package's int8
    engine): within TOL_INT8_CARD of their largest element."""
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import inference

    cpu = torch.device("cpu")
    engine_cpu = inference.prepare_inference_engine(
        model_from_numpy(tree, device=cpu), quantize_int8=True)
    card = inference.complete_fast(engine_q, target, mask, gate_mode="rl")
    ref = inference.complete_fast(engine_cpu, target.cpu(), mask.cpu(),
                                  gate_mode="rl")
    errs = {k: rel_err(card[k].cpu(), ref[k])
            for k in ("noisy_gfv", "clean_gfv")}
    print("int8 engine card vs CPU: " + ", ".join(
        f"{k} {e:.3e} of max" for k, e in errs.items())
        + f" (tol {TOL_INT8_CARD:g})")
    expect(max(errs.values()) <= TOL_INT8_CARD,
           "int8 engine: the card disagrees with the CPU")


def _count_arrays(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_arrays(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_arrays(v) for v in tree)
    return int(isinstance(tree, np.ndarray))


def _shapes(tree):
    from gan_rl_3d_tpu_torch.utils.tree import tree_map
    return tree_map(np.shape, tree)


def phase_trained(device, tmp: Path, cfg, random_errs: dict):
    """The committed trained checkpoints (the JAX package's orbax
    directories under runs/, read by the port's own reader from a copy):
    the load seconds, the tree (350 arrays, lgan_best's meta), the trained
    GFVs against a random init's; the f32, bf16 and int8 engines on
    ``lgan_best`` at B=64, N=2048 against the serving limits; ``evaluate
    --checkpoint lgan_best --export-engine``, ``complete_clouds
    --checkpoint`` and ``--engine``; one f32 ``joint_train_step`` on its
    weights, card against CPU (``joint_checks``). Counted launch by
    launch."""
    import dataclasses
    import shutil

    from gan_rl_3d_tpu_torch import evaluate
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import rl_gan_net
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.train.trainer import PHASES, RLGANNetTrainer
    from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt_lib

    ckpt = tmp / "ckpt_trained"
    shutil.copytree(TRAINED_DIR, ckpt)
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    seconds, trees = {}, {}
    for name in ("autoencoder_best", "lgan_best"):
        t0 = time.perf_counter()
        trees[name] = ckpt_lib.load_model_checkpoint(str(ckpt), name)
        seconds[name] = time.perf_counter() - t0
    tree, meta = trees["lgan_best"]
    print("load_model_checkpoint of the committed orbax checkpoints (the "
          "port's zstd + OCDBT + zarr reader): " + ", ".join(
              f"{k} {v:.2f}s" for k, v in seconds.items()))
    arrays = _count_arrays(tree) + _count_arrays(meta)
    phase = PHASES[int(meta["phase_idx"])]
    print(f"lgan_best: {arrays} arrays, epoch {int(meta['epoch'])}, phase "
          f"{phase}")
    expect(arrays == TRAINED_ARRAYS and _count_arrays(
        trees["autoencoder_best"][0]) + 2 == TRAINED_ARRAYS,
        "a trained checkpoint does not hold 350 arrays")
    expect((int(meta["epoch"]), phase) == (28, "lgan"), "lgan_best's meta")
    random_tree = init_numpy_model(_flagship(), seed=0)
    for k in ("ae", "lgan"):
        expect(_shapes(tree[k]) == _shapes(random_tree[k]),
               f"lgan_best's {k} widths are not the flagship's")
    expect(_shapes(tree["agent"]["actor"])
           == _shapes(random_tree["agent"]["actor"]),
           "lgan_best's actor widths are not the flagship's")

    td3 = _flagship().td3_config()
    model = model_from_numpy(tree, device=device)
    target, mask = synthetic_clouds(B_MAIN, N_MAIN, seed=90, device=device)
    gfv = rl_gan_net.complete(model, target, mask, cfg=td3)["noisy_gfv"]
    rand = rl_gan_net.complete(model_from_numpy(random_tree, device=device),
                               target, mask, cfg=td3)["noisy_gfv"]
    moved = rel_err(gfv, rand)
    print(f"trained GFVs of {B_MAIN} synthetic clouds: finite "
          f"{bool(torch.isfinite(gfv).all())}, {rel_err(gfv, rand):.3e} of "
          "their largest element from a random init's")
    expect(bool(torch.isfinite(gfv).all()) and moved > 1e-2,
           "trained GFVs are not finite or equal a random init's")

    # TOL_INT8_GFV was set on random weights; the JAX package's own int8
    # engine reads 2.2749e-2 on these weights and clouds
    _, _, engine_q, errs = engine_checks(
        model, target, mask, td3, int8_gfv_tol=TOL_INT8_GFV_TRAINED)
    print("engines on lgan_best (trained) vs random weights (phase 3): "
          + ", ".join(f"{k} {errs[k]:.3e} (random {random_errs[k]:.3e})"
                      for k in ("f32", "bf16", "int8_gfv", "int8_pc")))
    int8_card_vs_cpu(engine_q, tree, target, mask)

    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, checkpoint_dir=str(ckpt),
        results_dir=str(tmp / "results_trained")))
    cfg_path = tmp / "trained.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(cfg)))
    engine_path = tmp / "engine_trained.pkl"
    stats = evaluate.main(["--config", str(cfg_path), "--checkpoint",
                           "lgan_best", "--num-export", "2",
                           "--export-engine", str(engine_path), "--device",
                           device.type])
    expect(len(stats) >= 5 and all(np.isfinite(v) for v in stats.values()),
           f"evaluate lgan_best: non-finite or missing metrics {stats}")
    print("evaluate --checkpoint lgan_best: " + ", ".join(
        f"{k}={v:.6f}" for k, v in stats.items()))
    inputs = write_scans(tmp / "scans_trained", seed=91)
    for args in (["--checkpoint", "lgan_best"],
                 ["--engine", str(engine_path)]):
        serve_files(inputs, tmp / f"out_trained_{args[0][2:]}",
                    [*args, "--config", str(cfg_path), "--device",
                     device.type], N_MAIN)
    print(f"complete_clouds --checkpoint lgan_best and --engine served "
          f"{len(inputs)} files each")

    trainer = RLGANNetTrainer(cfg, device=device)
    trainer.load_checkpoint("lgan_best")
    joint_checks(device, trainer)
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    print(f"trained-path launches: {counts}")
    for name in TRAINED_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "trained path")
    return counts


def lgan30_config(data_dir: Path, ckpt_dir: Path):
    """runs/best7/probe_lgan30/config_lgan30.yaml (the recipe that trained
    the committed checkpoints) with ``data.data_dir`` and
    ``training.checkpoint_dir`` set to the run's copies, and its logs and
    results beside the checkpoints."""
    from gan_rl_3d_tpu_torch.config import load_config

    runs = {"checkpoint_dir": str(ckpt_dir),
            "log_dir": str(ckpt_dir.parent / "logs_data"),
            "results_dir": str(ckpt_dir.parent / "results_data")}
    return load_config(str(TRAINED_DIR.parent / "config_lgan30.yaml"),
                       overrides={"data": {"data_dir": str(data_dir)},
                                  "training": runs})


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def nearest_bf16_cross(a, b, b_mask=None):
    """The plain K3 with the operands of the cross term, -2a and b,
    rounded to bf16 (a TPU's one-pass bf16 dot); |a|^2, |b|^2 and every
    sum in f32. A check of where the TPU's figures come from, not a path
    of the port."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1)[:, None, :]
    if b_mask is not None:
        b2 = b2 + (1.0 - b_mask.float())[:, None, :] * 1e30
    cross = torch.bmm((a * -2.0).bfloat16().float(),
                      b.bfloat16().float().transpose(1, 2))
    dmin, idx = ((a2 + b2) + cross).min(dim=-1)
    return torch.sqrt(torch.clamp(dmin, min=1e-12)), idx.to(torch.int32)


def split_checks(ds, split: str, seed: int) -> None:
    """DATA_CHECKED clouds of a split: each its file's rows as a set, bit
    for bit (sorted rows; the file parsed by numpy)."""
    from gan_rl_3d_tpu_torch.data.dataset import load_txt_plain

    def rows(x):
        return x[np.lexsort(x.T[::-1])]

    data = ds.as_array()
    for i in np.random.RandomState(seed).choice(len(ds), DATA_CHECKED,
                                                 replace=False):
        ref = load_txt_plain(Path(ds.files[i]["path"]))
        expect(ref.shape == data[i].shape
               and np.array_equal(rows(data[i]), rows(ref)),
               f"{split} cloud {i} is not its file's rows")


def gfv_match(card: np.ndarray, committed: np.ndarray, device) -> dict:
    """Each card GFV's nearest committed GFV (L2, order-free): whether the
    map is one to one, the pairs' largest differences as shares of the
    committed set's largest element, and the smallest ratio of second-
    nearest to nearest distance."""
    a = torch.from_numpy(card).to(device)
    b = torch.from_numpy(committed).to(device)
    scale = float(b.abs().max())
    near, gaps, ratio = [], [], []
    for chunk in a.split(1024):
        d = torch.cdist(chunk, b,
                        compute_mode="donot_use_mm_for_euclid_dist")
        top, idx = d.topk(2, dim=1, largest=False)
        near.append(idx[:, 0])
        gaps.append((chunk - b[idx[:, 0]]).abs().amax(dim=1) / scale)
        ratio.append(top[:, 1] / top[:, 0])
    near, gaps = torch.cat(near), torch.cat(gaps).double()
    return {"one_to_one": int(torch.unique(near).numel()) == len(card),
            "max": float(gaps.max()),
            "p999": float(torch.quantile(gaps, 0.999)),
            "median": float(gaps.median()),
            "min_ratio": float(torch.cat(ratio).min()), "scale": scale}


def phase_data(device, tmp: Path):
    """The data path (the port's C++ loader, the dataset, the batch plan,
    the two data CLIs) on best7's dataset, regenerated at full size, with
    the repo's trained AE: ``setup_dataset --synthetic
    --samples-per-category 1600 --test``; each split cached at the
    config's workers, sampled clouds their files' rows, the shard-aligned
    plan; ``autoencoder_best``'s val Chamfer against the JAX package's f32
    figure, and with the cross term in bf16 against the TPU's; its clean
    train GFVs against the committed ones; ``test_rl_gan_net`` on the
    card. Counted launch by launch (K3 in the validation)."""
    import shutil

    from gan_rl_3d_tpu_torch.data.dataset import (DATA_SHARD_GROUPS,
                                                  BatchLoader,
                                                  ShapeNetDataset)
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.ops import chamfer
    from gan_rl_3d_tpu_torch.train import trainer as trainer_lib

    card = card_line()
    times = {}
    data = tmp / "shapenet"
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "gan_rl_3d_tpu_torch.setup_dataset",
         "--data-dir", str(data), "--synthetic", "--samples-per-category",
         str(DATA_SAMPLES), "--test"], cwd=repo, capture_output=True,
        text=True)
    times["setup_dataset s"] = time.perf_counter() - t0
    print(out.stdout.strip())
    expect(out.returncode == 0, f"setup_dataset failed:\n{out.stderr}")
    expect("Data loading test passed" in out.stdout,
           "setup_dataset --test did not pass")
    files = {s: sorted((data / s).rglob("*.txt"))
             for s in ("train", "val", "test")}
    nbytes = sum(p.stat().st_size for v in files.values() for p in v)
    sizes = {s: len(v) for s, v in files.items()}
    per_cat = {"train": DATA_SAMPLES, "val": DATA_SAMPLES // 4,
               "test": DATA_SAMPLES // 4}
    print(f"setup_dataset --synthetic --samples-per-category {DATA_SAMPLES} "
          f"--test: {times['setup_dataset s']:.1f}s, {nbytes} bytes, "
          f"splits {sizes} ({card})")
    expect(sizes == {s: 8 * n for s, n in per_cat.items()},
           f"splits {sizes}")

    ckpt = tmp / "ckpt_data"
    shutil.copytree(TRAINED_DIR, ckpt)
    cfg = lgan30_config(data, ckpt)
    workers = cfg.training.num_workers
    for i, split in enumerate(("train", "val", "test")):
        t0 = time.perf_counter()
        ds = ShapeNetDataset(str(data), split, N_MAIN,
                             seed=cfg.training.seed, workers=workers)
        dt = times[f"cache {split} s"] = time.perf_counter() - t0
        print(f"{split}: {len(ds)} clouds cached in {dt:.2f}s at {workers} "
              f"workers, {1e3 * dt / len(ds):.3f} ms a file ({card})")
        split_checks(ds, split, seed=i)
        if split == "train":
            loader = BatchLoader(ds, cfg.training.batch_size,
                                 seed=cfg.training.seed,
                                 shard_groups=DATA_SHARD_GROUPS)
            idx, _ = loader.epoch_indices()
            n, bs = len(ds), cfg.training.batch_size
            slot_group = np.arange(bs) // (bs // DATA_SHARD_GROUPS)
            expect(bool((idx // (n // DATA_SHARD_GROUPS)
                         == slot_group).all())
                   and np.array_equal(np.sort(idx.ravel()), np.arange(n)),
                   "the shard-aligned plan leaves a slot group's rows")
        del ds
    print(f"{DATA_CHECKED} clouds a split equal their files' rows; the "
          f"{DATA_SHARD_GROUPS}-group plan keeps every slot group in its "
          "row group")

    trainer = trainer_lib.RLGANNetTrainer(cfg, device=device)
    epoch, phase = trainer.load_checkpoint("autoencoder_best")
    expect((epoch, phase) == (191, "autoencoder"),
           f"autoencoder_best's meta {epoch}, {phase}")
    ae_m = trainer.model["ae"]
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    val = trainer._validate_ae(ae_m["params"], ae_m["state"])
    torch.cuda.synchronize()
    times["validate s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gfvs = trainer.generate_gfvs()
    torch.cuda.synchronize()
    times["generate_gfvs s"] = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    print(f"data-path launches: {counts}")
    print(f"autoencoder_best val Chamfer on the card: {val:.6f} (JAX f32 "
          f"{VAL_F32_JAX}, tol {TOL_VAL:.0%}; {len(trainer.val_loader)} "
          f"batches in {times['validate s']:.2f}s, {card})")
    expect(abs(val / VAL_F32_JAX - 1) <= TOL_VAL,
           f"val Chamfer {val} is not within {TOL_VAL:.0%} of {VAL_F32_JAX}")
    streams = {}
    for stream in (trainer_lib.JOINT_VAL_HOLES, trainer_lib.GATE_HOLES):
        with _patched(trainer_lib, "AE_VAL_HOLES", stream):
            streams[stream] = trainer._validate_ae(ae_m["params"],
                                                   ae_m["state"])
    with _patched(chamfer, "_nearest_forward", nearest_bf16_cross):
        bf16 = trainer._validate_ae(ae_m["params"], ae_m["state"])
    print("val Chamfer under the other hole streams: " + ", ".join(
        f"{k} {v:.6f}" for k, v in streams.items())
        + f"; with the cross term in bf16 (plain): {bf16:.6f} (the TPU's "
        f"{VAL_BF16_TPU}, tol {TOL_VAL:.0%})")
    expect(len({val, *streams.values()}) == 3,
           "two hole streams gave the same val Chamfer")
    expect(abs(bf16 / VAL_BF16_TPU - 1) <= TOL_VAL,
           f"bf16 cross term: {bf16} is not within {TOL_VAL:.0%} of "
           f"{VAL_BF16_TPU}")

    committed = np.load(TRAINED_DIR / "gfv" / "gfvs_train.npz")["clean"]
    m = gfv_match(gfvs["clean"], committed, device)
    print(f"clean GFVs of {len(gfvs['clean'])} train clouds "
          f"({times['generate_gfvs s']:.2f}s) vs the committed "
          f"{len(committed)}: one to one {m['one_to_one']}, gaps of "
          f"{m['scale']:.4f} max {m['max']:.3e} (tol {TOL_GFV_MAX:g}), "
          f"99.9th percentile {m['p999']:.3e} (tol {TOL_GFV_P999:g}), "
          f"median {m['median']:.3e} (tol {TOL_GFV_MEDIAN:g}); smallest "
          f"second/nearest distance ratio {m['min_ratio']:.3f}")
    expect(len(gfvs["clean"]) == len(committed) and m["one_to_one"],
           "the clean GFVs do not match the committed ones one to one")
    expect(m["max"] <= TOL_GFV_MAX and m["p999"] <= TOL_GFV_P999
           and m["median"] <= TOL_GFV_MEDIAN,
           "the clean GFVs are too far from the committed ones")
    del trainer, gfvs
    shutil.rmtree(data)

    t0 = time.perf_counter()
    demo = subprocess.run(
        [sys.executable, "-m", "gan_rl_3d_tpu_torch.test_rl_gan_net"],
        cwd=repo, capture_output=True, text=True)
    times["test_rl_gan_net s"] = time.perf_counter() - t0
    print(demo.stdout.strip())
    expect(demo.returncode == 0
           and "All integration checks passed" in demo.stdout,
           f"test_rl_gan_net failed on the card:\n{demo.stderr}")
    print(f"data path times ({card}): " + json.dumps(
        {k: round(v, 3) for k, v in times.items()}))
    for name in DATA_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "data path")
    return counts


def _leaves(tree):
    from gan_rl_3d_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def tie_sharing():
    """(card, cpu, gaps) for one card-vs-CPU check: under the context
    manager ``card`` every K3 call's picks are recorded; under ``cpu`` the
    plain version takes the card's pick, call by call, where it differs
    from its own within TIE_GAP of the nearest squared distance (the rule
    of the K3 checks), and ``gaps`` collects those gaps. Both resolve a
    near-tie rightly, and a flipped pick moves a step's gradients by more
    than its arithmetic does: on the weights phase 1 trains here one tie
    (gap 5.96e-7) moved the AE step's gradients 5.8e-3 of the largest
    element on an H100, 3.8e-4 with the pick shared."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    kernel, picks, gaps = chamfer._nearest_forward, [], []

    def recorded(a, b, b_mask):
        dist, idx = kernel(a, b, b_mask)
        picks.append(idx.cpu().long())
        return dist, idx

    def shared(a, b, b_mask):
        expect(len(gaps) < len(picks), "the CPU ran more nearest-neighbour "
               "searches than the card")
        d2 = chamfer._sqdist(a.float(), b.float(), b_mask)
        dmin, own = d2.min(dim=-1)
        card = picks[len(gaps)].to(a.device)
        gap = d2.gather(-1, card[..., None])[..., 0] - dmin
        take = (card != own) & (gap <= TIE_GAP)
        gaps.append(gap[take].tolist())
        idx = torch.where(take, card, own)
        dmin = d2.gather(-1, idx[..., None])[..., 0]
        return torch.sqrt(torch.clamp(dmin, min=1e-12)), idx.to(torch.int32)

    return (_patched(chamfer, "_nearest_forward", recorded),
            _patched(chamfer, "_nearest_forward", shared), gaps)


def step_check(device, ae_model):
    """One f32 ae_train_step at B=8 on the card and on the CPU, from the
    same weights, batch and draws, near-tie picks shared
    (``tie_sharing``): the loss and every gradient."""
    from gan_rl_3d_tpu_torch.config import AETrainConfig
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train import steps
    from gan_rl_3d_tpu_torch.utils.tree import tree_map

    pc, _ = make_clouds(B_STEP_CHECK, N_MAIN, seed=20, device=device)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(21),
                                       B_STEP_CHECK, N_MAIN)
    on_card, on_cpu, gaps = tie_sharing()
    results = []
    for dev, ties in ((device, on_card), (torch.device("cpu"), on_cpu)):
        params = tree_map(lambda v: v.detach().to(dev).clone()
                          .requires_grad_(True), ae_model["params"])
        state = tree_map(lambda v: v.detach().to(dev), ae_model["state"])
        opt, _ = steps.make_ae_optimizer(params, AETrainConfig(), 1)
        with ties:
            _, m = steps.ae_train_step(
                params, state, opt,
                {"complete_pc": pc.to(dev),
                 "pad": torch.zeros(B_STEP_CHECK, device=dev)},
                {k: v.to(dev) for k, v in draws.items()},
                bn_stats="single_read_grouped")
        results.append((float(m["loss"]),
                        [p.grad.cpu() for p in _leaves(params)]))
    (loss, grads), (ref_loss, ref_grads) = results
    scale = max(float(g.abs().max()) for g in ref_grads)
    e = max(float((g - r).abs().max()) for g, r in zip(grads, ref_grads))
    e /= scale
    le = abs(loss - ref_loss) / abs(ref_loss)
    print(f"ae_train_step f32 B={B_STEP_CHECK}: loss card {loss:.7f} cpu "
          f"{ref_loss:.7f} (rel {le:.3e}, tol {TOL_STEP_LOSS:g}); gradients "
          f"{e:.3e} of max |grad| {scale:.3e} (tol {TOL_STEP_GRAD:g}); "
          f"{_ties_text(gaps)}")
    expect(le <= TOL_STEP_LOSS and e <= TOL_STEP_GRAD,
           "the f32 step on the card disagrees with the CPU")


def _ties_text(gaps: list) -> str:
    flat = [g for call in gaps for g in call]
    return (f"{len(flat)} near-tie picks of {len(gaps)} K3 calls shared "
            f"(squared-distance gaps {flat[:8]})")


def _rl_config(cfg):
    """The shipped recipe's phases 3-4 cut to the run: 1 LGAN epoch,
    RL_ITERS RL iterations, the critic warmup and actor ramp cut so the
    actor updates within them."""
    import dataclasses

    t = cfg.training
    return dataclasses.replace(cfg, training=dataclasses.replace(
        t, lgan=dataclasses.replace(t.lgan, epochs=1),
        rl_agent=dataclasses.replace(
            t.rl_agent, episodes=RL_ITERS * t.rl_agent.envs_per_step,
            actor_warmup=RL_WARMUP, actor_lr_ramp=RL_RAMP)))


def phase_rl(device, cfg):
    """Phases 2-4 of the curriculum at full width, as ``--phase lgan
    --resume autoencoder_best`` and ``--phase rl_agent`` run them, counted
    launch by launch; then ``rl_agent_final`` into a fresh trainer."""
    from gan_rl_3d_tpu_torch.convert import agent_to_numpy
    from gan_rl_3d_tpu_torch.models import rl_gan_net as net
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer

    cfg = _rl_config(cfg)
    trainer = RLGANNetTrainer(cfg, device=device)
    trainer.load_checkpoint("autoencoder_best")
    ckpt = Path(cfg.training.checkpoint_dir)
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    gfvs = trainer.generate_gfvs()
    n_train = len(trainer.train_loader.dataset)
    latent = cfg.model.lgan.latent_dim
    expect(all(v.shape == (n_train, latent) and np.isfinite(v).all()
               for v in gfvs.values()), "GFV extraction: wrong shapes or "
           "non-finite values")
    print(f"generate_gfvs: {n_train} (clean, noisy) pairs of {latent} in "
          f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    trainer.train_latent_gan()
    (g_loss, d_loss), = trainer.lgan_losses
    print(f"train_latent_gan: 1 epoch ({n_train // cfg.training.lgan.batch_size}"
          f" steps of {cfg.training.lgan.d_steps} D + 1 G) in "
          f"{time.perf_counter() - t0:.2f}s, G {g_loss:.6f} D {d_loss:.6f}")
    expect(np.isfinite([g_loss, d_loss]).all(), "non-finite LGAN loss")
    expect((ckpt / "lgan_best").exists(), "lgan_best was not written")
    actor = [v.detach().clone() for v in
             _leaves(trainer.model["agent"]["actor"]["params"])]
    t0 = time.perf_counter()
    trainer.train_rl_agent()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    hist = trainer.rl_history
    rewards = [h["reward"] for h in hist]
    losses = [(float(h["critic_loss"]), float(h["actor_loss"]))
              for h in hist]
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(
        _leaves(trainer.model["agent"]["actor"]["params"]), actor))
    print(f"train_rl_agent: {len(hist)} iterations, "
          f"{trainer.model['agent']['step']} TD3 updates in {dt:.2f}s; "
          f"rewards {[round(r, 4) for r in rewards]}, (critic, actor) "
          f"losses {[(round(c, 4), round(a, 4)) for c, a in losses]}, "
          f"greedy evals {[(e, round(r, 4), round(c, 5)) for e, r, c in trainer.rl_evals]}; "
          f"the actor moved {moved:.3e}")
    print(f"rl-path launches (phases 2-4): {counts}")
    expect(len(hist) == RL_ITERS and np.isfinite(rewards).all()
           and np.isfinite(losses).all(), "non-finite RL reward or loss")
    updates = cfg.training.rl_agent.updates_per_step
    expect(trainer.model["agent"]["step"] == (RL_ITERS - 3) * updates,
           "wrong number of TD3 updates")
    expect(moved > 0, "the actor did not change")
    for name in RL_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the RL "
               "path")
    fresh = RLGANNetTrainer(cfg, device=device)
    fresh.load_checkpoint("rl_agent_final")
    for a, b in zip(_leaves(agent_to_numpy(trainer.model["agent"])),
                    _leaves(agent_to_numpy(fresh.model["agent"]))):
        expect(np.array_equal(a, b), "rl_agent_final reloads differently")
    pc, mask = make_clouds(8, N_MAIN, seed=30, device=device)
    out = net.complete(fresh.model, pc, mask, cfg=fresh.td3)
    expect(out["hybrid_output"].shape == (8, N_MAIN, 3) and all(
        bool(torch.isfinite(v).all()) for v in out.values()),
        "complete on rl_agent_final: wrong shape or non-finite")
    print("rl_agent_final reloaded bit for bit into a fresh trainer; "
          "complete ran on it")
    return counts, trainer


def rl_checks(device, trainer):
    """One lgan_combined_step, one agent_update and one rl_step (64
    updates) at full width on the card and on CPU copies, from the same
    weights, optimizer state, buffer and draws."""
    from gan_rl_3d_tpu_torch.models import rl_agent as rl
    from gan_rl_3d_tpu_torch.train import replay_buffer as rb
    from gan_rl_3d_tpu_torch.train import steps

    cpu = torch.device("cpu")
    cfg, td3 = trainer.config, trainer.td3
    lc = cfg.training.lgan
    rng = np.random.RandomState(40)
    real = [torch.from_numpy(trainer.gfvs["clean"][rng.randint(
        0, len(trainer.gfvs["clean"]), (lc.d_steps, lc.batch_size))])
        for _ in range(2)]
    warm = lgan_warm(trainer.model["lgan"], cfg, real[0], seed=41)
    draws = lgan_draws(cfg, seed=42)
    start = {k: {part: warm[0][part][k] for part in ("params", "state")}
             for k in ("generator", "discriminator")}
    (sm, card), (ref_m, ref) = (lgan_step_on(dev, warm, cfg, real[1], draws)
                                for dev in (device, cpu))
    le = {k: _rel(sm[k], ref_m[k]) for k in ("d_loss", "g_loss")}
    errs = {k: network_errs(card[k], ref[k], start[k]) for k in card}
    tol_noise = 2 * lc.generator_lr * lc.d_steps
    print(f"lgan_combined_step B={lc.batch_size} d_steps={lc.d_steps}: card "
          f"vs CPU, losses " + ", ".join(
              f"{k} {float(sm[k]):.6f} / {float(ref_m[k]):.6f} ({e:.3e})"
              for k, e in le.items()) + f" (tol {TOL_RL_LOSS:g} of max(1, "
          f"|loss|)); {_errs_text(errs)} ({_TOL_TEXT}, "
          f"Adam-noise leaves {tol_noise:g} absolute)")
    expect(max(le.values()) <= TOL_RL_LOSS
           and _errs_ok(errs.values(), tol_noise),
           "lgan_combined_step: the card disagrees with the CPU")
    # the update check's power: the same step on the card with lr 0
    _, frozen = lgan_step_on(device, warm, cfg, real[1], draws, lr_scale=0.0)
    power = {k: network_errs(frozen[k], ref[k], start[k])[0] for k in card}
    print("lgan_combined_step with lr 0 on the card: update error "
          + ", ".join(f"{k} {e:.3e}" for k, e in power.items())
          + f" (must exceed {TOL_RL_UPDATE:g})")
    expect(min(power.values()) > TOL_RL_UPDATE,
           "lgan_combined_step: the update check passes a step with lr 0")

    batch = random_transitions(td3.batch_size, td3, 42, cpu)
    noise = torch.randn((td3.batch_size, td3.action_dim),
                        generator=torch.Generator().manual_seed(43))
    frozen_cfg = td3._replace(actor_lr=0.0, critic_lr=0.0)
    agents, ms = {}, {}
    for key, dev, c in ((device.type, device, td3), ("cpu", cpu, td3),
                        ("frozen", device, frozen_cfg)):
        agents[key] = _agent_copy(trainer.model["agent"], dev, c)
        _, ms[key] = rl.agent_update(
            agents[key], rl.TransitionBatch(*(v.to(dev) for v in batch)),
            noise.to(dev), c)
    le = max(_rel(ms[device.type][k], ms["cpu"][k])
             for k in ("critic_loss", "actor_loss"))
    print(f"agent_update B={td3.batch_size} (step {agents['cpu']['step']}): "
          f"losses card vs CPU {le:.3e} of max(1, |loss|) (tol "
          f"{TOL_RL_LOSS:g})")
    expect(le <= TOL_RL_LOSS, "agent_update: losses differ")
    start = trainer.model["agent"]
    _check_agents("agent_update", agents[device.type], agents["cpu"], start,
                  1, td3.critic_lr)
    power = {n: network_errs(agents["frozen"][n], agents["cpu"][n],
                             start[n])[0] for n in rl.NETWORKS}
    print("agent_update with lr 0 on the card: update error " + ", ".join(
        f"{n} {e:.3e}" for n, e in power.items())
        + f" (the critics' must exceed {TOL_RL_UPDATE:g})")
    expect(min(power["critic1"], power["critic2"]) > TOL_RL_UPDATE,
           "agent_update: the update check passes a step with lr 0")

    rc = cfg.training.rl_agent
    envs = rc.envs_per_step
    pc, _ = make_clouds(envs, N_MAIN, seed=44, device=cpu)
    pre = random_transitions(RL_PREFILL, td3, 45, cpu)
    start = agent_warm(trainer.model["agent"], td3, seed=47)
    rl_draws = steps.draw_rl_step(
        torch.Generator().manual_seed(46), envs, N_MAIN, cfg=td3,
        buffer_size=RL_PREFILL + envs, updates_per_step=rc.updates_per_step,
        spec=trainer.preproc)
    res = {}
    for dev in (device, cpu):
        model = {**{k: _on(trainer.model[k], dev) for k in ("ae", "lgan")},
                 "agent": _agent_copy(start, dev, td3)}
        buf = rb.ReplayBuffer(cfg.model.rl_agent.buffer_size,
                              td3.state_dim, td3.action_dim, dev)
        buf.add_batch(rl.TransitionBatch(*(v.to(dev) for v in pre)))
        t0 = time.perf_counter()
        model, buf, ou, sm = steps.rl_step(
            model, buf, rl.ou_init(td3, (envs,), dev),
            {"complete_pc": pc.to(dev), "pad": torch.zeros(envs, device=dev)},
            _on(rl_draws, dev), cfg=td3, w_chamfer=cfg.loss.w_chamfer,
            w_gfv=cfg.loss.w_gfv, w_discriminator=cfg.loss.w_discriminator,
            start_training_size=rc.start_training_steps,
            updates_per_step=rc.updates_per_step, spec=trainer.preproc)
        rows = {name: getattr(buf, name)[:RL_PREFILL + envs]
                for name in rb.FIELDS}
        res[dev.type] = (model, rows, ou, sm, time.perf_counter() - t0)
    (model, rows, ou, sm, dt), (r_model, r_rows, r_ou, r_sm, r_dt) = (
        res[device.type], res["cpu"])
    le = max(_rel(sm[k], r_sm[k]) for k in ("reward", "critic_loss",
                                             "actor_loss"))
    be = max(scaled_err(rows[k].cpu(), r_rows[k]) for k in rows)
    oe = scaled_err(ou.cpu(), r_ou)
    print(f"rl_step {envs} envs, {rc.updates_per_step} updates (card "
          f"{dt:.2f}s, CPU {r_dt:.2f}s): reward {float(sm['reward']):.5f} "
          f"card, {float(r_sm['reward']):.5f} CPU; reward and losses "
          f"{le:.3e} of max(1, |value|) (tol {TOL_RL_LOSS:g}), buffer rows "
          f"{be:.3e} "
          f"and OU state {oe:.3e} scaled (tol {TOL_RL_PARAM:g})")
    expect(le <= TOL_RL_LOSS and be <= TOL_RL_PARAM and oe <= TOL_RL_PARAM,
           "rl_step: the card disagrees with the CPU")
    _check_agents("rl_step", model["agent"], r_model["agent"], start,
                  rc.updates_per_step, td3.critic_lr)


def agent_warm(agent, td3, seed):
    """The agent on the CPU after ``policy_delay`` TD3 updates on random
    transitions, one of them the actor's, so every element of every
    network's Adam holds moments (``lgan_warm`` says why): the trained
    agent's elements that no training state fed (an input channel the
    encoder left at 0 on the training clouds) are fresh, and a fresh
    element's first step is lr times the sign of its gradient, which flips
    between two devices where a ReLU kink moves the gradient through 0
    (on an H100: one element of the actor's first layer moved the
    rl_step's actor update 2.4e-2 of the CPU's)."""
    from gan_rl_3d_tpu_torch.models import rl_agent as rl

    cpu = torch.device("cpu")
    warm = _agent_copy(agent, cpu, td3)
    for i in range(td3.policy_delay):
        rl.agent_update(
            warm, random_transitions(td3.batch_size, td3, seed + i, cpu),
            torch.randn((td3.batch_size, td3.action_dim),
                        generator=torch.Generator().manual_seed(seed + i)),
            td3)
    return warm


def lgan_draws(cfg, seed):
    """The draws of one ``lgan_combined_step`` at ``cfg``'s widths."""
    from gan_rl_3d_tpu_torch.train import steps
    lc, m = cfg.training.lgan, cfg.model.lgan
    return steps.draw_lgan_combined(torch.Generator().manual_seed(seed),
                                     lc.batch_size, m.z_dim,
                                     m.discriminator_dims, lc.d_steps)


def lgan_warm(lgan, cfg, real, seed):
    """The LGAN ``{"params", "state"}`` on the CPU after one
    ``lgan_combined_step`` on ``real`` (d_steps, B, latent), and the G and
    D Adam states it built. A fresh Adam's first step moves each element
    by lr times the sign of its gradient, so an element whose gradient is
    at the rounding level flips between two devices; from moments one
    step old the update is a smooth function of the gradient
    (adam_probe.py measures both)."""
    from gan_rl_3d_tpu_torch.train import steps
    lc = cfg.training.lgan
    params = _on(lgan["params"], torch.device("cpu"), grad=True)
    state = _on(lgan["state"], torch.device("cpu"))
    g_opt = steps.make_gan_optimizer(params["generator"], lc.generator_lr, lc)
    d_opt = steps.make_gan_optimizer(params["discriminator"],
                                     lc.discriminator_lr, lc)
    state, _ = steps.lgan_combined_step(params, state, d_opt, g_opt, real,
                                        lgan_draws(cfg, seed),
                                        lambda_gp=lc.lambda_gp)
    return ({"params": params, "state": state}, g_opt.state_dict(),
            d_opt.state_dict())


def lgan_step_on(dev, warm, cfg, real, draws, lr_scale=1.0, mesh=None):
    """One ``lgan_combined_step`` on ``dev`` from ``lgan_warm``'s
    weights, state and Adam states, with lr times ``lr_scale``: (metrics,
    {"generator", "discriminator"} each {"params", "state"}). Under
    ``mesh`` ``real`` is this rank's rows and ``draws`` the global
    batch's."""
    import copy

    from gan_rl_3d_tpu_torch.train import steps
    lc = cfg.training.lgan
    lgan, g_sd, d_sd = warm
    params = _on(lgan["params"], dev, grad=True)
    state = _on(lgan["state"], dev)
    opts = {}
    for k, sd, lr in (("generator", g_sd, lc.generator_lr),
                      ("discriminator", d_sd, lc.discriminator_lr)):
        opts[k] = steps.make_gan_optimizer(params[k], lr, lc)
        # a copy: on the CPU load_state_dict would share the step counts
        opts[k].load_state_dict(copy.deepcopy(sd))
        for group in opts[k].param_groups:
            group["lr"] = lr * lr_scale
    state, sm = steps.lgan_combined_step(
        params, state, opts["discriminator"], opts["generator"], real.to(dev),
        _on(draws, dev), lambda_gp=lc.lambda_gp, mesh=mesh)
    return sm, {k: {"params": params[k], "state": state[k]}
                for k in ("generator", "discriminator")}


def _named_leaves(tree, path=()):
    """(path, tensor) of every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def adam_noise(path, tree) -> bool:
    """Whether the leaf at ``path`` of ``tree`` (a network's params, state
    or Adam moments) is one Adam makes noise of: the bias of a dense layer
    that feeds a training BatchNorm (a ``bn_mlp`` block with a "bn" entry;
    the adaptive decoder's refinement conv1; the critic's state_fc,
    comb_fc1, comb_fc2) and the BN running means that take it in.
    tests/test_torch_port_rl.py and tests/test_torch_port_lgan.py hold the
    same leaves loosely."""
    if path[-1] == "mean":
        return True
    if path[-1] != "b":
        return False
    if path[-2] in ("state_fc", "comb_fc1", "comb_fc2"):
        return True
    node = tree
    for k in path[:-2]:
        node = node[k]
    return path[-2] in ("dense", "conv1") and "bn" in node


def network_errs(card: dict, cpu: dict, start: dict) -> tuple:
    """A network {"params", "state"} after a step on the card against its
    CPU copy after the same step from ``start``: (the update's error,
    |(card - start) - (cpu - start)| / |cpu - start| in the 2-norm over
    the parameters that are not Adam noise; the worst state leaf's error
    relative to its own largest element, and its path; the Adam-noise
    leaves' largest absolute error). A network that the CPU left where it
    was reads 0 when the card did too."""
    diff = moved = state_err = noise = 0.0
    worst = None
    for part in ("params", "state"):
        for (path, a), (_, b), (_, s0) in zip(_named_leaves(card[part]),
                                              _named_leaves(cpu[part]),
                                              _named_leaves(start[part])):
            a, b, s0 = (v.detach().cpu().double() for v in (a, b, s0))
            if adam_noise(path, card[part]):
                noise = max(noise, float((a - b).abs().max()))
            elif part == "params":
                diff += float((a - b).square().sum())
                moved += float((b - s0).square().sum())
            else:
                e = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                if e >= state_err:
                    state_err, worst = e, path
    update = ((diff / moved) ** 0.5 if moved
              else 0.0 if diff == 0 else float("inf"))
    return update, state_err, worst, noise


_TOL_TEXT = (f"update tol {TOL_RL_UPDATE:g} of the CPU's, state tol "
             f"{TOL_RL_PARAM:g} of each leaf's largest element")


def _errs_text(errs: dict) -> str:
    return ", ".join(f"{k} update {u:.3e}, state {s:.3e} "
                     f"{'.'.join(map(str, p or ()))}, noise {z:.3e}"
                     for k, (u, s, p, z) in errs.items())


def _errs_ok(errs, tol_noise) -> bool:
    return all(u <= TOL_RL_UPDATE and s <= TOL_RL_PARAM and z <= tol_noise
               for u, s, _, z in errs)


def _on(tree, dev, grad=False):
    """A copy of a tree of tensors (or None leaves) on ``dev``; with
    ``grad`` its leaves take a gradient."""
    from gan_rl_3d_tpu_torch.utils.tree import tree_map
    return tree_map(lambda v: v.detach().to(dev).clone().requires_grad_(grad),
                    tree)


def _agent_copy(agent, dev, td3):
    from gan_rl_3d_tpu_torch.convert import agent_from_numpy, agent_to_numpy
    return agent_from_numpy(agent_to_numpy(agent), td3, device=dev)


def _check_agents(what, card, cpu, start, n_updates, lr):
    """Every network and target of an agent after a step on the card
    against its CPU copy after the same step from the agent ``start``."""
    from gan_rl_3d_tpu_torch.models import rl_agent as rl
    tol_noise = 2 * lr * n_updates
    errs = {name: network_errs(card[name], cpu[name], start[name])
            for name in rl.NETWORKS + tuple(n + "_target"
                                            for n in rl.NETWORKS)}
    print(f"{what}: card vs CPU, per network {_errs_text(errs)} "
          f"({_TOL_TEXT}, Adam-noise leaves {tol_noise:g} absolute)")
    expect(_errs_ok(errs.values(), tol_noise),
           f"{what}: the card disagrees with the CPU")
    expect(card["step"] == cpu["step"], f"{what}: step differs")


def _rel(a, b) -> float:
    """|a - b| / max(1, |b|) of two scalars: relative, absolute for O(1)
    values (a loss near 0 is a difference of terms of order 1)."""
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1.0)


def random_transitions(n, td3, seed, device):
    """n transitions of the RL phase's shapes: GFV-scale states, actions in
    [-1, 1], rewards about the reward's scale, done."""
    from gan_rl_3d_tpu_torch.models import rl_agent as rl
    g = torch.Generator().manual_seed(seed)
    batch = rl.TransitionBatch(
        states=0.5 * torch.randn(n, td3.state_dim, generator=g),
        actions=torch.tanh(torch.randn(n, td3.action_dim, generator=g)),
        rewards=-20.0 + torch.randn(n, 1, generator=g),
        next_states=0.5 * torch.randn(n, td3.state_dim, generator=g),
        dones=torch.ones(n, 1))
    return rl.TransitionBatch(*(v.to(device) for v in batch))


# ---------------------------------------------------------------------------
# phases 5 and 5.5: the joint fine-tune, the D refresh, the gate
# ---------------------------------------------------------------------------


def _joint_config(cfg, tmp: Path):
    """The recipe's joint block cut to the run (JOINT_EPOCHS,
    JOINT_REFRESH); evaluate's report under ``tmp``."""
    import dataclasses

    t = cfg.training
    return dataclasses.replace(cfg, training=dataclasses.replace(
        t, results_dir=str(tmp / "results_joint"),
        joint=dataclasses.replace(t.joint, epochs=JOINT_EPOCHS,
                                  refresh_d_steps=JOINT_REFRESH)))


class _Tee(io.StringIO):
    """Standard output kept as well as printed."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def captured(fn, *args):
    """(fn(*args), what it printed)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn(*args)
    return result, tee.getvalue()


def _rewritten(folder: Path, names, fn):
    """Run ``fn`` after dating the files ``names`` back to 2001: the set of
    those it rewrote."""
    import os

    old = 10 ** 18
    for n in names:
        os.utime(folder / n, ns=(old, old))
    fn()
    return {n for n in names if os.stat(folder / n).st_mtime_ns != old}


def phase_joint(device, cfg, tmp: Path):
    """Phases 5 and 5.5 at full width from phase 4's ``rl_agent_final``,
    counted launch by launch as one path: the trainer as ``--phase joint``
    drives it (``joint_training``, then ``post_joint_refresh``), then the
    default command (``--phase full --resume rl_agent_final``), then the
    calibrated ``final`` served (``evaluate --checkpoint final
    --export-engine``, ``complete_clouds --checkpoint final`` and
    ``--engine``)."""
    import dataclasses

    from gan_rl_3d_tpu_torch import complete_clouds, evaluate
    from gan_rl_3d_tpu_torch import train_rl_gan_net
    from gan_rl_3d_tpu_torch.config import load_config
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.data.dataset import load_ply
    from gan_rl_3d_tpu_torch.models import rl_gan_net as net
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.train import gate as gate_lib
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
    from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = _joint_config(cfg, tmp)
    jc = cfg.training.joint
    ckpt = Path(cfg.training.checkpoint_dir)
    cfg_path = tmp / "joint.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(cfg)))
    expect(load_config(str(cfg_path)) == cfg, "config JSON round trip")
    trainer = RLGANNetTrainer(cfg, device=device)
    trainer.load_checkpoint("rl_agent_final")
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    best = trainer.joint_training()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_steps = len(trainer.train_loader) * JOINT_EPOCHS
    print(f"joint_training: {JOINT_EPOCHS} epoch of {n_steps} steps at "
          f"B={cfg.training.batch_size} ({cfg.training.precision}, lr "
          f"{jc.lr:g}, wd {jc.weight_decay:g}, w_ae_recon {jc.w_ae_recon:g}) "
          f"in {dt:.2f}s with validation; (train, val) losses "
          f"{trainer.joint_losses}, best val {best:.6f}")
    expect(len(trainer.joint_losses) == JOINT_EPOCHS
           and np.isfinite(trainer.joint_losses).all() and np.isfinite(best),
           "non-finite or missing joint loss")
    t0 = time.perf_counter()
    trainer.post_joint_refresh()
    torch.cuda.synchronize()
    report = trainer.gate_report
    d_losses = trainer.refresh_d_losses
    print(f"post_joint_refresh: {len(d_losses)} D refresh steps (loss "
          f"{d_losses[0]:.4f} -> {d_losses[-1]:.4f}) and the gate "
          f"calibration in {time.perf_counter() - t0:.2f}s; report {report}")
    expect(len(d_losses) == JOINT_REFRESH and np.isfinite(d_losses).all(),
           "non-finite or missing D refresh loss")
    for name in ("joint_best", "joint_calibrated", gate_lib.GATE_FILE):
        expect((ckpt / name).is_file(), f"{name} was not written")
    sidecar = json.loads((ckpt / gate_lib.GATE_FILE).read_text())
    expect(sidecar == report and report["checkpoints"]
           == ["joint_calibrated", "final"], f"gate sidecar {sidecar}")
    expect(report["val_chamfer_calibrated"] <= min(
        report["val_chamfer_raw_gate"], report["val_chamfer_rl"],
        report["val_chamfer_ae"]), "the calibrated gate is worse than a "
        "fixed one")
    _refresh_changed_only_d(ckpt_lib, ckpt)

    # the default command: the JAX trainer's rule restarts at the phase the
    # checkpoint records (phase 4 for rl_agent_final), so phases 1-3 are
    # skipped and phase 4 runs again before phases 5 and 5.5
    before = sorted(p.name for p in ckpt.iterdir() if p.is_file()
                    and p.name.startswith(("autoencoder", "lgan", "rl_agent",
                                           "joint", "final")))
    t0 = time.perf_counter()
    written = _rewritten(ckpt, before, lambda: train_rl_gan_net.main(
        ["--config", str(cfg_path), "--phase", "full", "--resume",
         "rl_agent_final", "--device", device.type]))
    print(f"train_rl_gan_net --phase full --resume rl_agent_final in "
          f"{time.perf_counter() - t0:.2f}s rewrote {sorted(written)} of "
          f"{before}")
    expect(not any(n.startswith(("autoencoder", "lgan")) for n in written),
           "--phase full --resume rl_agent_final reran phases 1-3")
    expect({"rl_agent_final", "joint_best", "joint_calibrated"} <= written
           and (ckpt / "final").is_file(), "--phase full --resume "
           "rl_agent_final did not run phases 4-5.5 and write final")
    report = json.loads((ckpt / gate_lib.GATE_FILE).read_text())
    expect(report["checkpoints"] == ["joint_calibrated", "final"],
           f"gate sidecar after the full run: {report}")

    # serving the calibrated final
    gate = (report["gate_mode"], report["gate_bias"])
    calibrated = gate != (cfg.model.gate_mode, cfg.model.gate_bias)
    line = f"using calibrated gate: mode={gate[0]} bias={gate[1]:.4f}"
    engine_path = tmp / "engine_final.pkl"
    inputs = write_scans(tmp / "scans_joint", seed=8)
    t0 = time.perf_counter()
    stats, out = captured(evaluate.main, [
        "--config", str(cfg_path), "--checkpoint", "final", "--num-export",
        "2", "--export-engine", str(engine_path), "--device", device.type])
    expect(len(stats) >= 5 and all(np.isfinite(v) for v in stats.values()),
           f"evaluate --checkpoint final: non-finite or missing {stats}")
    expect((line in out) == calibrated, f"evaluate did not report the "
           f"calibrated gate {gate}")
    print(f"evaluate --checkpoint final in {time.perf_counter() - t0:.2f}s "
          f"with the gate {gate}: " + ", ".join(
              f"{k}={v:.6f}" for k, v in stats.items()))
    for args in (["--checkpoint", "final"], ["--engine", str(engine_path)]):
        _, out = captured(serve_files, inputs,
                          tmp / f"out_joint_{args[0][2:]}",
                          [*args, "--config", str(cfg_path), "--device",
                           device.type], N_MAIN)
        expect((line in out) == calibrated, f"complete_clouds {args[0]} "
               f"did not report the calibrated gate {gate}")
    # used, not only printed: the checkpoint's completion of the first scan
    # is complete() with the sidecar's gate, in the scan's frame
    tree, _ = ckpt_lib.load_model_checkpoint(str(ckpt), "final")
    pc, mask, (centroid, scale) = complete_clouds._load_framed(
        str(inputs[0]), N_MAIN, np.random.RandomState(0))
    ref = net.complete(model_from_numpy(tree, device=device),
                       torch.from_numpy(pc[None]).to(device),
                       torch.from_numpy(mask[None]).to(device),
                       cfg=cfg.td3_config(), gate_mode=gate[0],
                       gate_bias=gate[1])["hybrid_output"][0].cpu().numpy()
    served = load_ply(tmp / "out_joint_checkpoint"
                      / f"{inputs[0].stem}_completed.ply")
    err = float(np.abs(served - (ref * scale + centroid)).max()) / scale
    print(f"complete_clouds --checkpoint final and --engine served "
          f"{len(inputs)} files each; the first against complete() with the "
          f"sidecar's gate: {err:.3e} (tol {TOL_F32:g})")
    expect(err <= TOL_F32, "complete_clouds --checkpoint final did not use "
           "the calibrated gate")
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    print(f"joint-path launches (phases 5-5.5, --phase full, serving final): "
          f"{counts}")
    for name in JOINT_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "joint path")
    return counts, trainer


def _refresh_changed_only_d(ckpt_lib, ckpt: Path) -> None:
    """``joint_calibrated`` against ``joint_best``: the refresh changed D
    (its weights and spectral-norm vectors) and nothing else, but the
    generator's BN running statistics, which the D steps' training-mode
    generator advances (the JAX refresh keeps them too)."""
    best, _ = ckpt_lib.load_model_checkpoint(str(ckpt), "joint_best")
    cal, _ = ckpt_lib.load_model_checkpoint(str(ckpt), "joint_calibrated")
    changed = sorted(".".join(map(str, p)) for (p, a), (_, b) in zip(
        _named_leaves(best), _named_leaves(cal))
        if not np.array_equal(np.asarray(a), np.asarray(b)))
    allowed = ("lgan.params.discriminator.", "lgan.state.discriminator.",
               "lgan.state.generator.")
    print(f"D refresh: {len(changed)} leaves changed, "
          f"{sum(c.startswith(allowed[0]) for c in changed)} of them D's "
          "weights")
    expect(all(c.startswith(allowed) for c in changed)
           and any(c.startswith(allowed[0]) for c in changed),
           f"the D refresh changed more than D: {changed}")


def _joint_model(model, dev):
    """A copy of what the joint step reads (ae, lgan, the actor) on
    ``dev``, its ae and lgan parameters taking a gradient."""
    out = {k: {"params": _on(model[k]["params"], dev, grad=True),
               "state": _on(model[k]["state"], dev)} for k in ("ae", "lgan")}
    out["agent"] = {"actor": _on(model["agent"]["actor"], dev)}
    return out


def _joint_networks(model):
    """{"encoder", "decoder", "generator"}, each {"params", "state"}."""
    ae, lgan = model["ae"], model["lgan"]
    return {"encoder": {p: ae[p]["encoder"] for p in ("params", "state")},
            "decoder": {p: ae[p]["decoder"] for p in ("params", "state")},
            "generator": {p: lgan[p]["generator"]
                          for p in ("params", "state")}}


def _joint_kw(trainer, precision="float32"):
    from gan_rl_3d_tpu_torch.train import steps
    jc = trainer.config.training.joint
    dtype, selective = steps.compute_dtype_of(precision)
    return dict(cfg=trainer.td3, compute_dtype=dtype, selective=selective,
                spec=trainer.preproc, bidirectional=trainer.bidirectional,
                w_ae_recon=jc.w_ae_recon, bn_stats=trainer.bn_stats,
                freeze_generator=jc.freeze_generator)


def joint_batch(trainer, seed, bsz=B_STEP_CHECK):
    """A batch of ``bsz`` full-width clouds and its draws (holes and
    augmentation), on the CPU."""
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    pc, _ = make_clouds(bsz, N_MAIN, seed=seed, device=torch.device("cpu"))
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(seed),
                                       bsz, N_MAIN, spec=trainer.preproc)
    return {"complete_pc": pc, "pad": torch.zeros(bsz)}, draws


def joint_warm(trainer, seed):
    """The joint model on the CPU after one f32 ``joint_train_step`` from
    the trainer's, and its Adam's state: moments one step old (a fresh
    Adam's first step is lr x sign(gradient), see lgan_warm)."""
    from gan_rl_3d_tpu_torch.train import steps
    cpu = torch.device("cpu")
    jc = trainer.config.training.joint
    model = _joint_model(trainer.model, cpu)
    opt = steps.make_joint_optimizer(
        steps.joint_trainable(model, jc.freeze_generator), jc)
    model, _ = steps.joint_train_step(model, opt, *joint_batch(trainer, seed),
                                      **_joint_kw(trainer))
    return model, opt.state_dict()


def joint_step_on(dev, warm, trainer, batch, draws, lr_scale=1.0):
    """One f32 ``joint_train_step`` on ``dev`` from ``joint_warm``'s model
    and Adam state, lr times ``lr_scale``: (metrics, _joint_networks)."""
    import copy

    from gan_rl_3d_tpu_torch.train import steps
    jc = trainer.config.training.joint
    model = _joint_model(warm[0], dev)
    opt = steps.make_joint_optimizer(
        steps.joint_trainable(model, jc.freeze_generator), jc)
    opt.load_state_dict(copy.deepcopy(warm[1]))
    for group in opt.param_groups:
        group["lr"] = jc.lr * lr_scale
    model, m = steps.joint_train_step(model, opt, _on(batch, dev),
                                      _on(draws, dev), **_joint_kw(trainer))
    return m, _joint_networks(model)


def joint_checks(device, trainer):
    """``joint_step_check``, then ``gate_stats_step`` on a val batch, card
    against CPU."""
    from gan_rl_3d_tpu_torch.train import gate as gate_lib
    from gan_rl_3d_tpu_torch.train import trainer as trainer_lib

    cpu = torch.device("cpu")
    joint_step_check(device, trainer)
    vb = next(iter(trainer.val_loader))
    vbatch = {"complete_pc": torch.from_numpy(vb["complete_pc"]),
              "pad": torch.from_numpy(vb["pad"])}
    vdraws = _on(trainer._fixed_holes(trainer_lib.GATE_HOLES, 0,
                                      *vbatch["complete_pc"].shape[:2]), cpu)
    model_cpu = {k: _on(trainer.model[k], cpu) for k in ("ae", "lgan")}
    model_cpu["agent"] = {"actor": _on(trainer.model["agent"]["actor"], cpu)}
    if "gan_path" in trainer.model:
        model_cpu["gan_path"] = _on(trainer.model["gan_path"], cpu)
    kw = dict(cfg=trainer.td3, spec=trainer.preproc,
              bidirectional=trainer.bidirectional)
    gs = gate_lib.gate_stats_step(trainer.model, _on(vbatch, device),
                                  _on(vdraws, device), **kw)
    ref_gs = gate_lib.gate_stats_step(model_cpu, vbatch, vdraws, **kw)
    cd = max(scaled_err(gs[k].cpu(), ref_gs[k]) for k in ("cd_rl", "cd_ae"))
    me = (float((gs["margin"].cpu() - ref_gs["margin"]).abs().max())
          / float(ref_gs["margin"].abs().max()))
    print(f"gate_stats_step B={vbatch['pad'].shape[0]}: card vs CPU, "
          f"Chamfer distances {cd:.3e} scaled (tol {TOL_F32:g}), margins "
          f"{me:.3e} of the largest (tol {TOL_GATE_MARGIN:g})")
    expect(cd <= TOL_F32 and me <= TOL_GATE_MARGIN,
           "gate_stats_step: the card disagrees with the CPU")


def joint_step_check(device, trainer):
    """One f32 ``joint_train_step`` at B=8, full width, on the card and on
    CPU copies from the same weights, draws and Adam moments one step old:
    the loss, each network's update, its state; lr 0 and twice the lr on
    the card must fail the update check."""
    cpu = torch.device("cpu")
    jc = trainer.config.training.joint
    warm = joint_warm(trainer, seed=60)
    start = _joint_networks(warm[0])
    batch, draws = joint_batch(trainer, seed=61)
    (sm, card), (ref_m, ref) = (joint_step_on(dev, warm, trainer, batch,
                                              draws) for dev in (device, cpu))
    le = {k: _rel(sm[k], ref_m[k]) for k in ("loss", "chamfer", "gfv")}
    errs = {k: network_errs(card[k], ref[k], start[k]) for k in card}
    tol_noise = 2 * jc.lr
    print(f"joint_train_step f32 B={B_STEP_CHECK}: card vs CPU, " + ", ".join(
        f"{k} {float(sm[k]):.6f} / {float(ref_m[k]):.6f} ({e:.3e})"
        for k, e in le.items()) + f" (tol {TOL_RL_LOSS:g} of max(1, "
        f"|value|)); {_errs_text(errs)} (update tol {TOL_JOINT_UPDATE:g} of "
        f"the CPU's, state tol {TOL_RL_PARAM:g} of each leaf's largest "
        f"element, Adam-noise leaves {tol_noise:g} absolute)")
    shifted = dict(batch, complete_pc=batch["complete_pc"] * (1.0 + 1e-7))
    _, floor = joint_step_on(cpu, warm, trainer, shifted, draws)
    print("joint_train_step CPU against itself with the input clouds scaled "
          "by 1 + 1e-7: update error " + ", ".join(
              f"{k} {network_errs(floor[k], ref[k], start[k])[0]:.3e}"
              for k in ref))
    expect(max(le.values()) <= TOL_RL_LOSS and all(
        u <= TOL_JOINT_UPDATE and s <= TOL_RL_PARAM and z <= tol_noise
        for u, s, _, z in errs.values()),
        "joint_train_step: the card disagrees with the CPU")
    for scale in (0.0, 2.0):
        _, wrong = joint_step_on(device, warm, trainer, batch, draws,
                                 lr_scale=scale)
        power = {k: network_errs(wrong[k], ref[k], start[k])[0]
                 for k in card}
        print(f"joint_train_step with lr x {scale:g} on the card: update "
              "error " + ", ".join(f"{k} {e:.3e}" for k, e in power.items())
              + f" (must exceed {TOL_JOINT_UPDATE:g})")
        expect(min(power.values()) > TOL_JOINT_UPDATE, "joint_train_step: "
               f"the update check passes a step with lr x {scale:g}")


# ---------------------------------------------------------------------------
# the attention-encoder / adaptive-decoder family
# ---------------------------------------------------------------------------


def _variant_config(cfg, tmp: Path):
    """The recipe with runs/variant/config_variant.yaml's model block (the
    attention encoder, the adaptive decoder; the flagship's widths) and
    the joint path's cuts: 1 AE epoch (2 steps at B=64), 1 LGAN epoch,
    VARIANT_RL_ITERS RL iterations, the joint block as JOINT_EPOCHS /
    JOINT_REFRESH; its checkpoints, metrics and report under ``tmp``."""
    import dataclasses

    t = cfg.training
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, autoencoder=dataclasses.replace(
            cfg.model.autoencoder, **VARIANT_TYPES)),
        training=dataclasses.replace(
            t, checkpoint_dir=str(tmp / "ckpt_variant"),
            log_dir=str(tmp / "logs_variant"),
            results_dir=str(tmp / "results_variant"),
            autoencoder=dataclasses.replace(t.autoencoder, epochs=1),
            lgan=dataclasses.replace(t.lgan, epochs=1),
            rl_agent=dataclasses.replace(
                t.rl_agent,
                episodes=VARIANT_RL_ITERS * t.rl_agent.envs_per_step),
            joint=dataclasses.replace(t.joint, epochs=JOINT_EPOCHS,
                                      refresh_d_steps=JOINT_REFRESH)))


def _profile_names_k3(folder: Path) -> bool:
    """Whether the one Chrome trace under ``folder`` holds a device
    kernel event of K3 (``nn_kernel``)."""
    (trace,) = folder.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    return any(e.get("cat") == "kernel"
               and _is_kernel(e.get("name", ""), "nn_kernel")
               for e in events)


def phase_variant(device, cfg, tmp: Path):
    """The variant family at full width, counted launch by launch as one
    path: the whole curriculum through the CLI (``--phase full
    --profile``, bf16_selective), then ``final`` served
    (``complete_clouds --checkpoint final``, ``evaluate --checkpoint
    final``). Checks the metrics log's AE/*, GAN/*, RL/* and Joint/*
    tags, the profile naming K3, ``final`` and its gate sidecar, the
    engine fold's and ``--export-pth``'s refusals. Returns the counts and
    a trainer holding ``final``."""
    import dataclasses

    from gan_rl_3d_tpu_torch import evaluate, train_rl_gan_net
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.train import gate as gate_lib
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer

    cfg = _variant_config(cfg, tmp)
    ckpt, logs = Path(cfg.training.checkpoint_dir), Path(cfg.training.log_dir)
    cfg_path = tmp / "variant.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(cfg)))
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    train_rl_gan_net.main(["--config", str(cfg_path), "--phase", "full",
                           "--profile", "--device", device.type])
    torch.cuda.synchronize()
    print(f"variant: train_rl_gan_net --phase full --profile "
          f"({cfg.training.precision}, AE 1 epoch, LGAN 1 epoch, "
          f"{VARIANT_RL_ITERS} RL iterations, joint {JOINT_EPOCHS} epoch, "
          f"{JOINT_REFRESH} D refresh steps) in "
          f"{time.perf_counter() - t0:.2f}s with the trace")
    records = [json.loads(line) for line in
               (logs / "metrics.jsonl").read_text().splitlines()]
    tags = sorted({r["tag"] for r in records})
    print(f"variant metrics.jsonl: {len(records)} records, tags {tags}")
    expect(all(any(tag.startswith(g) for tag in tags)
               for g in ("AE/", "GAN/", "RL/", "Joint/"))
           and all(np.isfinite(r["value"]) for r in records),
           f"variant metrics log: tags {tags}")
    expect(_profile_names_k3(logs / "profile"),
           "the variant run's profile names no K3 kernel")
    for name in ("final", "joint_calibrated", gate_lib.GATE_FILE):
        expect((ckpt / name).is_file(), f"variant: {name} was not written")
    expect(json.loads((ckpt / gate_lib.GATE_FILE).read_text())["checkpoints"]
           == ["joint_calibrated", "final"], "variant gate sidecar scope")

    inputs = write_scans(tmp / "scans_variant", seed=9)
    serve_files(inputs, tmp / "out_variant", ["--checkpoint", "final",
                                              "--config", str(cfg_path),
                                              "--device", device.type],
                N_MAIN)
    t0 = time.perf_counter()
    stats = evaluate.main(["--config", str(cfg_path), "--checkpoint",
                           "final", "--num-export", "2", "--device",
                           device.type])
    expect(len(stats) >= 5 and all(np.isfinite(v) for v in stats.values()),
           f"variant evaluate --checkpoint final: {stats}")
    print(f"variant evaluate --checkpoint final in "
          f"{time.perf_counter() - t0:.2f}s: " + ", ".join(
              f"{k}={v:.6f}" for k, v in stats.items()))
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    print(f"variant-path launches (--phase full, serving final): {counts}")
    for name in VARIANT_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "variant path")

    trainer = RLGANNetTrainer(cfg, device=device)
    trainer.load_checkpoint("final")
    for what, fn in (
            ("prepare_inference_engine",
             lambda: inference.prepare_inference_engine(trainer.model)),
            ("evaluate --export-pth", lambda: evaluate.main([
                "--config", str(cfg_path), "--checkpoint", "final",
                "--export-pth", str(tmp / "variant.pth"), "--device",
                device.type]))):
        try:
            fn()
        except ValueError as e:
            print(f"variant {what} refused: {e}")
        else:
            raise AssertionError(f"variant {what} was not refused")
    expect(not (tmp / "variant.pth").exists(), "variant .pth written")
    return counts, trainer


def pth_checks(device, tmp: Path) -> None:
    """The reference .pth bridge on the card, on the joint path's
    calibrated ``final`` (the PointNet family, which the reference layout
    holds): ``evaluate --checkpoint final --export-pth`` writes the pair,
    ``load_reference_checkpoint`` reads it back, and ``complete`` on it
    equals ``complete`` on the checkpoint bit for bit on the card."""
    from gan_rl_3d_tpu_torch import evaluate
    from gan_rl_3d_tpu_torch.config import load_config
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import rl_gan_net as net
    from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt_lib
    from gan_rl_3d_tpu_torch.utils.torch_convert import (
        load_reference_checkpoint)

    cfg_path = tmp / "joint.json"
    cfg = load_config(str(cfg_path))
    pth = tmp / "final.pth"
    evaluate.main(["--config", str(cfg_path), "--checkpoint", "final",
                   "--metrics", "chamfer_distance", "--export-pth", str(pth),
                   "--device", device.type])
    bundle = load_reference_checkpoint(str(pth))
    move = lambda tree: _on(tree, device)  # noqa: E731
    served = {"ae": move(bundle["ae"]), "lgan": move(bundle["lgan"]),
              "agent": {"actor": move(bundle["agent_networks"]["actor"])}}
    tree, _ = ckpt_lib.load_model_checkpoint(cfg.training.checkpoint_dir,
                                             "final")
    model = model_from_numpy(tree, device=device)
    pc, mask = make_clouds(B_MAIN, N_MAIN, seed=80, device=device)
    ref = net.complete(model, pc, mask, cfg=cfg.td3_config())
    out = net.complete(served, pc, mask, cfg=cfg.td3_config())
    same = all(torch.equal(out[k], ref[k]) for k in ref)
    print(f"reference .pth pair {pth.name} (+ the _rl_agent sibling, "
          f"{len(bundle['agent_networks'])} agent networks): complete on it "
          f"vs the checkpoint at B={B_MAIN}: "
          f"{'bit for bit' if same else 'DIFFERENT'} on {device}")
    expect(same, "complete on the .pth bridge's model differs")


def variant_ae_warm(trainer, seed):
    """The variant AE {"params", "state"} on the CPU after one f32
    ``ae_train_step`` from the trainer's, and its Adam's state (moments
    one step old, as joint_warm)."""
    from gan_rl_3d_tpu_torch.train import steps
    cpu = torch.device("cpu")
    ae = trainer.model["ae"]
    params, state = _on(ae["params"], cpu, grad=True), _on(ae["state"], cpu)
    opt, _ = steps.make_ae_optimizer(params, trainer.config.training
                                     .autoencoder, 1)
    state, _ = steps.ae_train_step(params, state, opt,
                                   *joint_batch(trainer, seed),
                                   **_ae_kw(trainer))
    return {"params": params, "state": state}, opt.state_dict()


def _ae_kw(trainer):
    return dict(spec=trainer.preproc, bn_stats=trainer.bn_stats,
                recon_loss=trainer.recon_loss,
                bidirectional=trainer.bidirectional)


def variant_ae_step_on(dev, warm, trainer, batch, draws, lr_scale=1.0):
    """One f32 ``ae_train_step`` on ``dev`` from ``variant_ae_warm``'s
    weights and Adam state, lr times ``lr_scale``: (metrics, {"encoder",
    "decoder"} each {"params", "state"})."""
    import copy

    from gan_rl_3d_tpu_torch.train import steps
    ac = trainer.config.training.autoencoder
    params, state = _on(warm[0]["params"], dev, grad=True), _on(
        warm[0]["state"], dev)
    opt, _ = steps.make_ae_optimizer(params, ac, 1)
    opt.load_state_dict(copy.deepcopy(warm[1]))
    for group in opt.param_groups:
        group["lr"] = ac.lr * lr_scale
    state, m = steps.ae_train_step(params, state, opt, _on(batch, dev),
                                   _on(draws, dev), **_ae_kw(trainer))
    return m, {k: {"params": params[k], "state": state[k]}
               for k in ("encoder", "decoder")}


def variant_checks(device, trainer):
    """``variant_step_check``, then ``joint_checks`` on the variant's
    ``final``."""
    variant_step_check(device, trainer)
    joint_checks(device, trainer)


def variant_step_check(device, trainer):
    """One f32 variant ``ae_train_step`` at B=8, full width, on the card and
    on CPU copies from the same weights, draws and Adam moments one step
    old, near-tie picks shared (``tie_sharing``): the loss within
    TOL_RL_LOSS, each network's update within
    TOL_RL_UPDATE of the CPU's in the 2-norm, its state within
    TOL_RL_PARAM; lr 0 and twice the lr on the card must fail."""
    cpu = torch.device("cpu")
    lr = trainer.config.training.autoencoder.lr
    warm = variant_ae_warm(trainer, seed=90)
    start = {k: {p: warm[0][p][k] for p in ("params", "state")}
             for k in ("encoder", "decoder")}
    batch, draws = joint_batch(trainer, seed=91)
    on_card, on_cpu, gaps = tie_sharing()
    with on_card:
        sm, card = variant_ae_step_on(device, warm, trainer, batch, draws)
    with on_cpu:
        ref_m, ref = variant_ae_step_on(cpu, warm, trainer, batch, draws)
    le = _rel(sm["loss"], ref_m["loss"])
    errs = {k: network_errs(card[k], ref[k], start[k]) for k in card}
    tol_noise = 2 * lr
    print(f"variant ae_train_step f32 B={B_STEP_CHECK}: card vs CPU, loss "
          f"{float(sm['loss']):.6f} / {float(ref_m['loss']):.6f} ({le:.3e}, "
          f"tol {TOL_RL_LOSS:g}); {_errs_text(errs)} ({_TOL_TEXT}, "
          f"Adam-noise leaves {tol_noise:g} absolute); {_ties_text(gaps)}")
    shifted = dict(batch, complete_pc=batch["complete_pc"] * (1.0 + 1e-7))
    _, floor = variant_ae_step_on(cpu, warm, trainer, shifted, draws)
    print("variant ae_train_step CPU against itself with the input clouds "
          "scaled by 1 + 1e-7: update error " + ", ".join(
              f"{k} {network_errs(floor[k], ref[k], start[k])[0]:.3e}"
              for k in ref))
    expect(le <= TOL_RL_LOSS and _errs_ok(errs.values(), tol_noise),
           "variant ae_train_step: the card disagrees with the CPU")
    for scale in (0.0, 2.0):
        _, wrong = variant_ae_step_on(device, warm, trainer, batch, draws,
                                      lr_scale=scale)
        power = {k: network_errs(wrong[k], ref[k], start[k])[0]
                 for k in card}
        print(f"variant ae_train_step with lr x {scale:g} on the card: "
              "update error " + ", ".join(f"{k} {e:.3e}"
                                          for k, e in power.items())
              + f" (must exceed {TOL_RL_UPDATE:g})")
        expect(min(power.values()) > TOL_RL_UPDATE, "variant ae_train_step: "
               f"the update check passes a step with lr x {scale:g}")


def phase_variant_times(device, card: str):
    """ms per variant ``ae_train_step`` at B=64, full width, in f32 and
    bf16_selective, and per unfolded ``complete`` at B=64 and B=4096,
    random weights from seed 0, by CUDA events (before any trace of the
    process). Returns the steps as cases for ``trace_rl_steps``."""
    import dataclasses

    from gan_rl_3d_tpu_torch.models import rl_gan_net as net
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train import steps

    cfg = _flagship()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, autoencoder=dataclasses.replace(cfg.model.autoencoder,
                                                   **VARIANT_TYPES)))
    model = net.init_model(torch.Generator().manual_seed(0), cfg, device)
    params = _on(model["ae"]["params"], device, grad=True)
    state = {"s": model["ae"]["state"]}
    opt, _ = steps.make_ae_optimizer(params, cfg.training.autoencoder, 2)
    pc, mask = make_clouds(B_MAIN, N_MAIN, seed=17, device=device)
    batch = {"complete_pc": pc, "pad": torch.zeros(B_MAIN, device=device)}
    draws = pc_ops.draw_training_batch(
        torch.Generator(device=device).manual_seed(18), B_MAIN, N_MAIN)

    def ae_step(precision):
        dtype, selective = steps.compute_dtype_of(precision)
        state["s"], _ = steps.ae_train_step(
            params, state["s"], opt, batch, draws, compute_dtype=dtype,
            selective=selective, bn_stats=cfg.training.bn_stats)

    cases = tuple((f"variant ae_train_step {p} B={B_MAIN}",
                   (lambda p=p: ae_step(p)), 10, TRACE_VARIANT)
                  for p in ("float32", "bf16_selective"))
    ms = {}
    for name, fn, reps, _ in cases:
        ms[name] = timed_ms(fn, reps=reps, repeats=3)
        print(f"{name}: {ms[name]:.3f} ms a step, "
              f"{B_MAIN / (ms[name] / 1e3):.1f} clouds/s ({card})")
    td3 = cfg.td3_config()
    for bsz in (B_MAIN, B_BIG):
        big, big_mask = make_clouds(bsz, N_MAIN, seed=19, device=device)
        out = net.complete(model, big, big_mask, cfg=td3)
        expect(out["hybrid_output"].shape == (bsz, N_MAIN, 3)
               and bool(torch.isfinite(out["hybrid_output"]).all()),
               f"variant complete B={bsz}: non-finite or misshapen output")
        t = ms[f"variant complete B={bsz}"] = timed_ms(
            lambda: net.complete(model, big, big_mask, cfg=td3), reps=5,
            repeats=3)
        print(f"variant complete (unfolded) B={bsz}: {t:.3f} ms a call, "
              f"{bsz / (t / 1e3):.1f} clouds/s ({card})")
        del big, big_mask, out
    torch.cuda.synchronize()
    return cases, ms


# ---------------------------------------------------------------------------
# the training BatchNorm + ReLU op (ops/bn_train.py, csrc/bn_train.cu)
# ---------------------------------------------------------------------------

# the activations of the 10 training BN layers of the variant's AE step at
# B=2048, N=2048 (the attn-adaptive-train-ae cell), with how many layers a
# step has of each
BN_CELL_LAYERS = (((2048, 2048, 64), 2), ((2048, 2048, 128), 3),
                  ((2048, 2048, 256), 1), ((2048, 128), 1), ((2048, 256), 1),
                  ((2048, 512), 1), ((2048, 1024), 1))
# op against composite: y and the state bit for bit; the gradients, of
# their largest element, sums in another order
# (tests/test_torch_port_bn_train.py says why); the cotangent is 0 where y
# lies within BN_BAND of its largest element from the ReLU's kink
TOL_BN, BN_BAND = 1e-5, 1e-4


def bn_inputs(shape, seed, device) -> dict:
    """z ~ 0.5 + 2 N(0, 1), the dense bias, BN parameters and running state
    near their initial values, and a cotangent, on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]

    def draw(shape, lo, spread):
        return lo + spread * torch.randn(shape, generator=g, device=device)

    return {"z": draw(shape, 0.5, 2.0), "b": draw((c,), 0.0, 0.1),
            "scale": draw((c,), 1.0, 0.1), "bias": draw((c,), 0.0, 0.1),
            "mean": draw((c,), 0.0, 0.1),
            "var": 1.0 + 0.1 * torch.rand(c, generator=g, device=device),
            "dy": draw(shape, 0.0, 1.0)}


def _bn_leaves(inp):
    """z, b, scale and bias as leaves that take a gradient: ``inp``'s own
    where they already do, else copies."""
    return [inp[k] if inp[k].requires_grad
            else inp[k].detach().clone().requires_grad_(True)
            for k in ("z", "b", "scale", "bias")]


def bn_composite(inp, dy=None):
    """The composite dense -> batchnorm_train (single_read_grouped) ->
    relu on z given: (y, state, gradients of z, b, scale, bias, y before
    the ReLU); no gradients without ``dy``."""
    from gan_rl_3d_tpu_torch import nn
    z, b, scale, bias = _bn_leaves(inp)
    pre, state = nn.batchnorm_train(
        {"scale": scale, "bias": bias},
        {"mean": inp["mean"], "var": inp["var"]}, z + b,
        mode="single_read_grouped")
    y = torch.relu(pre)
    grads = (torch.autograd.grad(y, (z, b, scale, bias), dy)
             if dy is not None else None)
    return y.detach(), state, grads, pre.detach()


def bn_op(inp, dy):
    """The op on the same operands: (y, state, gradients)."""
    from gan_rl_3d_tpu_torch.ops import bn_train as bt
    z, b, scale, bias = _bn_leaves(inp)
    y, mean, var = bt._BNReLU.apply(z, b, scale, bias, inp["mean"],
                                    inp["var"], True, 0.1, 1e-5)
    grads = torch.autograd.grad(y, (z, b, scale, bias), dy)
    return y.detach(), {"mean": mean, "var": var}, grads


def bn_errors(out, ref) -> dict:
    """Whether y and the state equal the composite's bit for bit
    ("forward_differs": 0 or 1); each gradient's largest difference from the
    composite's, of its largest element, in f32 (an f64 copy of a 4.3 GB
    activation would not fit beside the rest); db (an analytic 0 both
    sides compute as rounding noise) against the sum of |dz| of its
    channel."""
    y, st, (dz, db, d_scale, d_bias) = out
    ry, rst, (rdz, rdb, rd_scale, rd_bias), _ = ref
    same = torch.equal(y, ry) and all(torch.equal(st[k], rst[k])
                                      for k in ("mean", "var"))
    errs = {"forward_differs": float(not same)}
    errs.update({k: float((x - r).abs().max() / r.abs().max())
                 for k, x, r in (("dz", dz, rdz),
                                 ("d_scale", d_scale, rd_scale),
                                 ("d_bias", d_bias, rd_bias))})
    dz_abs = rdz.abs().reshape(-1, rdz.shape[-1]).sum(dim=0)
    errs["db"] = float(((db - rdb).abs() / dz_abs).max())
    return errs


def phase_bn(device) -> dict:
    """The training BatchNorm + ReLU op at each activation shape of the
    attn-adaptive-train-ae cell's step (B=2048): against the composite it
    replaces (y and state bit for bit, gradients within TOL_BN; a second
    run the same bits), then times by CUDA events: its forward and
    backward wrappers beside their byte bounds (3T and 5T, T one f32 pass
    over the activation), the op under autograd beside the composite's
    forward and backward; the step's totals over its 10 layers. Then the
    card-vs-CPU
    step checks that run through the op: ``step_check`` (a flagship f32 AE
    step), ``variant_step_check`` and ``joint_step_check`` on fresh
    weights, with lr 0 and twice the lr failing the last two."""
    import types

    from gan_rl_3d_tpu_torch.models import rl_gan_net as net
    from gan_rl_3d_tpu_torch.ops import bn_train as bt

    rows, total = {}, {"op": 0.0, "bound": 0.0, "composite": 0.0}
    for shape, count in BN_CELL_LAYERS:
        inp = bn_inputs(shape, seed=40, device=device)
        pre = bn_composite(inp)[3]
        dy = torch.where(pre.abs() > BN_BAND * pre.abs().max(), inp["dy"],
                         torch.zeros((), device=device))
        del pre
        ref = bn_composite(inp, dy)
        out = bn_op(inp, dy)
        errs = bn_errors(out, ref)
        del ref
        again = bn_op(inp, dy)
        same = all(torch.equal(a, b) for a, b in zip(
            (out[0], *out[1].values(), *out[2]),
            (again[0], *again[1].values(), *again[2])))
        del out, again
        args = [inp[k] for k in ("z", "b", "scale", "bias")]
        fwd = timed_ms(lambda: bt.bn_relu_forward(
            *args, inp["mean"], inp["var"], grouped=True), reps=5, repeats=3)
        stats = bt.bn_relu_forward(*args, inp["mean"], inp["var"],
                                   grouped=True)[1]
        bwd = timed_ms(lambda: bt.bn_relu_backward(*args, stats, dy), reps=5,
                       repeats=3)
        # both under autograd from the same leaves (no copy of z timed)
        leaves = _bn_leaves(inp)
        inp_leaves = dict(inp, **dict(zip(("z", "b", "scale", "bias"),
                                          leaves)))
        op = timed_ms(lambda: bn_op(inp_leaves, dy), reps=5, repeats=3)
        comp = timed_ms(lambda: bn_composite(inp_leaves, dy), reps=2,
                        repeats=3)
        t = inp["z"].numel() * 4 / PEAK_BYTES * 1e3
        row = {"errors": errs, "bit_identical": same, "forward_ms": fwd,
               "forward_bound_ms": 3 * t, "backward_ms": bwd,
               "backward_bound_ms": 5 * t, "op_ms": op, "bound_ms": 8 * t,
               "bound_share": 8 * t / op, "composite_ms": comp,
               "layers": count}
        rows[str(shape)] = row
        total["op"] += count * op
        total["bound"] += count * 8 * t
        total["composite"] += count * comp
        print(f"bn_train {shape} (x{count} a step): forward {fwd:.3f} ms "
              f"(3T bound {3 * t:.3f}), backward {bwd:.3f} ms (5T bound "
              f"{5 * t:.3f}); op under autograd {op:.3f} ms, "
              f"{100 * 8 * t / op:.1f}% of its 8T bound {8 * t:.3f} ms; "
              f"composite {comp:.3f} ms; errors " + ", ".join(
                  f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol {TOL_BN:g}); bit-identical twice: {same}")
        expect(max(errs.values()) <= TOL_BN,
               f"bn_train {shape}: the op disagrees with the composite")
        expect(same, f"bn_train {shape}: two runs differ")
        del inp, args, stats, dy, leaves, inp_leaves
        torch.cuda.empty_cache()
    print(f"bn_train, the step's 10 layers ({card_line()}): op "
          f"{total['op']:.3f} ms, 8T bound {total['bound']:.3f} ms "
          f"({100 * total['bound'] / total['op']:.1f}%), composite "
          f"{total['composite']:.3f} ms")
    rows["step"] = total

    cfg = _flagship()
    step_check(device, net.init_model(torch.Generator().manual_seed(0), cfg,
                                      torch.device("cpu"))["ae"])
    # seed 11 is tests/test_torch_port_cuda.py's joint step; on seed 2's
    # fresh weights the generator's update reads 6.5e-2 with the op and
    # without it alike: the joint step's conditioning (PERF.md §6)
    for family, seed, check in (("variant", 1, variant_step_check),
                                ("flagship", 11, joint_step_check)):
        fcfg = cfg
        if family == "variant":
            import dataclasses
            fcfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, autoencoder=dataclasses.replace(
                    cfg.model.autoencoder, **VARIANT_TYPES)))
        check(device, types.SimpleNamespace(
            config=fcfg, td3=fcfg.td3_config(), preproc=fcfg.preproc_spec(),
            model=net.init_model(torch.Generator().manual_seed(seed), fcfg,
                                 device),
            bidirectional=fcfg.loss.bidirectional,
            bn_stats=fcfg.training.bn_stats,
            recon_loss=fcfg.loss.reconstruction_loss))
    return rows


# ---------------------------------------------------------------------------
# the multi path: the ("data", "model") mesh over torch.distributed
# ---------------------------------------------------------------------------

MULTI_WORLDS = (2, 4)   # gloo ranks sharing the one card
MULTI_AE_STEPS = 3
TOL_MULTI_LOSS = 1e-4   # relative, of the one process's loss
TOL_MULTI_SERVE = 1e-5  # the f32 engine's outputs, DP against one process
MULTI_KERNELS = ("encoder_pool_f32", "nn_dist", "nn_gather", "nn_scatter")
MULTI_TIMED = 5         # steps a rank times


def _multi_config(cfg, tmp: Path, name: str):
    """The recipe (the flagship family) cut as the variant path is: 1 AE
    epoch (2 steps at B=64), 1 LGAN epoch, VARIANT_RL_ITERS RL iterations,
    the joint block as JOINT_EPOCHS / JOINT_REFRESH; its checkpoints and
    logs under ``tmp/name``."""
    import dataclasses

    t = cfg.training
    return dataclasses.replace(cfg, training=dataclasses.replace(
        t, checkpoint_dir=str(tmp / name / "ckpt"),
        log_dir=str(tmp / name / "logs"),
        results_dir=str(tmp / name / "results"),
        autoencoder=dataclasses.replace(t.autoencoder, epochs=1),
        lgan=dataclasses.replace(t.lgan, epochs=1),
        rl_agent=dataclasses.replace(
            t.rl_agent, episodes=VARIANT_RL_ITERS * t.rl_agent.envs_per_step),
        joint=dataclasses.replace(t.joint, epochs=JOINT_EPOCHS,
                                  refresh_d_steps=JOINT_REFRESH)))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_config(cfg, path: Path) -> Path:
    import dataclasses

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dataclasses.asdict(cfg)))
    return path


def _step_times(device, cfg, mesh) -> dict:
    """ms per ``ae_train_step`` and per ``joint_train_step`` (f32, B=64
    global, this rank's rows) under ``mesh`` (None: one process), the
    collectives each issues, and the device busy time of one step from a
    torch.profiler trace (NCCL's kernels among them)."""
    from torch.profiler import ProfilerActivity, profile

    from gan_rl_3d_tpu_torch.models import rl_gan_net as net
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.parallel import collectives
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
    from gan_rl_3d_tpu_torch.train import steps

    model = net.init_model(torch.Generator().manual_seed(0), cfg, device)
    tr = _trainer_view(cfg)
    model = {**model, **{k: {"params": _on(model[k]["params"], device, True),
                             "state": model[k]["state"]}
                         for k in ("ae", "lgan")}}
    model = mesh_lib.shard_model_for_mesh(mesh, model)
    ae_m = model["ae"]
    ae_opt, sched = steps.make_ae_optimizer(ae_m["params"],
                                            cfg.training.autoencoder, 10)
    j_opt = steps.make_joint_optimizer(steps.joint_trainable(model),
                                       cfg.training.joint)
    pc, _ = make_clouds(B_MAIN, N_MAIN, seed=81, device=device)
    batch = mesh_lib.shard_batch(mesh, {"complete_pc": pc,
                                        "pad": torch.zeros(B_MAIN,
                                                           device=device)})
    gen = torch.Generator(device).manual_seed(82)
    holder = {"ae": ae_m["state"], "model": model}

    def ae_step():
        draws = pc_ops.draw_training_batch(gen, B_MAIN, N_MAIN,
                                           spec=tr.preproc)
        holder["ae"], _ = steps.ae_train_step(
            ae_m["params"], holder["ae"], ae_opt, batch, draws,
            scheduler=sched, spec=tr.preproc, bn_stats=tr.bn_stats,
            mesh=mesh)

    def joint_step():
        draws = pc_ops.draw_training_batch(gen, B_MAIN, N_MAIN,
                                           spec=tr.preproc)
        holder["model"], _ = steps.joint_train_step(
            holder["model"], j_opt, batch, draws, mesh=mesh,
            **_joint_kw(tr))

    out = {}
    for name, fn in (("ae_train_step", ae_step),
                     ("joint_train_step", joint_step)):
        fn()
        before = sum(collectives.calls.values())
        fn()
        calls = sum(collectives.calls.values()) - before
        ms = timed_ms(fn, reps=MULTI_TIMED, repeats=3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_kernel_times(prof)
        busy = sum(us for _, _, us in events) / 1e3
        nccl = sum(us for k, _, us in events if "nccl" in k.lower()) / 1e3
        out[name] = {"ms": ms, "collectives": calls,
                     "device_busy_ms": busy, "nccl_device_ms": nccl}
    torch.cuda.synchronize()
    return out


def _trainer_view(cfg):
    """What ``_joint_kw`` reads of a trainer, from a config."""
    import types

    return types.SimpleNamespace(
        config=cfg, td3=cfg.td3_config(), preproc=cfg.preproc_spec(),
        bidirectional=cfg.loss.bidirectional,
        bn_stats=cfg.training.bn_stats)


def torchrun_child(cfg_path: str, out_path: str) -> None:
    """Run under ``torch.distributed.run --nproc-per-node 1`` by
    ``phase_multi``: joins the NCCL group torchrun describes, times the
    steps of both routes on the same card, then drives the whole
    curriculum through the training CLI's ``main`` in that group, counting
    its launches."""
    import torch.distributed as dist

    from gan_rl_3d_tpu_torch import train_rl_gan_net
    from gan_rl_3d_tpu_torch.config import load_config
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

    device = mesh_lib.init_distributed("nccl", "cuda")
    cfg = load_config(cfg_path)
    mesh = mesh_lib.make_mesh(device=device)
    times = {"torchrun": _step_times(device, cfg, mesh),
             "plain": _step_times(device, cfg, None)}
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    train_rl_gan_net.main(["--config", cfg_path, "--phase", "full"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    world, backend = dist.get_world_size(), dist.get_backend()
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps({
        "counts": counts, "seconds": seconds, "times": times,
        "world": world, "backend": backend}))


def _final_leaves(ckpt: Path) -> list:
    from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt_lib
    from gan_rl_3d_tpu_torch.utils.tree import tree_leaves

    model, _ = ckpt_lib.load_model_checkpoint(str(ckpt), "final")
    return [np.asarray(x) for x in tree_leaves(model)]


def phase_multi_torchrun(device, cfg, tmp: Path) -> dict:
    """(a) NCCL at world size 1 through the distributed code: ``python -m
    torch.distributed.run --nproc-per-node 1`` drives the training CLI
    over the whole curriculum (``torchrun_child``); its ``final`` against
    a plain one-process run's from the same seed, bit for bit; the
    ae_train_step and joint_train_step times of both routes, with the
    collectives a step and the device time. Returns the child's launch
    counts."""
    from gan_rl_3d_tpu_torch import train_rl_gan_net

    run_cfg = _multi_config(cfg, tmp, "multi_torchrun")
    plain_cfg = _multi_config(cfg, tmp, "multi_plain")
    run_path = _write_config(run_cfg, tmp / "multi_torchrun.json")
    out = tmp / "multi_torchrun_out.json"
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "1", "--master-addr", "localhost",
           "--master-port", str(_free_port()),
           str(Path(__file__).resolve()), "--torchrun-child", str(run_path),
           str(out)]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, timeout=900,
                   cwd=str(Path(__file__).resolve().parent))
    print(f"multi (a): torch.distributed.run --nproc-per-node 1 "
          f"train_rl_gan_net --phase full (NCCL, world 1) in "
          f"{time.perf_counter() - t0:.2f}s")
    child = json.loads(out.read_text())
    expect(child["world"] == 1 and child["backend"] == "nccl",
           f"torchrun child's group: {child['world']} {child['backend']}")
    t0 = time.perf_counter()
    train_rl_gan_net.main(["--config", str(_write_config(
        plain_cfg, tmp / "multi_plain.json")), "--phase", "full"])
    torch.cuda.synchronize()
    print(f"multi (a): the same curriculum in one plain process in "
          f"{time.perf_counter() - t0:.2f}s")
    a = _final_leaves(Path(run_cfg.training.checkpoint_dir))
    b = _final_leaves(Path(plain_cfg.training.checkpoint_dir))
    differ = [i for i, (x, y) in enumerate(zip(a, b))
              if x.shape != y.shape or not np.array_equal(x, y)]
    print(f"multi (a): final of {len(a)} leaves, torchrun vs plain: "
          f"{len(differ)} differ")
    expect(len(a) == len(b) and not differ,
           f"torchrun's final differs from the plain run's in leaves "
           f"{differ[:10]}")
    for route, rows in child["times"].items():
        for step, r in rows.items():
            print(f"multi (a) {route} {step} f32 B={B_MAIN} ({card_line()}):"
                  f" {r['ms']:.3f} ms, {r['collectives']} collectives a "
                  f"step, device busy {r['device_busy_ms']:.3f} ms, NCCL "
                  f"device {r['nccl_device_ms']:.3f} ms")
    print(f"multi (a) launches: {child['counts']}")
    return child["counts"]


# the ranks of (b) and (c) -------------------------------------------------


def _multi_rank(rank: int, world: int, backend: str, store: str,
                inputs_path: str, out_dir: str, shapes: list) -> None:
    """One rank of ``phase_multi``'s gloo (or NCCL) runs: every job of
    ``multi_jobs`` on each mesh shape, its results, launch counts,
    collectives and (on a data-only mesh) step times to
    ``out_dir/<shape>.<rank>.pt``. gloo ranks share card 0; NCCL rank r
    runs on card r."""
    import torch.distributed as dist

    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.parallel import collectives
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        for shape in shapes:
            mesh = mesh_lib.make_mesh(*shape, device=device)
            tp = shape[1] > 1
            _cuda.launch_counts.clear()
            collectives.calls.clear()
            res = multi_jobs(inputs, mesh, device, tp=tp)
            res["launches"] = dict(_cuda.launch_counts)
            res["collectives"] = dict(collectives.calls)
            res["times"] = (None if tp else
                            _step_times(device, inputs["cfg"], mesh))
            torch.save(res, Path(out_dir) / f"{shape[0]}x{shape[1]}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def _cpu(tree):
    from gan_rl_3d_tpu_torch.utils.tree import tree_map
    return tree_map(lambda v: v.detach().cpu().clone(), tree)


def _load_adam(opt, params: list, sd: dict, mesh) -> None:
    """``sd`` (a one-process Adam state) into ``opt``, this rank's columns
    of a column-sharded leaf's moments."""
    import copy

    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

    opt.load_state_dict(copy.deepcopy(sd))
    for p in params:
        if mesh_lib.is_model_sharded(p):
            st = opt.state[p]
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = mesh_lib.column_block(mesh, st[k]).contiguous()


def _set_lr(opt, scale: float) -> None:
    for g in opt.param_groups:
        g["lr"] = g["lr"] * scale


def multi_ae(inputs, start, i, mesh, dev, bn_stats, lr_scale=1.0):
    """AE step ``i`` of the inputs from ``start`` (params, state, Adam
    state) under ``mesh``: (loss, network, Adam state)."""
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
    from gan_rl_3d_tpu_torch.train import steps
    from gan_rl_3d_tpu_torch.utils.tree import tree_leaves

    cfg = inputs["cfg"]
    params = _on(start["params"], dev, grad=True)
    state = _on(start["state"], dev)
    opt, _ = steps.make_ae_optimizer(params, cfg.training.autoencoder, 10)
    _load_adam(opt, tree_leaves(params), start["opt"], mesh)
    _set_lr(opt, lr_scale)
    batch = mesh_lib.shard_batch(mesh, _on(inputs["ae_batches"][i], dev))
    state, m = steps.ae_train_step(
        params, state, opt, batch, _on(inputs["ae_draws"][i], dev),
        spec=cfg.preproc_spec(), bn_stats=bn_stats, mesh=mesh)
    return float(m["loss"]), {"params": _cpu(params), "state": _cpu(state),
                              "opt": opt.state_dict()}


def multi_jobs(inputs, mesh, dev, tp: bool) -> dict:
    """The multi path's steps at the flagship widths from the inputs'
    weights and draws, under ``mesh`` (None: the one-process reference):
    the AE steps in both BN modes (each from the one-process state before
    it), a combined LGAN step, an rl_step of B_MAIN environments, a joint
    step (column-sharded on a mesh with a model axis) and DP serving."""
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

    cfg = inputs["cfg"]
    out = {}
    if tp:
        out["joint"] = multi_joint(inputs, mesh, dev)
        return out
    for mode in ("centered", "single_read_grouped"):
        out[f"ae_{mode}"] = [
            multi_ae(inputs, start, i, mesh, dev, mode)[:2]
            for i, start in enumerate(inputs[f"ae_starts_{mode}"])]
    warm = inputs["lgan_warm"]
    real = inputs["lgan_real"]
    if mesh is not None:
        real = mesh_lib.local_rows(mesh, real, axis=1)
    sm, nets = lgan_step_on(dev, warm, cfg, real, inputs["lgan_draws"],
                            mesh=mesh)
    out["lgan"] = ({k: float(v) for k, v in sm.items()}, _cpu(nets))
    model, out["rl"] = multi_rl(inputs, mesh, dev)
    out["joint"] = multi_joint(inputs, mesh, dev)
    engine = inference.prepare_inference_engine(
        {**model, "agent": {"actor": model["agent"]["actor"]}})
    served = inference.complete_fast(engine, inputs["serve_pc"].to(dev),
                                     mesh=mesh)
    out["serve"] = served["hybrid_output"].cpu()
    return out


def multi_td3(cfg, lr_scale: float = 1.0):
    """The multi path's TD3 config: the flagship's, its actor warmup cut
    to 0 so that the actor takes its updates in the one rl_step (the
    flagship waits 2000 TD3 updates), both lrs scaled by ``lr_scale``."""
    td3 = cfg.td3_config()
    return td3._replace(actor_warmup=0, actor_lr=td3.actor_lr * lr_scale,
                        critic_lr=td3.critic_lr * lr_scale)


def multi_rl(inputs, mesh, dev, lr_scale=1.0):
    """One rl_step of B_MAIN environments sharded over ``mesh``, its TD3
    updates replicated, from the warm agent and a prefilled ring: (the
    model, (metrics, the agent's networks, the step's ring rows, ring
    size, OU state))."""
    from gan_rl_3d_tpu_torch.convert import agent_from_numpy
    from gan_rl_3d_tpu_torch.models import rl_agent as rl
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
    from gan_rl_3d_tpu_torch.train import replay_buffer as rb
    from gan_rl_3d_tpu_torch.train import steps

    cfg = inputs["cfg"]
    td3 = multi_td3(cfg, lr_scale)
    rc = cfg.training.rl_agent
    model = {k: {"params": _on(inputs["model"][k]["params"], dev),
                 "state": _on(inputs["model"][k]["state"], dev)}
             for k in ("ae", "lgan")}
    model["agent"] = agent_from_numpy(inputs["agent"], td3, device=dev)
    bsz, prefill = len(inputs["rl_batch"]["pad"]), inputs["rl_prefill"]
    buf = rb.ReplayBuffer(cfg.model.rl_agent.buffer_size, td3.state_dim,
                          td3.action_dim, dev)
    buf.add_batch(random_transitions(prefill, td3, 52, dev))
    ou = rl.ou_init(td3, (bsz,), dev)
    model, buf, ou, m = steps.rl_step(
        model, buf, ou, mesh_lib.shard_batch(mesh, _on(inputs["rl_batch"],
                                                       dev)),
        _on(inputs["rl_draws"], dev), cfg=td3, start_training_size=0,
        updates_per_step=rc.updates_per_step, spec=cfg.preproc_spec(),
        mesh=mesh, w_chamfer=cfg.loss.w_chamfer, w_gfv=cfg.loss.w_gfv,
        w_discriminator=cfg.loss.w_discriminator)
    return model, ({"reward": float(m["reward"])},
                   {k: _cpu(model["agent"][k]) for k in
                    ("actor", "critic1", "critic2")},
                   {k: getattr(buf, k)[prefill:prefill + bsz].cpu()
                    for k in rb.FIELDS}, buf.size, ou.cpu())


def multi_joint(inputs, mesh, dev, lr_scale=1.0):
    """One f32 joint step of B_MAIN clouds from the warm joint model and
    Adam state, the model placed on ``mesh``: (metrics, networks)."""
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
    from gan_rl_3d_tpu_torch.train import steps
    from gan_rl_3d_tpu_torch.utils.tree import tree_leaves

    cfg = inputs["cfg"]
    tr = _trainer_view(cfg)
    jc = cfg.training.joint
    model, sd = inputs["joint_warm"]
    model = mesh_lib.shard_model_for_mesh(mesh, _joint_model(model, dev))
    trainable = steps.joint_trainable(model, jc.freeze_generator)
    opt = steps.make_joint_optimizer(trainable, jc)
    _load_adam(opt, tree_leaves(trainable), sd, mesh)
    _set_lr(opt, lr_scale)
    model, m = steps.joint_train_step(
        model, opt, mesh_lib.shard_batch(mesh, _on(inputs["joint_batch"],
                                                   dev)),
        _on(inputs["joint_draws"], dev), mesh=mesh, **_joint_kw(tr))
    nets = _joint_networks(mesh_lib.gather_model(mesh, model))
    return {k: float(v) for k, v in m.items()}, _cpu(nets)


def multi_inputs(cfg, device) -> dict:
    """Weights, warm Adam states, batches and draws of the multi path, on
    the CPU: one seed for every rank and the one-process reference. The AE
    trajectory is the reference's, on the card: each rank's step starts
    from the state before it."""
    import types

    from gan_rl_3d_tpu_torch.convert import agent_to_numpy
    from gan_rl_3d_tpu_torch.models import rl_gan_net as net
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train import steps

    cpu = torch.device("cpu")
    model = net.init_model(torch.Generator().manual_seed(0), cfg, cpu)
    td3 = multi_td3(cfg)
    spec = cfg.preproc_spec()
    gen = torch.Generator().manual_seed(90)
    pc, _ = make_clouds(B_MAIN, N_MAIN, seed=91, device=cpu)
    inputs = {"cfg": cfg,
              "model": {k: _cpu(model[k]) for k in ("ae", "lgan")},
              "ae_batches": [{"complete_pc": make_clouds(
                  B_MAIN, N_MAIN, seed=92 + i, device=cpu)[0],
                  "pad": torch.zeros(B_MAIN)}
                  for i in range(MULTI_AE_STEPS)],
              "ae_draws": [pc_ops.draw_training_batch(gen, B_MAIN, N_MAIN,
                                                      spec=spec)
                           for _ in range(MULTI_AE_STEPS)],
              "rl_batch": {"complete_pc": pc, "pad": torch.zeros(B_MAIN)},
              "rl_prefill": RL_PREFILL,
              "serve_pc": make_clouds(B_MAIN, N_MAIN, seed=96, device=cpu)[0]}
    rc = cfg.training.rl_agent
    inputs["rl_draws"] = steps.draw_rl_step(
        gen, B_MAIN, N_MAIN, cfg=td3,
        buffer_size=min(RL_PREFILL + B_MAIN, cfg.model.rl_agent.buffer_size),
        updates_per_step=rc.updates_per_step, spec=spec)
    inputs["agent"] = agent_to_numpy(agent_warm(model["agent"], td3, 93))
    lc = cfg.training.lgan
    real = 0.3 * torch.randn(lc.d_steps, B_MAIN, cfg.model.lgan.latent_dim,
                             generator=gen)
    warm_cfg = types.SimpleNamespace(training=cfg.training, model=cfg.model)
    inputs["lgan_real"] = real
    inputs["lgan_warm"] = lgan_warm(model["lgan"], warm_cfg,
                                    real[:, :lc.batch_size], 94)
    inputs["lgan_draws"] = steps.draw_lgan_combined(
        gen, B_MAIN, cfg.model.lgan.z_dim, cfg.model.lgan.discriminator_dims,
        lc.d_steps)
    tr = types.SimpleNamespace(**vars(_trainer_view(cfg)), model=model)
    inputs["joint_warm"] = joint_warm(tr, 95)
    inputs["joint_batch"], inputs["joint_draws"] = joint_batch(tr, 97,
                                                               bsz=B_MAIN)
    # the AE's warm Adam: one step on the CPU, then the card's trajectory
    ae_params = _on(model["ae"]["params"], cpu, grad=True)
    opt, _ = steps.make_ae_optimizer(ae_params, cfg.training.autoencoder, 10)
    state, _ = steps.ae_train_step(
        ae_params, _cpu(model["ae"]["state"]), opt,
        {"complete_pc": pc, "pad": torch.zeros(B_MAIN)},
        pc_ops.draw_training_batch(gen, B_MAIN, N_MAIN, spec=spec),
        spec=spec)
    for mode in ("centered", "single_read_grouped"):
        start = {"params": _cpu(ae_params), "state": _cpu(state),
                 "opt": opt.state_dict()}
        starts = []
        for i in range(MULTI_AE_STEPS):
            starts.append(start)
            _, nxt = multi_ae(inputs, start, i, None, device, mode)
            start = nxt
        inputs[f"ae_starts_{mode}"] = starts
    return inputs


def _multi_errs(res, ref, start) -> tuple:
    update, state, worst, noise = network_errs(res, ref, start)
    return update, state, noise


def _check_nets(what, got, ref, start, moved, tol, noise_tol, frozen=None):
    """Each network's update against the one process's (network_errs):
    within ``tol`` in the 2-norm and its state leaves within TOL_RL_PARAM
    of their largest element, or 4 x what the one-process run moves when
    its input clouds move by one part in 10^7 (``moved``), where that is
    more; the Adam-noise leaves within ``noise_tol``; a run at lr 0
    (``frozen``) must read over the update's bound."""
    for name in ref:
        floor, floor_state, _ = _multi_errs(moved[name], ref[name],
                                            start[name])
        bound = max(tol, 4 * floor)
        state_bound = max(TOL_RL_PARAM, 4 * floor_state)
        update, state, noise = _multi_errs(got[name], ref[name], start[name])
        expect(update <= bound and state <= state_bound
               and noise <= noise_tol,
               f"{what} {name}: update {update:.3e} (tol {bound:.3e}), state "
               f"{state:.3e} (tol {state_bound:.3e}), noise {noise:.3e} "
               f"(tol {noise_tol:.3e})")
        wrong = (None if frozen is None else
                 _multi_errs(frozen[name], ref[name], start[name])[0])
        print(f"  {what} {name}: update {update:.3e} of the one process's "
              f"(its own under a 1e-7 input change {floor:.3e}), state "
              f"{state:.3e} ({floor_state:.3e}), Adam noise {noise:.3e}"
              + ("" if wrong is None else f", lr 0 reads {wrong:.3e}"))
        expect(wrong is None or wrong > bound,
               f"{what} {name}: lr 0 passed the check ({wrong})")


def _close(what, got, ref, rtol):
    err = abs(got - ref) / max(abs(ref), 1e-30)
    expect(err <= rtol, f"{what}: {got} against {ref} ({err:.2e} > {rtol:g})")
    return err


def check_multi(res, ref, frozen, moved, inputs, what):
    """One rank's results of ``multi_jobs`` against the one-process
    reference on the card (``moved``: the reference with its input clouds
    moved by one part in 10^7, the steps' own conditioning)."""
    cfg = inputs["cfg"]
    if "ae_centered" in res:
        lr = cfg.training.autoencoder.lr
        for mode in ("centered", "single_read_grouped"):
            for i, ((loss, net), (rloss, rnet), start) in enumerate(zip(
                    res[f"ae_{mode}"], ref[f"ae_{mode}"],
                    inputs[f"ae_starts_{mode}"])):
                _close(f"{what} AE {mode} step {i} loss", loss, rloss,
                       TOL_MULTI_LOSS)
                _check_nets(f"{what} AE {mode} step {i}", {"ae": net},
                            {"ae": rnet}, {"ae": start},
                            {"ae": moved[f"ae_{mode}"][i][1]}, TOL_RL_UPDATE,
                            2 * lr, frozen["ae"] if mode == "centered"
                            and i == 0 else None)
        (lm, lnets), (rlm, rlnets) = res["lgan"], ref["lgan"]
        for k in rlm:
            _close(f"{what} LGAN {k}", lm[k], rlm[k], TOL_MULTI_LOSS)
        lc = cfg.training.lgan
        warm = inputs["lgan_warm"][0]
        lstart = {k: {"params": warm["params"][k], "state": warm["state"][k]}
                  for k in ("generator", "discriminator")}
        _check_nets(f"{what} LGAN", lnets, rlnets, lstart, moved["lgan"][1],
                    TOL_RL_UPDATE,
                    2 * max(lc.generator_lr, lc.discriminator_lr) * lc.d_steps,
                    frozen["lgan"])
        (rm, agent, ring, size, ou), (rrm, ragent, rring, rsize, rou) = (
            res["rl"], ref["rl"])
        _close(f"{what} rl_step reward", rm["reward"], rrm["reward"],
               TOL_MULTI_LOSS)
        expect(size == rsize, f"{what} ring size {size} against {rsize}")
        for k in ring:
            expect(torch.allclose(ring[k], rring[k], rtol=1e-5, atol=1e-4),
                   f"{what} ring {k}: {(ring[k] - rring[k]).abs().max()}")
        expect(torch.allclose(ou, rou, atol=1e-5), f"{what} OU state")
        td3 = multi_td3(cfg)
        astart = {k: {"params": inputs["agent"][k]["params"],
                      "state": inputs["agent"][k]["state"]}
                  for k in ("actor", "critic1", "critic2")}
        _check_nets(f"{what} rl_step", agent, ragent, _np_tensors(astart),
                    moved["rl"][1], TOL_RL_UPDATE,
                    2 * max(td3.actor_lr, td3.critic_lr)
                    * cfg.training.rl_agent.updates_per_step, frozen["rl"])
        err = scaled_err(res["serve"], ref["serve"])
        expect(err <= TOL_MULTI_SERVE,
               f"{what} DP serving: {err:.2e} > {TOL_MULTI_SERVE:g}")
        print(f"  {what} DP serving (f32 engine): {err:.2e} of the largest "
              f"output element")
    (jm, jnets), (rjm, rjnets) = res["joint"], ref["joint"]
    _close(f"{what} joint loss", jm["loss"], rjm["loss"], TOL_MULTI_LOSS)
    wstart = _joint_networks(inputs["joint_warm"][0])
    _check_nets(f"{what} joint", jnets, rjnets, wstart, moved["joint"][1],
                TOL_JOINT_UPDATE, 2 * cfg.training.joint.lr, frozen["joint"])


def _moved_inputs(inputs) -> dict:
    """The inputs with every cloud and real GFV scaled by 1 + 1e-7."""
    def up(x):
        return x * (1.0 + 1e-7)

    def batch(b):
        return {**b, "complete_pc": up(b["complete_pc"])}

    return {**inputs, "ae_batches": [batch(b) for b in inputs["ae_batches"]],
            "rl_batch": batch(inputs["rl_batch"]),
            "joint_batch": batch(inputs["joint_batch"]),
            "lgan_real": up(inputs["lgan_real"])}


def _np_tensors(tree):
    from gan_rl_3d_tpu_torch.utils.tree import tree_map
    return tree_map(lambda v: torch.as_tensor(np.asarray(v)), tree)


def phase_multi(device, cfg, tmp: Path) -> dict:
    """The multi path: (a) ``phase_multi_torchrun``; (b) 2 and 4 ranks
    sharing the one card over gloo (host-staged collectives), each rank
    running ``multi_jobs`` from the same weights and draws, held against
    the one-process reference on the card; at 4 ranks also a 2x2 (data,
    model) joint step with the decoder head column-sharded; (c) the same
    over NCCL on min(device count, 4) cards when more than one is
    visible. Returns the launches of every rank and of (a), summed."""
    import torch.multiprocessing as mp

    counts = dict(phase_multi_torchrun(device, cfg, tmp))
    inputs = multi_inputs(cfg, device)
    ref = multi_jobs(inputs, None, device, tp=False)
    moved = multi_jobs(_moved_inputs(inputs), None, device, tp=False)
    frozen = {
        "ae": {"ae": multi_ae(inputs, inputs["ae_starts_centered"][0], 0,
                              None, device, "centered", lr_scale=0.0)[1]},
        "lgan": lgan_step_on(device, inputs["lgan_warm"], cfg,
                             inputs["lgan_real"], inputs["lgan_draws"],
                             lr_scale=0.0)[1],
        "rl": multi_rl(inputs, None, device, lr_scale=0.0)[1][1],
        "joint": multi_joint(inputs, None, device, lr_scale=0.0)[1]}
    frozen["lgan"] = _cpu(frozen["lgan"])
    inputs_path = tmp / "multi_inputs.pt"
    torch.save(inputs, inputs_path)
    runs = [("gloo", world) for world in MULTI_WORLDS]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs.append(("nccl", min(n_cards, 4)))
    else:
        print(f"multi (c): NCCL across cards not run: {n_cards} card "
              "visible (it needs 2 or more)")
    for backend, world in runs:
        shapes = [(world, 1)] + ([(2, 2)] if world == 4 else [])
        out_dir = tmp / f"multi_{backend}{world}"
        out_dir.mkdir()
        t0 = time.perf_counter()
        mp.spawn(_multi_rank, args=(world, backend, str(out_dir / "store"),
                                    str(inputs_path), str(out_dir), shapes),
                 nprocs=world, join=True)
        print(f"multi ({'b' if backend == 'gloo' else 'c'}): {world} ranks "
              f"over {backend}, meshes {shapes}, in "
              f"{time.perf_counter() - t0:.2f}s")
        for shape in shapes:
            tag = f"{shape[0]}x{shape[1]}"
            for rank in range(world):
                res = torch.load(out_dir / f"{tag}.{rank}.pt",
                                 weights_only=False)
                check_multi(res, ref, frozen, moved, inputs,
                            f"{backend} {tag} rank {rank}")
                for k, v in res["launches"].items():
                    counts[k] = counts.get(k, 0) + v
                if rank == 0:
                    print(f"multi {backend} {tag} rank 0 collectives: "
                          f"{res['collectives']}, launches "
                          f"{res['launches']}")
                    for step, r in (res["times"] or {}).items():
                        print(f"multi {backend} {tag} {step} f32 B={B_MAIN} "
                              f"global, rank 0 ({card_line()}; {world} ranks"
                              f" {'sharing one card' if backend == 'gloo' else 'on their own cards'}"
                              f", not a scaling figure): {r['ms']:.3f} ms, "
                              f"{r['collectives']} collectives a step, "
                              f"device busy {r['device_busy_ms']:.3f} ms")
    for name in MULTI_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "multi path")
    print(f"multi-path launches: {counts}")
    return counts


KERNELS = {
    "encoder_pool_f32": ("gan_rl_3d_tpu_torch/csrc/encoder_pool.cu",
                         "gan_rl_3d_tpu/ops/encoder_kernel.py:151"),
    "encoder_pool_bf16": ("gan_rl_3d_tpu_torch/csrc/encoder_pool_bf16.cu",
                          "gan_rl_3d_tpu/ops/encoder_kernel.py:151"),
    "encoder_pool_bf16_wide": ("gan_rl_3d_tpu_torch/csrc/encoder_pool.cu",
                               "gan_rl_3d_tpu/ops/encoder_kernel.py:151"),
    "encoder_pool_int8": ("gan_rl_3d_tpu_torch/csrc/encoder_pool_int8.cu",
                          "gan_rl_3d_tpu/ops/encoder_kernel.py:249"),
    "encoder_pool_int8_wide": (
        "gan_rl_3d_tpu_torch/csrc/encoder_pool_int8_wide.cu",
        "gan_rl_3d_tpu/ops/encoder_kernel.py:249"),
    "nn_dist": ("gan_rl_3d_tpu_torch/csrc/nn_dist.cu",
                "gan_rl_3d_tpu/ops/chamfer.py:121"),
    "nn_min": ("gan_rl_3d_tpu_torch/csrc/nn_dist.cu",
               "gan_rl_3d_tpu/ops/chamfer.py:201"),
    "nn_gather": ("gan_rl_3d_tpu_torch/csrc/nn_grad.cu",
                  "gan_rl_3d_tpu/ops/chamfer.py:289"),
    "nn_scatter": ("gan_rl_3d_tpu_torch/csrc/nn_grad.cu",
                   "gan_rl_3d_tpu/ops/chamfer.py:309"),
}
SERVING_KERNELS = ("encoder_pool_f32", "encoder_pool_bf16",
                   "encoder_pool_int8", "nn_dist", "nn_min")
TRAINING_KERNELS = ("nn_dist", "nn_gather", "nn_scatter")
EVAL_KERNELS = ("encoder_pool_f32", "nn_dist", "nn_min")
RL_KERNELS = ("nn_dist",)
# phase 5's two Chamfer losses (K3 forward, K4/K5 backward) and the gate
# statistics' (K3); serving the calibrated final checkpoint: K1 through
# the exported engine, K2 and K3 in evaluate's metrics
JOINT_KERNELS = ("nn_dist", "nn_gather", "nn_scatter", "encoder_pool_f32",
                 "nn_min")
# the variant family: the AE, joint and gate Chamfer losses (K3 forward,
# K4/K5 backward), the RL reward (K3), evaluate's metrics (K2, K3); it
# folds into no engine, so no K1 or K6
VARIANT_KERNELS = ("nn_dist", "nn_gather", "nn_scatter", "nn_min")
# the trained checkpoint: the three engines (K1 f32, K1 bf16 on the tensor
# cores, K6), evaluate's metrics (K2, K3) and the joint step (K3-K5)
# the data path: the AE validation's Chamfer (K3 twice a batch)
DATA_KERNELS = ("nn_dist",)
TRAINED_KERNELS = ("encoder_pool_f32", "encoder_pool_bf16",
                   "encoder_pool_int8", "nn_dist", "nn_min", "nn_gather",
                   "nn_scatter")
# instances for widths the flagship does not have: run by the checks of
# phase 2 (and timed at the flagship widths), on no main path
WIDE_INSTANCES = ("encoder_pool_bf16_wide", "encoder_pool_int8_wide")
# instances whose ptxas report must show no spills
NO_SPILL = ("encoder_pool_bf16_kernel", "encoder_pool_int8_wide_kernel",
            "encoder_pool_int8_kernel", "encoder_pool_kernel", "nn_kernel")
SCAN_CENTRE = np.array([10.0, -2.0, 3.0])


def encoder_bound(bsz, n, layers, bf16):
    """(ms, bound_by): ops over the type's peak vs bytes over HBM rate."""
    dims = [3] + [w.shape[1] for w, _ in layers]
    flop0 = 2 * bsz * n * dims[0] * dims[1]
    flop_rest = 2 * bsz * n * sum(a * b for a, b in zip(dims[1:], dims[2:]))
    ops_s = (flop0 / PEAK_F32
             + flop_rest / (PEAK_BF16 if bf16 else PEAK_F32))
    wbytes = sum(w.numel() * (2 if bf16 else 4) + b.numel() * 4
                 for w, b in layers)
    nbytes = bsz * n * 3 * 4 + wbytes + bsz * dims[-1] * 4
    return _bound(ops_s, nbytes)


def int8_encoder_bound(bsz, n, qenc):
    """K6: (ms, bound_by) from layer 0's f32 flop on the CUDA cores and the
    int8 ops on the tensor cores, or the bytes; and the ms the row
    quantization and dequantization would take on the CUDA cores at the
    f32 rate, which the bound leaves out (per quantized layer: per input
    activation an abs-max compare, a divide, a round and a two-sided clip;
    per output two multiplies, an add and a ReLU)."""
    w0, b0 = qenc["layer0"]
    layers = qenc["layers_q"]
    ops_s = (2 * bsz * n * w0.numel() / PEAK_F32
             + 2 * bsz * n * sum(wq.numel() for wq, _, _ in layers)
             / PEAK_INT8)
    wbytes = sum(x.numel() * x.element_size()
                 for x in (w0, b0, *[x for layer in layers for x in layer]))
    nbytes = bsz * n * 3 * 4 + wbytes + bsz * layers[-1][0].shape[1] * 4
    per_point = sum(5 * wq.shape[0] + 4 * wq.shape[1] for wq, _, _ in layers)
    return (*_bound(ops_s, nbytes), bsz * n * per_point / PEAK_F32 * 1e3)


def nn_bound(bsz, n, m, keep_idx):
    ops_s = bsz * n * m * 8 / PEAK_F32
    nbytes = (bsz * n * 3 + bsz * m * 3) * 4 + bsz * n * (8 if keep_idx else 4)
    return _bound(ops_s, nbytes)


def nn_geometry():
    """K3/K2's query points a thread (R) and distances a compare (C), as
    csrc/nn_dist.cu fixes them."""
    from gan_rl_3d_tpu_torch.ops import _cuda

    src = (_cuda.CSRC / "nn_dist.cu").read_text()
    return {k: int(re.search(rf"constexpr int k{k} = (\d+);", src).group(1))
            for k in ("R", "C")}


def nn_floor_ms(bsz, n, m, keep_idx):
    """The design's own floor: the issue slots a pair needs for the bits
    (FMUL, 2 FFMA, 2 FADD, FMNMX; K3's compare and select add 2 a sub-tile
    of C), over 132 SMs x 128 lanes at 1.98 GHz, the clock behind
    PEAK_F32."""
    slots = 6 + (2 / nn_geometry()["C"] if keep_idx else 0)
    return bsz * n * m * slots / (PEAK_F32 / 2) * 1e3


def nn_registers(keep_idx):
    """Registers a thread of K3's (keep_idx) or K2's unmasked instance,
    from ptxas."""
    from gan_rl_3d_tpu_torch.ops import _cuda

    info = ptxas_report(_cuda.build_log("nn_dist"))[
        f"nn_kernel<keep_idx={int(keep_idx)}, masked=0>"]
    return int(info.split()[0])


def gather_bound(bsz, n, m):
    """K4 reads a, b, idx, dist, g once and writes da; about 9 flop a point
    (compare, max, divide, 3 subtract, 3 multiply)."""
    nbytes = (bsz * n * 3 + bsz * m * 3 + 3 * bsz * n + bsz * n * 3) * 4
    return _bound(bsz * n * 9 / PEAK_F32, nbytes)


def scatter_bound(bsz, n, m):
    """K5 reads idx and da once and writes db; the sum needs 3 adds a query
    point."""
    nbytes = (bsz * n + bsz * n * 3 + bsz * m * 3) * 4
    return _bound(bsz * n * 3 / PEAK_F32, nbytes)


def _bound(ops_s, nbytes):
    bytes_s = nbytes / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def phase_times(device, engine, engine_bf16, engine_q):
    """Each serving kernel at B=64 and 4096, N=2048, the flagship widths,
    beside its plain version and bound (the wide instances at the flagship
    widths too, picked by hand: their widths are the flagship's and their
    work the same); then complete_fast per engine."""
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.ops import chamfer, encoder_kernel as ek

    rows = {}
    for bsz in (B_MAIN, B_BIG):
        pc, _ = make_clouds(bsz, N_MAIN, seed=6, device=device)
        b, _ = make_clouds(bsz, N_MAIN, seed=7, device=device)
        reps = 20 if bsz == B_MAIN else 3
        bf16_layers = engine_bf16["encoder"]["layers"]
        dims = [3] + [w.shape[1] for w, _ in bf16_layers]
        tile = ek.encoder_tile(dims)
        plain = {}
        for name, layers, dtype, kernel in (
                ("encoder_pool_f32", engine["encoder"]["layers"],
                 torch.float32, ek.fused_encoder_pool),
                ("encoder_pool_bf16", bf16_layers, torch.bfloat16,
                 ek.fused_encoder_pool),
                ("encoder_pool_bf16_wide", bf16_layers, torch.bfloat16,
                 ek.encoder_pool_cuda_cores)):
            ms = timed_ms(lambda: kernel(pc, layers, compute_dtype=dtype),
                          reps=reps)
            # both bf16 instances compute the same function: one plain time
            if dtype not in plain:
                plain[dtype] = timed_ms(lambda: ek.fused_encoder_pool_plain(
                    pc, layers, compute_dtype=dtype), reps=reps)
            bound, by = encoder_bound(bsz, N_MAIN, layers,
                                      dtype == torch.bfloat16)
            rows[(name, bsz)] = dict(ms=ms, plain_ms=plain[dtype],
                                     bound_ms=bound, bound_by=by,
                                     library_ms=None)
            if name == "encoder_pool_bf16":
                regs, local = ek.encoder_pool_bf16_attributes(
                    False, tuple(dims[1:]) == INT8_FLAGSHIP)
                rows[(name, bsz)].update(
                    registers=regs, local_bytes=local,
                    smem_bytes=ek.packed_bf16_encoder(layers).data.numel())
            else:
                rows[(name, bsz)].update(
                    tile=tile, registers=ek.encoder_pool_registers(
                        tile, dtype, False))
        qenc = engine_q["encoder_q"]
        plain_q = timed_ms(lambda: ek.fused_encoder_pool_int8_plain(pc, qenc),
                           reps=reps)
        bound, by, core_ms = int8_encoder_bound(bsz, N_MAIN, qenc)
        for name, packed in (
                ("encoder_pool_int8", ek.packed_int8_encoder(qenc)),
                ("encoder_pool_int8_wide", ek.pack_int8_encoder(qenc,
                                                                "wide"))):
            ms = timed_ms(lambda: ek.encoder_pool_int8_packed(pc, packed),
                          reps=reps)
            regs, local = ek.encoder_pool_int8_attributes(
                False, packed.dims == INT8_FLAGSHIP, packed.instance)
            smem = (packed.data.numel() if packed.instance == "mma"
                    else ek.int8_wide_smem(packed.dims))
            rows[(name, bsz)] = dict(
                ms=ms, plain_ms=plain_q, bound_ms=bound, bound_by=by,
                library_ms=None, quantize_f32_ms=core_ms, registers=regs,
                local_bytes=local, smem_bytes=smem)
        torch.cuda.empty_cache()
        chunk = 256
        reps = 20 if bsz == B_MAIN else 2
        for name, kernel, plain_fn, keep in (
                ("nn_dist", lambda: chamfer.nearest_distances(pc, b),
                 lambda lo, hi: chamfer.nearest_distances_plain(
                     pc[lo:hi], b[lo:hi]), True),
                ("nn_min", lambda: chamfer.nearest_min_distances(pc, b),
                 lambda lo, hi: chamfer.nearest_min_distances_plain(
                     pc[lo:hi], b[lo:hi]), False)):
            # the eager call, as every kernel's ms; beside it the device
            # time from a CUDA graph, which leaves out the host's work
            ms = timed_ms(kernel, reps=reps)
            device_ms = graph_ms(kernel, reps=reps, repeats=3)
            plain = timed_ms(chunked(plain_fn, bsz, chunk), reps=reps)
            lib = timed_ms(chunked(lambda lo, hi: torch.cdist(
                pc[lo:hi], b[lo:hi]).min(-1), bsz, chunk), reps=reps)
            bound, by = nn_bound(bsz, N_MAIN, N_MAIN, keep)
            rows[(name, bsz)] = dict(
                ms=ms, device_ms=device_ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib,
                floor_ms=nn_floor_ms(bsz, N_MAIN, N_MAIN, keep),
                registers=nn_registers(keep), **nn_geometry())
        del pc, b
        torch.cuda.empty_cache()
    for (name, bsz), r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = ("" if "quantize_f32_ms" not in r else
                 f"; row (de)quantization on the CUDA cores alone "
                 f"{r['quantize_f32_ms']:.4f} ms at the f32 rate")
        if "R" in r:
            extra += (f"; {r['device_ms']:.4f} ms device time (CUDA graph); "
                      f"the design's floor {r['floor_ms']:.4f} ms; "
                      f"R={r['R']}, C={r['C']}, "
                      f"{r['registers']} registers a thread")
        elif "tile" in r:
            extra += (f"; {r['tile']}-point tile, {r['registers']} registers "
                      "a thread")
        elif "smem_bytes" in r:
            extra += (f"; {r['registers']} registers a thread, "
                      f"{r['local_bytes']} B of local memory, "
                      f"{r['smem_bytes']} B of shared memory a block")
        print(f"time {name} B={bsz}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib} ms{extra}")

    for bsz, reps in ((B_MAIN, 20), (B_BIG, 3)):
        pc, mask = make_clouds(bsz, N_MAIN, seed=8, device=device)
        for label, eng in (("f32", engine), ("bf16", engine_bf16),
                           ("int8", engine_q)):
            ms = timed_ms(lambda: inference.complete_fast(eng, pc, mask),
                          reps=reps, repeats=3)
            print(f"complete_fast {label} B={bsz}: {ms:.3f} ms per call, "
                  f"{bsz / (ms / 1e3):.1f} clouds/s")
    torch.cuda.synchronize()
    return rows


def device_kernel_times(prof):
    """(name, launches, device us) of every kernel, copy and memset in a
    torch.profiler trace. The device-side range of a record_function
    annotation (such as Optimizer.step#Adam.step) overlaps the kernels it
    holds; it carries the name of its host-side range, so device events
    named like a host event are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type != cuda}
    return [(e.key, e.count, e.self_device_time_total) for e in events
            if e.device_type == cuda and e.key not in host_names]


def phase_train_times(device):
    """K4 and K5 at B=64 and 512 beside their plain versions, bounds and
    library yardsticks (K4's is torch.gather plus the arithmetic, which is
    its plain version timed again: no one library call computes the fused
    function; index_add_ for K5), all as device time from CUDA graphs (an
    eager call of these microsecond kernels measures the host). Then one
    ae_train_step at B=64, N=2048 at the flagship widths in f32 and
    bf16_selective: its time, and a torch.profiler trace of TRACE_STEPS
    steps for the device's busy time, its idle share of the step, the
    launches per step and the kernels that take the most device time."""
    from gan_rl_3d_tpu_torch.models import autoencoder as ae
    from gan_rl_3d_tpu_torch.ops import chamfer
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train import steps
    from gan_rl_3d_tpu_torch.utils.tree import tree_map

    rows = {}
    for bsz in (B_MAIN, B_GRAD_BIG):
        a, b, _, dist, idx, g = grad_inputs(bsz, N_MAIN, N_MAIN, 14, device,
                                            False)
        da = chamfer.nearest_grad_a(a, b, idx, dist, g)
        flat = (idx.long() + N_MAIN * torch.arange(
            bsz, device=device)[:, None]).reshape(-1)
        neg = (-da).reshape(-1, 3)
        acc = torch.zeros(bsz * N_MAIN, 3, device=device)
        for name, kernel, plain, library, (bound, by) in (
                ("nn_gather",
                 lambda: chamfer.nearest_grad_a(a, b, idx, dist, g),
                 lambda: chamfer.nearest_grad_a_plain(a, b, idx, dist, g),
                 lambda: chamfer.nearest_grad_a_plain(a, b, idx, dist, g),
                 gather_bound(bsz, N_MAIN, N_MAIN)),
                ("nn_scatter",
                 lambda: chamfer.nearest_grad_b(idx, da, N_MAIN),
                 lambda: chamfer.nearest_grad_b_plain(idx, da, N_MAIN),
                 lambda: acc.index_add_(0, flat, neg),
                 scatter_bound(bsz, N_MAIN, N_MAIN))):
            # K5's plain version reads its longest segment on the host, so
            # it cannot be captured in a graph: timed eagerly
            rows[(name, bsz)] = dict(
                ms=graph_ms(kernel),
                plain_ms=(timed_ms(plain) if name == "nn_scatter"
                          else graph_ms(plain)),
                bound_ms=bound, bound_by=by, library_ms=graph_ms(library),
                call_ms=timed_ms(kernel))
    for (name, bsz), r in rows.items():
        print(f"time {name} B={bsz}: kernel {r['ms']:.4f} ms (device, "
              f"CUDA graph; {r['call_ms']:.4f} ms per eager call), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']:.4f} ms")

    cfg = _flagship()
    m = cfg.model.autoencoder
    params, state = ae.autoencoder_init(
        torch.Generator().manual_seed(0), m.input_dim, m.latent_dim,
        m.num_points, m.encoder_dims, m.decoder_dims)
    params = tree_map(lambda v: v.to(device).requires_grad_(True), params)
    state = tree_map(lambda v: v.to(device), state)
    opt, _ = steps.make_ae_optimizer(params, cfg.training.autoencoder, 2)
    pc, _ = make_clouds(B_MAIN, N_MAIN, seed=15, device=device)
    batch = {"complete_pc": pc, "pad": torch.zeros(B_MAIN, device=device)}
    draws = pc_ops.draw_training_batch(
        torch.Generator(device=device).manual_seed(16), B_MAIN, N_MAIN)

    def ae_step(precision):
        dtype, selective = steps.compute_dtype_of(precision)
        steps.ae_train_step(params, state, opt, batch, draws,
                            compute_dtype=dtype, selective=selective,
                            bn_stats=cfg.training.bn_stats)

    step_ms = {}
    for precision in ("float32", "bf16_selective"):
        torch.cuda.reset_peak_memory_stats()
        ms = step_ms[precision] = timed_ms(
            lambda: ae_step(precision), reps=10, repeats=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"ae_train_step {precision} B={B_MAIN}: {ms:.3f} ms per step, "
              f"{B_MAIN / (ms / 1e3):.1f} clouds/s, peak memory "
              f"{peak:.2f} GiB")
    # traced only after every step is timed: timed after a trace in the
    # same process, the bf16_selective step read 67.8 ms, against 48.8 ms
    # in a process that had traced nothing (H100 80GB HBM3, 700 W)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for precision, ms in step_ms.items():
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(TRACE_STEPS):
                ae_step(precision)
            torch.cuda.synchronize()
        events = device_kernel_times(prof)
        busy = sum(us for _, _, us in events) / 1e3 / TRACE_STEPS
        launches = sum(n for _, n, _ in events) / TRACE_STEPS
        print(f"ae_train_step {precision} trace of {TRACE_STEPS} steps: "
              f"device busy {busy:.3f} ms a step, idle share "
              f"{1 - busy / ms:.3f} of the {ms:.3f} ms step, {launches:.0f} "
              "device launches a step; most device time:")
        for name, n, us in sorted(events, key=lambda e: -e[2])[:TRACE_TOP]:
            print(f"  {us / 1e3 / TRACE_STEPS:9.4f} ms  x{n / TRACE_STEPS:5.0f}"
                  f"  {name[:110]}")
    ms = timed_ms(lambda: ae_step("float32"), reps=10, repeats=3)
    print(f"ae_train_step float32 B={B_MAIN} timed again after the traces: "
          f"{ms:.3f} ms per step")
    torch.cuda.synchronize()
    return rows


TRACED_KERNELS = (("K3", "nn_kernel"), ("K4", "gather_kernel"),
                  ("K5", "scatter_kernel"))


def _is_kernel(name: str, key: str) -> bool:
    """Whether a traced kernel's name is the port's function ``key``
    (e.g. "nn_kernel" for K3; demangled, in any namespace, or mangled),
    never one of PyTorch's at::native kernels."""
    if "at::native" in name:
        return False
    return (key in re.findall(r"[A-Za-z_]\w*", name)
            or f"{len(key)}{key}" in name)


def _trace(fn, calls: int, ms: float, what: str, top=TRACE_TOP) -> dict:
    """torch.profiler trace of ``calls`` calls of ``fn``: device busy ms a
    call, idle share of the ``ms`` call, launches a call, the kernels with
    the most device time, and the device time a call of K3, K4 and K5."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = device_kernel_times(prof)
    busy = sum(us for _, _, us in events) / 1e3 / calls
    launches = sum(n for _, n, _ in events) / calls
    kernel_ms = {label: sum(us for name, _, us in events
                            if _is_kernel(name, key)) / 1e3 / calls
                 for label, key in TRACED_KERNELS}
    expect(busy > 0, f"{what}: no device time in the trace")
    print(f"{what} trace of {calls} calls: device busy {busy:.3f} ms a "
          f"call, idle share {1 - busy / ms:.3f} of the {ms:.3f} ms call, "
          f"{launches:.0f} device launches a call, " + ", ".join(
              f"{k} {v:.4f} ms a call ({v / busy:.4f} of device busy)"
              for k, v in kernel_ms.items() if v or k == "K3")
          + "; most device time:")
    for name, n, us in sorted(events, key=lambda e: -e[2])[:top]:
        print(f"  {us / 1e3 / calls:9.4f} ms  x{n / calls:6.0f}  {name[:110]}")
    return {"ms": ms, "device_busy_ms": busy, "idle_share": 1 - busy / ms,
            "launches": launches,
            **{f"{k.lower()}_ms": v for k, v in kernel_ms.items()}}


def phase_rl_times(device, trainer):
    """ms per ``lgan_combined_step`` (the recipe's batch 16, 3 D steps),
    per ``agent_update`` (batch 64) and per ``rl_step`` (64 environments,
    64 updates), from the RL phase's weights and optimizer state, by CUDA
    events. Returns the cases and their times for ``trace_rl_steps``,
    which runs after every time of the script is taken: a trace slows
    the timings after it in the same process (the f32 AE step read 38.8
    ms before the traces and 70.0 after, H100 80GB HBM3, 700 W)."""
    from gan_rl_3d_tpu_torch.models import rl_agent as rl
    from gan_rl_3d_tpu_torch.train import replay_buffer as rb
    from gan_rl_3d_tpu_torch.train import steps

    cfg, td3 = trainer.config, trainer.td3
    lc, m, rc = cfg.training.lgan, cfg.model.lgan, cfg.training.rl_agent
    gen = torch.Generator(device).manual_seed(50)
    params = _on(trainer.model["lgan"]["params"], device, grad=True)
    lgan = {"state": _on(trainer.model["lgan"]["state"], device)}
    g_opt = steps.make_gan_optimizer(params["generator"], lc.generator_lr, lc)
    d_opt = steps.make_gan_optimizer(params["discriminator"],
                                     lc.discriminator_lr, lc)
    gfvs = torch.from_numpy(trainer.gfvs["clean"]).to(device)

    def lgan_step():
        idx = torch.randint(0, len(gfvs), (lc.d_steps, lc.batch_size),
                            generator=gen, device=device)
        draws = steps.draw_lgan_combined(gen, lc.batch_size, m.z_dim,
                                         m.discriminator_dims, lc.d_steps)
        lgan["state"], _ = steps.lgan_combined_step(
            params, lgan["state"], d_opt, g_opt, gfvs[idx], draws,
            lambda_gp=lc.lambda_gp)

    agent = _agent_copy(trainer.model["agent"], device, td3)
    batch = random_transitions(td3.batch_size, td3, 51, device)

    def update():
        rl.agent_update(agent, batch, torch.randn(
            (td3.batch_size, td3.action_dim), generator=gen, device=device),
            td3)

    model = {**{k: _on(trainer.model[k], device) for k in ("ae", "lgan")},
             "agent": _agent_copy(trainer.model["agent"], device, td3)}
    buf = rb.ReplayBuffer(cfg.model.rl_agent.buffer_size, td3.state_dim,
                          td3.action_dim, device)
    buf.add_batch(random_transitions(RL_PREFILL, td3, 52, device))
    data, _ = trainer._resident_train_data()
    envs = rc.envs_per_step
    ou = rl.ou_init(td3, (envs,), device)
    weights = dict(w_chamfer=cfg.loss.w_chamfer, w_gfv=cfg.loss.w_gfv,
                   w_discriminator=cfg.loss.w_discriminator)

    def rl_iter():
        idx = torch.randint(0, len(data), (envs,), generator=gen,
                            device=device)
        draws = steps.draw_rl_step(
            gen, envs, data.shape[1], cfg=td3,
            buffer_size=min(buf.size + envs, buf.capacity),
            updates_per_step=rc.updates_per_step, spec=trainer.preproc)
        steps.rl_step(model, buf, ou, {"complete_pc": data[idx],
                                       "pad": torch.zeros(envs,
                                                          device=device)},
                      draws, cfg=td3,
                      start_training_size=rc.start_training_steps,
                      updates_per_step=rc.updates_per_step,
                      spec=trainer.preproc, **weights)

    cases = (("lgan_combined_step", lgan_step, 10, 5),
             ("agent_update", update, 20, 10),
             ("rl_step", rl_iter, 2, TRACE_RL))
    ms = {}
    for name, fn, reps, _ in cases:
        ms[name] = timed_ms(fn, reps=reps, repeats=3)
        print(f"{name}: {ms[name]:.3f} ms a call")
    torch.cuda.synchronize()
    return cases, ms


def trace_rl_steps(cases, ms) -> dict:
    """A torch.profiler trace of each case of ``phase_rl_times``."""
    rows = {name: _trace(fn, calls, ms[name], name)
            for name, fn, _, calls in cases}
    torch.cuda.synchronize()
    return rows


def phase_joint_times(device, trainer):
    """ms per ``joint_train_step`` at B=64, full width, in f32 and
    bf16_selective (the recipe's), per ``gate_stats_step`` batch (B=64)
    and per D step of the refresh (the recipe's batch 16, a fresh Adam,
    the generator frozen), from phase 5.5's weights, by CUDA events.
    Returns the joint steps and the gate statistics as cases for
    ``trace_rl_steps``."""
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train import gate as gate_lib
    from gan_rl_3d_tpu_torch.train import steps
    from gan_rl_3d_tpu_torch.train import trainer as trainer_lib

    cfg = trainer.config
    jc, lc, m = cfg.training.joint, cfg.training.lgan, cfg.model.lgan
    gen = torch.Generator(device).manual_seed(70)
    data, _ = trainer._resident_train_data()
    holder = {"model": _joint_model(trainer.model, device)}
    opt = steps.make_joint_optimizer(
        steps.joint_trainable(holder["model"], jc.freeze_generator), jc)
    pad = torch.zeros(B_MAIN, device=device)

    def joint_step(precision):
        idx = torch.randint(0, len(data), (B_MAIN,), generator=gen,
                            device=device)
        draws = pc_ops.draw_training_batch(gen, B_MAIN, N_MAIN,
                                           spec=trainer.preproc)
        holder["model"], _ = steps.joint_train_step(
            holder["model"], opt, {"complete_pc": data[idx], "pad": pad},
            draws, **_joint_kw(trainer, precision))

    lgan = trainer.model["lgan"]
    params = _on(lgan["params"], device, grad=True)
    state = {"s": _on(lgan["state"], device)}
    d_opt = steps.make_gan_optimizer(params["discriminator"],
                                     lc.discriminator_lr, lc)
    gfvs = torch.from_numpy(trainer.gfvs["clean"]).to(device)
    real = gfvs[torch.randint(0, len(gfvs), (JOINT_REFRESH, lc.batch_size),
                              generator=gen, device=device)]

    def refresh():
        draws = [steps.draw_lgan_d(gen, lc.batch_size, m.z_dim,
                                   m.discriminator_dims)
                 for _ in range(JOINT_REFRESH)]
        state["s"], _ = steps.lgan_d_refresh(params, state["s"], d_opt, real,
                                             draws, lambda_gp=lc.lambda_gp)

    vb = next(iter(trainer.val_loader))
    vbatch = {"complete_pc": torch.from_numpy(vb["complete_pc"]).to(device),
              "pad": torch.from_numpy(vb["pad"]).to(device)}
    vdraws = trainer._fixed_holes(trainer_lib.GATE_HOLES, 0,
                                  *vbatch["complete_pc"].shape[:2])

    def gate_batch():
        gate_lib.gate_stats_step(trainer.model, vbatch, vdraws,
                                 cfg=trainer.td3, spec=trainer.preproc,
                                 bidirectional=trainer.bidirectional)

    cases = tuple((f"joint_train_step {p} B={B_MAIN}",
                   (lambda p=p: joint_step(p)), 10, TRACE_JOINT)
                  for p in ("float32", "bf16_selective")) + (
        (f"gate_stats_step B={vbatch['pad'].shape[0]}", gate_batch, 10,
         TRACE_JOINT),)
    ms = {}
    for name, fn, reps, _ in cases:
        torch.cuda.reset_peak_memory_stats()
        ms[name] = timed_ms(fn, reps=reps, repeats=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name}: {ms[name]:.3f} ms a call, "
              f"{B_MAIN / (ms[name] / 1e3):.1f} clouds/s, peak memory "
              f"{peak:.2f} GiB")
    per_d = timed_ms(refresh, reps=1, repeats=3) / JOINT_REFRESH
    print(f"D refresh (lgan_d_refresh, {JOINT_REFRESH} steps at "
          f"B={lc.batch_size}): {per_d:.3f} ms per D step")
    torch.cuda.synchronize()
    return cases, ms, {"refresh_ms_per_d_step": per_d}


def main() -> None:
    device = phase_device()
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import inference

    from gan_rl_3d_tpu_torch.ops import _cuda

    model = model_from_numpy(init_numpy_model(_flagship(), seed=0),
                             device=device)
    _cuda.launch_counts.clear()
    errs = phase_kernels(device, inference.prepare_inference_engine(model),
                         inference.prepare_inference_engine(
                             model, dtype=torch.bfloat16),
                         inference.prepare_inference_engine(
                             model, quantize_int8=True))
    errs.update(phase_grad_kernels(device))
    checks = dict(_cuda.launch_counts)
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        engine, engine_bf16, engine_q, serving, random_errs = phase_main(
            device, model, tmp)
        training, cfg = phase_train(device, tmp)
        evaluation = phase_eval(device, tmp, cfg)
        rl_path, trainer = phase_rl(device, cfg)
        rl_checks(device, trainer)
        joint_path, jtrainer = phase_joint(device, trainer.config, tmp)
        joint_checks(device, jtrainer)
        trained_path = phase_trained(device, tmp, cfg, random_errs)
        data_path = phase_data(device, tmp)
        multi_path = phase_multi(device, cfg, tmp)
        # every time is taken before the first trace of the process
        bn_rows = phase_bn(device)
        rows = phase_times(device, engine, engine_bf16, engine_q)
        rl_cases = phase_rl_times(device, trainer)
        joint_cases, joint_ms, joint_times = phase_joint_times(device,
                                                               jtrainer)
        variant_cases, variant_ms = phase_variant_times(device, card_line())
        rows.update(phase_train_times(device))
        step_rows = trace_rl_steps(*rl_cases)
        joint_rows = trace_rl_steps(joint_cases, joint_ms)
        variant_rows = trace_rl_steps(variant_cases, variant_ms)
        # the variant path's run is profiled whole (--profile): last
        variant_path, vtrainer = phase_variant(device, cfg, tmp)
        variant_checks(device, vtrainer)
        pth_checks(device, tmp)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {"serving": serving.get(name, 0),
                   "training": training.get(name, 0),
                   "evaluation": evaluation.get(name, 0),
                   "rl": rl_path.get(name, 0),
                   "joint": joint_path.get(name, 0),
                   "trained": trained_path.get(name, 0),
                   "data": data_path.get(name, 0),
                   "variant": variant_path.get(name, 0),
                   "multi": multi_path.get(name, 0)}
        expect(name in WIDE_INSTANCES or sum(by_path.values()) > 0,
               f"{name} never launched on a main path")
        expect(checks.get(name, 0) > 0, f"{name} never checked")
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_in_checks": checks.get(name, 0),
            "on_main_path": name not in WIDE_INSTANCES,
            "max_abs_err": errs[name],
            **rows[(name, B_MAIN)], "shape": f"B={B_MAIN}, N=M={N_MAIN}",
        }
        for big in (B_BIG, B_GRAD_BIG):
            if (name, big) in rows:
                row[f"b{big}"] = rows[(name, big)]
        kernels.append(row)
    print("kernels: " + ", ".join(
        f"{k['name']} x{k['launches']} (checks x{k['launches_in_checks']})"
        for k in kernels))
    print("rl steps: " + json.dumps(step_rows))
    print("joint steps: " + json.dumps({**joint_rows, **joint_times}))
    print(f"variant steps ({card_line()}): " + json.dumps(
        {**variant_rows, **{k: v for k, v in variant_ms.items()
                            if "complete" in k}}))
    print("bn_train: " + json.dumps(bn_rows))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-child"]:
        torchrun_child(*sys.argv[2:4])
    else:
        main()
