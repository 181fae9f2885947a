"""The port's main paths on the card at full width, through the entry
points a user calls: serving, the curriculum phase by phase with
mid-phase resume, the committed trained weights, the data path on best7's
regenerated dataset, the variant family, the .pth bridge, the multi path
and the training BatchNorm op. Each path holds its outputs to the plain
versions on CPU copies or to the JAX package's figures, and names the
kernels that must launch on it. Imports no JAX, so on a GPU machine it
runs as

  python -m pytest --noconftest tests/test_torch_port_card_paths.py -m cuda

The tests skip where no GPU is visible. The curriculum's phases share one
run (module fixtures): phase 1's checkpoint feeds phases 2-4, whose
``rl_agent_final`` feeds phases 5 and 5.5, whose ``final`` the .pth bridge
reads."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from card_checks import (B_MAIN, B_STEP_CHECK, N_MAIN, TIE_GAP, TOL_BF16,
                         TOL_F32, TOL_GATE_MARGIN, TOL_INT8_CARD,
                         TOL_INT8_GFV, TOL_INT8_GFV_TRAINED, TOL_INT8_PC,
                         TOL_JOINT_UPDATE, TOL_RL_LOSS, TOL_RL_PARAM,
                         TOL_RL_UPDATE, TOL_STEP_GRAD, TOL_STEP_LOSS,
                         VARIANT_TYPES, agent_copy, agent_warm, check_agents,
                         errs_ok, init_numpy_model, joint_batch, joint_kw,
                         joint_model, joint_networks, joint_step_on,
                         joint_warm, lgan_draws, lgan_step_on, lgan_warm,
                         make_clouds, named_leaves, network_errs, on_device,
                         random_transitions, rel_diff, rel_err, scaled_err,
                         synthetic_clouds)
from gan_rl_3d_tpu_torch import complete_clouds, evaluate, nn
from gan_rl_3d_tpu_torch import train_rl_gan_net
from gan_rl_3d_tpu_torch.config import (AETrainConfig, flagship_config,
                                        load_config)
from gan_rl_3d_tpu_torch.convert import (agent_from_numpy, agent_to_numpy,
                                         load_chain, model_from_numpy)
from gan_rl_3d_tpu_torch.data.dataset import (DATA_SHARD_GROUPS, BatchLoader,
                                              ShapeNetDataset, load_ply,
                                              load_txt_plain, setup_dataset)
from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch.models import inference
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.ops import _cuda, chamfer
from gan_rl_3d_tpu_torch.ops import bn_train as bt
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.ops.metrics import evaluate_completion
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
from gan_rl_3d_tpu_torch.train import gate as gate_lib
from gan_rl_3d_tpu_torch.train import replay_buffer as rb
from gan_rl_3d_tpu_torch.train import steps
from gan_rl_3d_tpu_torch.train import trainer as trainer_lib
from gan_rl_3d_tpu_torch.train.trainer import PHASES, RLGANNetTrainer
from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt_lib
from gan_rl_3d_tpu_torch.utils.ply import save_ply
from gan_rl_3d_tpu_torch.utils.torch_convert import load_reference_checkpoint
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parent.parent
SCAN_CENTRE = np.array([10.0, -2.0, 3.0])

# the kernels each path must launch
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
# the trained checkpoint: the three engines (K1 f32, K1 bf16 on the tensor
# cores, K6), evaluate's metrics (K2, K3) and the joint step (K3-K5)
TRAINED_KERNELS = ("encoder_pool_f32", "encoder_pool_bf16",
                   "encoder_pool_int8", "nn_dist", "nn_min", "nn_gather",
                   "nn_scatter")
# the data path: the AE validation's Chamfer (K3 twice a batch)
DATA_KERNELS = ("nn_dist",)
# the variant family: the AE, joint and gate Chamfer losses (K3 forward,
# K4/K5 backward), the RL reward (K3), evaluate's metrics (K2, K3); it
# folds into no engine, so no K1 or K6
VARIANT_KERNELS = ("nn_dist", "nn_gather", "nn_scatter", "nn_min")
MULTI_KERNELS = ("encoder_pool_f32", "nn_dist", "nn_gather", "nn_scatter")

# phases 2-4 at the recipe, cut to the run
RL_ITERS = 6        # iterations of train_rl_agent: 256 transitions at the
                    # 4th, so iterations 4-6 run 64 TD3 updates each
RL_WARMUP, RL_RAMP = 96, 24  # the recipe's 2000 / 1500, cut to the run
RL_PREFILL = 256    # buffer rows before the rl_step checked
# phases 5 and 5.5 at the shipped recipe's joint block (bf16_selective,
# B=64, lr 1e-4, weight decay 1e-5, w_ae_recon 1, calibrate_gate), cut to
# the run: 1 epoch (the recipe's 4) of 2 steps on the 128 synthetic train
# clouds, and 16 D refresh steps (the recipe's 400)
JOINT_EPOCHS = 1
JOINT_REFRESH = 16
# the variant family at the flagship widths through the whole curriculum,
# cut as the joint path: 2 RL iterations (128 transitions, under the
# recipe's 256 before the first TD3 update)
VARIANT_RL_ITERS = 2
B_VARIANT_BIG = 4096  # the variant's unfolded complete at a serving batch

# the repo's trained weights: orbax directories the JAX trainer wrote
TRAINED_DIR = REPO / "runs" / "best7" / "probe_lgan30" / "ckpt_lgan30"
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

# the multi path: the ("data", "model") mesh over torch.distributed
MULTI_WORLDS = (2, 4)   # gloo ranks sharing the one card
MULTI_AE_STEPS = 3
TOL_MULTI_LOSS = 1e-4   # relative, of the one process's loss
TOL_MULTI_SERVE = 1e-5  # the f32 engine's outputs, DP against one process

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


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def launched_since(before: dict) -> dict:
    """Kernel launches since the snapshot ``before`` of launch_counts."""
    return {k: v - before.get(k, 0) for k, v in _cuda.launch_counts.items()
            if v > before.get(k, 0)}


def assert_launched(counts: dict, names, path: str) -> None:
    for name in names:
        assert counts.get(name, 0) > 0, (
            f"{name} never launched on the {path} path: {counts}")


def captured(fn, *args):
    """(fn(*args), what it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def write_config(cfg, path: Path) -> Path:
    """``cfg`` as the JSON the CLIs read (the card's machine may lack
    PyYAML's writer)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dataclasses.asdict(cfg)))
    return path


def write_scans(folder: Path, seed: int) -> list:
    """Three scans of 1500, 2048 and 3000 points (.txt, .ply, .txt) far
    from the origin, as a user's files would be."""
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
    complete_clouds.main([*map(str, inputs), *args, "--output-dir",
                          str(out_dir)])
    for src in inputs:
        pts = load_ply(out_dir / f"{src.stem}_completed.ply")
        assert pts.shape == (n_out, 3) and np.isfinite(pts).all(), (
            f"served {src.name} ({args}): {pts.shape}")
        # written in the input's frame: centred near the input's centroid
        assert np.abs(pts.mean(0) - SCAN_CENTRE).max() < 5.0, (
            f"served {src.name} not in the input frame")


def evaluate_checked(argv) -> tuple:
    """``evaluate.main(argv)``: (its metrics, all finite and at least 5,
    what it printed)."""
    stats, out = captured(evaluate.main, argv)
    assert len(stats) >= 5 and all(np.isfinite(v) for v in stats.values()), (
        f"evaluate {argv}: non-finite or missing metrics {stats}")
    return stats, out


def engine_checks(model, target, mask, cfg, int8_gfv_tol=TOL_INT8_GFV):
    """The three engines of ``model`` against the unfolded ``complete``:
    the f32 engine within TOL_F32 in every gate mode, the bf16 engine
    within TOL_BF16 of f32, the int8 engine's GFV within ``int8_gfv_tol``
    of f32 and its clouds within TOL_INT8_PC of ``complete``. Returns the
    f32 and int8 engines."""
    engine = inference.prepare_inference_engine(model)
    for mode in ("discriminator", "rl", "ae", "union"):
        ref = net.complete(model, target, mask, cfg=cfg, gate_mode=mode)
        fast = inference.complete_fast(engine, target, mask, gate_mode=mode)
        assert set(ref) == set(fast), f"{mode}: output keys differ"
        for k in ref:
            r, f = ref[k], fast[k]
            if k == "hybrid_output" and mode == "discriminator":
                margin = (ref["rl_gan_score"] - ref["ae_score"])[:, 0].abs()
                r, f = r[margin > 1e-4], f[margin > 1e-4]
            e = scaled_err(f, r)
            assert e <= TOL_F32, f"complete_fast {mode} {k}: err {e:.3e}"

    engine_bf16 = inference.prepare_inference_engine(model,
                                                     dtype=torch.bfloat16)
    f32 = inference.complete_fast(engine, target, mask, gate_mode="rl")
    bf = inference.complete_fast(engine_bf16, target, mask, gate_mode="rl")
    e = max(rel_err(bf[k], f32[k]) for k in
            ("noisy_gfv", "z_vector", "clean_gfv", "completed_pc",
             "ae_reconstruction"))
    assert e <= TOL_BF16, f"bf16 engine disagrees with f32: {e:.3e}"

    engine_q = inference.prepare_inference_engine(model, quantize_int8=True)
    for mode in ("discriminator", "rl", "ae", "union"):
        ref = net.complete(model, target, mask, cfg=cfg, gate_mode=mode)
        f32 = inference.complete_fast(engine, target, mask, gate_mode=mode)
        q = inference.complete_fast(engine_q, target, mask, gate_mode=mode)
        assert set(q) == set(ref), f"int8 {mode}: output keys differ"
        gfv = rel_err(q["noisy_gfv"], f32["noisy_gfv"])
        pc_err = max(float((q[k] - ref[k]).abs().max())
                     for k in ("completed_pc", "ae_reconstruction"))
        hq, hr = q["hybrid_output"], ref["hybrid_output"]
        if mode == "discriminator":
            # a row's gate cannot flip where the reference margin exceeds
            # how far the int8 engine moved the two scores
            margin = (ref["rl_gan_score"] - ref["ae_score"])[:, 0].abs()
            shift = ((q["rl_gan_score"] - ref["rl_gan_score"]).abs()
                     + (q["ae_score"] - ref["ae_score"]).abs())[:, 0]
            settled = margin > shift
            hq, hr = hq[settled], hr[settled]
        hyb = float((hq - hr).abs().max()) if hq.numel() else 0.0
        assert (gfv <= int8_gfv_tol and pc_err <= TOL_INT8_PC
                and hyb <= TOL_INT8_PC), (
            f"int8 engine disagrees ({mode}): noisy_gfv {gfv:.3e}, clouds "
            f"{pc_err:.3e}, hybrid_output {hyb:.3e}")
    return engine, engine_q


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
    kernel, picks, gaps = chamfer._nearest_forward, [], []

    def recorded(a, b, b_mask):
        dist, idx = kernel(a, b, b_mask)
        picks.append(idx.cpu().long())
        return dist, idx

    def shared(a, b, b_mask):
        assert len(gaps) < len(picks), (
            "the CPU ran more nearest-neighbour searches than the card")
        d2 = chamfer._sqdist(a.float(), b.float(), b_mask)
        dmin, own = d2.min(dim=-1)
        card = picks[len(gaps)].to(a.device)
        gap = d2.gather(-1, card[..., None])[..., 0] - dmin
        take = (card != own) & (gap <= TIE_GAP)
        gaps.append(gap[take].tolist())
        idx = torch.where(take, card, own)
        dmin = d2.gather(-1, idx[..., None])[..., 0]
        return torch.sqrt(torch.clamp(dmin, min=1e-12)), idx.to(torch.int32)

    return (mock.patch.object(chamfer, "_nearest_forward", recorded),
            mock.patch.object(chamfer, "_nearest_forward", shared), gaps)


def trainer_view(cfg, **extra):
    """What the step checks read of a trainer, from a config."""
    return types.SimpleNamespace(
        config=cfg, td3=cfg.td3_config(), preproc=cfg.preproc_spec(),
        bidirectional=cfg.loss.bidirectional,
        bn_stats=cfg.training.bn_stats,
        recon_loss=cfg.loss.reconstruction_loss, **extra)


def variant_config(cfg):
    """``cfg`` with the variant family's model block."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, autoencoder=dataclasses.replace(cfg.model.autoencoder,
                                                   **VARIANT_TYPES)))


# ---------------------------------------------------------------------------
# one step on the card against the same step on CPU copies
# ---------------------------------------------------------------------------


def step_check(device, ae_model):
    """One f32 ae_train_step at B=8 on the card and on the CPU, from the
    same weights, batch and draws, near-tie picks shared
    (``tie_sharing``): the loss and every gradient."""
    pc, _ = make_clouds(B_STEP_CHECK, N_MAIN, seed=20, device=device)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(21),
                                       B_STEP_CHECK, N_MAIN)
    on_card, on_cpu, gaps = tie_sharing()
    results = []
    for dev, ties in ((device, on_card), (torch.device("cpu"), on_cpu)):
        params = on_device(ae_model["params"], dev, grad=True)
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
                        [p.grad.cpu() for p in tree_leaves(params)]))
    (loss, grads), (ref_loss, ref_grads) = results
    scale = max(float(g.abs().max()) for g in ref_grads)
    e = max(float((g - r).abs().max()) for g, r in zip(grads, ref_grads))
    e /= scale
    le = abs(loss - ref_loss) / abs(ref_loss)
    assert le <= TOL_STEP_LOSS and e <= TOL_STEP_GRAD, (
        f"the f32 step on the card disagrees with the CPU: loss {le:.3e}, "
        f"gradients {e:.3e}; near-tie picks shared {gaps}")


def joint_step_check(device, trainer):
    """One f32 ``joint_train_step`` at B=8, full width, on the card and on
    CPU copies from the same weights, draws and Adam moments one step old:
    the loss, each network's update, its state; lr 0 and twice the lr on
    the card must fail the update check."""
    cpu = torch.device("cpu")
    jc = trainer.config.training.joint
    warm = joint_warm(trainer, seed=60)
    start = joint_networks(warm[0])
    batch, draws = joint_batch(trainer, seed=61)
    (sm, card), (ref_m, ref) = (joint_step_on(dev, warm, trainer, batch,
                                              draws) for dev in (device, cpu))
    le = {k: rel_diff(sm[k], ref_m[k]) for k in ("loss", "chamfer", "gfv")}
    errs = {k: network_errs(card[k], ref[k], start[k]) for k in card}
    assert max(le.values()) <= TOL_RL_LOSS and errs_ok(
        errs.values(), 2 * jc.lr, TOL_JOINT_UPDATE), (
        f"joint_train_step: the card disagrees with the CPU: {le}, {errs}")
    for scale in (0.0, 2.0):
        _, wrong = joint_step_on(device, warm, trainer, batch, draws,
                                 lr_scale=scale)
        power = {k: network_errs(wrong[k], ref[k], start[k])[0]
                 for k in card}
        assert min(power.values()) > TOL_JOINT_UPDATE, (
            f"joint_train_step: the update check passes a step with lr x "
            f"{scale:g}: {power}")


def joint_checks(device, trainer):
    """``joint_step_check``, then ``gate_stats_step`` on a val batch, card
    against CPU."""
    cpu = torch.device("cpu")
    joint_step_check(device, trainer)
    vb = next(iter(trainer.val_loader))
    vbatch = {"complete_pc": torch.from_numpy(vb["complete_pc"]),
              "pad": torch.from_numpy(vb["pad"])}
    vdraws = on_device(trainer._fixed_holes(
        trainer_lib.GATE_HOLES, 0, *vbatch["complete_pc"].shape[:2]), cpu)
    model_cpu = {k: on_device(trainer.model[k], cpu) for k in ("ae", "lgan")}
    model_cpu["agent"] = {"actor": on_device(trainer.model["agent"]["actor"],
                                             cpu)}
    if "gan_path" in trainer.model:
        model_cpu["gan_path"] = on_device(trainer.model["gan_path"], cpu)
    kw = dict(cfg=trainer.td3, spec=trainer.preproc,
              bidirectional=trainer.bidirectional)
    gs = gate_lib.gate_stats_step(trainer.model, on_device(vbatch, device),
                                  on_device(vdraws, device), **kw)
    ref_gs = gate_lib.gate_stats_step(model_cpu, vbatch, vdraws, **kw)
    cd = max(scaled_err(gs[k].cpu(), ref_gs[k]) for k in ("cd_rl", "cd_ae"))
    me = (float((gs["margin"].cpu() - ref_gs["margin"]).abs().max())
          / float(ref_gs["margin"].abs().max()))
    assert cd <= TOL_F32 and me <= TOL_GATE_MARGIN, (
        f"gate_stats_step: the card disagrees with the CPU: Chamfer "
        f"distances {cd:.3e}, margins {me:.3e}")


def variant_ae_warm(trainer, seed):
    """The variant AE {"params", "state"} on the CPU after one f32
    ``ae_train_step`` from the trainer's, and its Adam's state (moments
    one step old, as joint_warm)."""
    cpu = torch.device("cpu")
    ae = trainer.model["ae"]
    params = on_device(ae["params"], cpu, grad=True)
    state = on_device(ae["state"], cpu)
    opt, _ = steps.make_ae_optimizer(params, trainer.config.training
                                     .autoencoder, 1)
    state, _ = steps.ae_train_step(params, state, opt,
                                   *joint_batch(trainer, seed),
                                   **ae_kw(trainer))
    return {"params": params, "state": state}, opt.state_dict()


def ae_kw(trainer):
    return dict(spec=trainer.preproc, bn_stats=trainer.bn_stats,
                recon_loss=trainer.recon_loss,
                bidirectional=trainer.bidirectional)


def variant_ae_step_on(dev, warm, trainer, batch, draws, lr_scale=1.0):
    """One f32 ``ae_train_step`` on ``dev`` from ``variant_ae_warm``'s
    weights and Adam state, lr times ``lr_scale``: (metrics, {"encoder",
    "decoder"} each {"params", "state"})."""
    ac = trainer.config.training.autoencoder
    params = on_device(warm[0]["params"], dev, grad=True)
    state = on_device(warm[0]["state"], dev)
    opt, _ = steps.make_ae_optimizer(params, ac, 1)
    opt.load_state_dict(copy.deepcopy(warm[1]))
    for group in opt.param_groups:
        group["lr"] = ac.lr * lr_scale
    state, m = steps.ae_train_step(params, state, opt, on_device(batch, dev),
                                   on_device(draws, dev), **ae_kw(trainer))
    return m, {k: {"params": params[k], "state": state[k]}
               for k in ("encoder", "decoder")}


def variant_step_check(device, trainer):
    """One f32 variant ``ae_train_step`` at B=8, full width, on the card and
    on CPU copies from the same weights, draws and Adam moments one step
    old, near-tie picks shared (``tie_sharing``): the loss within
    TOL_RL_LOSS, each network's update within TOL_RL_UPDATE of the CPU's
    in the 2-norm, its state within TOL_RL_PARAM; lr 0 and twice the lr
    on the card must fail."""
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
    le = rel_diff(sm["loss"], ref_m["loss"])
    errs = {k: network_errs(card[k], ref[k], start[k]) for k in card}
    assert le <= TOL_RL_LOSS and errs_ok(errs.values(), 2 * lr), (
        f"variant ae_train_step: the card disagrees with the CPU: loss "
        f"{le:.3e}, {errs}; near-tie picks shared {gaps}")
    for scale in (0.0, 2.0):
        _, wrong = variant_ae_step_on(device, warm, trainer, batch, draws,
                                      lr_scale=scale)
        power = {k: network_errs(wrong[k], ref[k], start[k])[0]
                 for k in card}
        assert min(power.values()) > TOL_RL_UPDATE, (
            f"variant ae_train_step: the update check passes a step with lr "
            f"x {scale:g}: {power}")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_serving_path(cuda, tmp_path):
    """The flagship with random weights from a fixed seed at B=64, N=2048:
    ``complete`` against ``complete_fast`` (f32, all gate modes), the bf16
    engine against f32, the int8 engine against f32 and ``complete``;
    f32 and int8 engine files served by ``complete_clouds --engine`` on
    .txt and .ply scans; the completions scored by
    ``evaluate_completion``. K1 (f32, bf16), K6, K3 and K2 launch."""
    cfg = flagship_config()
    model = model_from_numpy(init_numpy_model(cfg, seed=0), device=cuda)
    target, mask = make_clouds(B_MAIN, N_MAIN, seed=4, device=cuda)
    before = dict(_cuda.launch_counts)
    engine, engine_q = engine_checks(model, target, mask, cfg.td3_config())
    eng_path, q_path = tmp_path / "engine.pkl", tmp_path / "engine_q.pkl"
    inference.save_engine(str(eng_path), engine)
    inference.save_engine(str(q_path), engine_q)
    inputs = write_scans(tmp_path / "scans", seed=5)
    for path, mode, n_out in ((eng_path, "discriminator", N_MAIN),
                              (eng_path, "union", 2 * N_MAIN),
                              (q_path, "discriminator", N_MAIN)):
        serve_files(inputs, tmp_path / f"out_{path.stem}_{mode}",
                    ["--engine", str(path), "--gate-mode", mode, "--device",
                     cuda.type], n_out)
    completion = inference.complete_fast(engine, target, mask)["hybrid_output"]
    scores = evaluate_completion(
        completion, target,
        metrics=("chamfer_distance", "completion_ratio",
                 "hausdorff_distance", "f_score"))
    assert all(bool(torch.isfinite(v)) for v in scores.values()), scores
    assert_launched(launched_since(before), SERVING_KERNELS, "serving")


# ---------------------------------------------------------------------------
# the curriculum: phase 1, phases 2-4, phases 5 and 5.5
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("card_paths")


@pytest.fixture(scope="module")
def dataset_cfg(cuda, workdir):
    """The flagship recipe (bf16_selective, B=64) on a synthetic dataset
    the port writes (8 categories x 16 train clouds: 2 steps an epoch),
    2 AE epochs, its checkpoints under the run's directory."""
    setup_dataset(str(workdir / "data"), synthetic=True,
                  samples_per_category=16)
    cfg = flagship_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data,
                                      data_dir=str(workdir / "data")),
        training=dataclasses.replace(
            cfg.training, checkpoint_dir=str(workdir / "ckpt"),
            autoencoder=dataclasses.replace(cfg.training.autoencoder,
                                            epochs=2)))


@pytest.fixture(scope="module")
def phase1(cuda, dataset_cfg):
    """``RLGANNetTrainer(...).train_autoencoder()``, a checkpoint and its
    train state every epoch (for the resume); the later phases keep the
    recipe's frequency."""
    every_epoch = dataclasses.replace(dataset_cfg, logging=dataclasses.replace(
        dataset_cfg.logging, save_model_frequency=1))
    trainer = RLGANNetTrainer(every_epoch, device=cuda)
    before = dict(_cuda.launch_counts)
    best = trainer.train_autoencoder()
    return types.SimpleNamespace(trainer=trainer, cfg=every_epoch, best=best,
                                 counts=launched_since(before))


def resume_checks(device, tmp: Path, cfg):
    """Mid-phase resume on the card: ``train_rl_gan_net --phase autoencoder
    --resume autoencoder_epoch_1`` in a copy of phase 1's checkpoints runs
    only epoch index 1 from the restored train state, whose Adam moments,
    loaded onto the card, equal the saved ones bit for bit, with Adam's
    step and the schedule at the saved count; with the sibling deleted the
    same command starts with a fresh optimizer and runs both epochs."""
    src, ckpt = Path(cfg.training.checkpoint_dir), tmp / "ckpt_resume"
    ckpt.mkdir()
    for name in ("autoencoder_epoch_1", "autoencoder_epoch_1_trainstate"):
        assert (src / name).is_file(), f"phase 1 did not write {name}"
        shutil.copy(src / name, ckpt / name)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, checkpoint_dir=str(ckpt)))
    cfg_path = write_config(cfg, tmp / "resume.json")
    saved = ckpt_lib.load_checkpoint(str(ckpt / "autoencoder_epoch_1_"
                                         "trainstate"))
    adam = saved["opt_state"][1]
    count = int(adam.count)
    trainer = RLGANNetTrainer(cfg, device=device)
    spe = len(trainer.train_loader)
    assert count == spe and int(saved["epoch"]) == 0, (
        f"train state: count {count}, epoch {int(saved['epoch'])}")
    trainer.load_checkpoint("autoencoder_epoch_1")
    params = trainer.model["ae"]["params"]
    opt, sched = steps.make_ae_optimizer(params, cfg.training.autoencoder, spe)
    load_chain(opt, params, trainer._restore_train_state("autoencoder")[
        "opt_state"], sched)
    mus, nus = tree_leaves(adam.mu), tree_leaves(adam.nu)
    for p, mu, nu in zip(tree_leaves(params), mus, nus):
        st = opt.state[p]
        assert (st["exp_avg"].device.type == device.type
                and float(st["step"]) == count
                and torch.equal(st["exp_avg"].cpu(), torch.from_numpy(mu))
                and torch.equal(st["exp_avg_sq"].cpu(),
                                torch.from_numpy(nu))), (
            "restored Adam state differs from the saved one")
    assert sched.last_epoch == count, "the schedule's step is not the saved"

    argv = ["--config", str(cfg_path), "--phase", "autoencoder", "--resume",
            "autoencoder_epoch_1", "--device", device.type]
    _, out = captured(train_rl_gan_net.main, argv)
    epochs = re.findall(r"^AE epoch (\d+)/", out, re.M)
    assert "restored autoencoder train state" in out and epochs == ["2"], (
        f"the resumed run did not run epoch index 1 alone: epochs {epochs}")
    (ckpt / "autoencoder_epoch_1_trainstate").unlink()
    _, out = captured(train_rl_gan_net.main, argv)
    epochs = re.findall(r"^AE epoch (\d+)/", out, re.M)
    assert "fresh optimizer" in out and epochs == ["1", "2"], (
        f"without its train state the resume did not start fresh: {epochs}")


def eval_checks(device, tmp: Path, cfg):
    """The serving side on phase 1's checkpoint, through the CLIs a user
    calls: ``evaluate --checkpoint autoencoder_best --export-engine``, then
    ``complete_clouds --checkpoint`` and ``--engine`` (the exported
    engine) on a few files. Returns their launches."""
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, results_dir=str(tmp / "results")))
    cfg_path = write_config(cfg, tmp / "run.json")
    assert load_config(str(cfg_path)) == cfg, "config JSON round trip"
    engine_path = tmp / "engine_eval.pkl"
    inputs = write_scans(tmp / "scans_eval", seed=6)
    before = dict(_cuda.launch_counts)
    evaluate_checked(["--config", str(cfg_path), "--checkpoint",
                      "autoencoder_best", "--num-export", "2",
                      "--export-engine", str(engine_path), "--device",
                      device.type])
    assert ((tmp / "results" / "results_viewer.html").exists()
            and len(list((tmp / "results" / "point_clouds").glob("*.ply")))
            == 6), "evaluate: report or PLY samples missing"
    for args in (["--checkpoint", "autoencoder_best"],
                 ["--engine", str(engine_path)]):
        serve_files(inputs, tmp / f"out_eval_{args[0][2:]}",
                    [*args, "--config", str(cfg_path), "--device",
                     device.type], N_MAIN)
    return launched_since(before)


@pytest.mark.cuda
def test_ae_training_path(cuda, phase1, dataset_cfg, workdir):
    """Phase 1 at full width through the trainer the CLI calls (2 epochs
    of 2 steps at B=64, bf16_selective): every loss finite, K3, K4 and K5
    launched, the best checkpoint reloaded; one f32 ``ae_train_step`` at
    B=8 on the card against the CPU (``step_check``); mid-phase resume
    (``resume_checks``); ``evaluate --export-engine`` and
    ``complete_clouds`` on the checkpoint, K1, K3 and K2 launched."""
    trainer = phase1.trainer
    losses = trainer.train_losses
    assert (len(losses) == 4 and all(np.isfinite(losses))
            and np.isfinite(phase1.best)), (
        f"non-finite or missing training loss: {losses}, {phase1.best}")
    assert_launched(phase1.counts, TRAINING_KERNELS, "training")
    saved = trainer.model["ae"]
    assert (workdir / "ckpt" / "autoencoder_best").exists()
    epoch, phase = trainer.load_checkpoint("autoencoder_best")
    assert (epoch, phase) == (1, "autoencoder"), (epoch, phase)
    for a, b in zip(tree_leaves(saved), tree_leaves(trainer.model["ae"])):
        assert torch.equal(a.detach(), b.detach()), (
            "reloaded checkpoint differs from the trained model")
    step_check(cuda, trainer.model["ae"])
    resume_checks(cuda, workdir, phase1.cfg)
    assert_launched(eval_checks(cuda, workdir, dataset_cfg), EVAL_KERNELS,
                    "evaluation")


def rl_config(cfg):
    """The shipped recipe's phases 3-4 cut to the run: 1 LGAN epoch,
    RL_ITERS RL iterations, the critic warmup and actor ramp cut so the
    actor updates within them."""
    t = cfg.training
    return dataclasses.replace(cfg, training=dataclasses.replace(
        t, lgan=dataclasses.replace(t.lgan, epochs=1),
        rl_agent=dataclasses.replace(
            t.rl_agent, episodes=RL_ITERS * t.rl_agent.envs_per_step,
            actor_warmup=RL_WARMUP, actor_lr_ramp=RL_RAMP)))


@pytest.fixture(scope="module")
def phase4(cuda, phase1, dataset_cfg):
    """Phases 2-4 as ``--phase lgan --resume autoencoder_best`` and
    ``--phase rl_agent`` run them: GFV extraction over the train split, 1
    LGAN epoch, RL_ITERS RL iterations."""
    cfg = rl_config(dataset_cfg)
    trainer = RLGANNetTrainer(cfg, device=cuda)
    trainer.load_checkpoint("autoencoder_best")
    before = dict(_cuda.launch_counts)
    gfvs = trainer.generate_gfvs()
    trainer.train_latent_gan()
    actor = [v.detach().clone() for v in
             tree_leaves(trainer.model["agent"]["actor"]["params"])]
    trainer.train_rl_agent()
    return types.SimpleNamespace(trainer=trainer, cfg=cfg, gfvs=gfvs,
                                 actor=actor, counts=launched_since(before))


def rl_checks(device, trainer):
    """One lgan_combined_step, one agent_update and one rl_step (64
    updates) at full width on the card and on CPU copies, from the same
    weights, optimizer state, buffer and draws; lr 0 on the card fails the
    update checks of the first two."""
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
    le = {k: rel_diff(sm[k], ref_m[k]) for k in ("d_loss", "g_loss")}
    errs = {k: network_errs(card[k], ref[k], start[k]) for k in card}
    assert max(le.values()) <= TOL_RL_LOSS and errs_ok(
        errs.values(), 2 * lc.generator_lr * lc.d_steps), (
        f"lgan_combined_step: the card disagrees with the CPU: {le}, {errs}")
    # the update check's power: the same step on the card with lr 0
    _, frozen = lgan_step_on(device, warm, cfg, real[1], draws, lr_scale=0.0)
    power = {k: network_errs(frozen[k], ref[k], start[k])[0] for k in card}
    assert min(power.values()) > TOL_RL_UPDATE, (
        f"lgan_combined_step: the update check passes a step with lr 0: "
        f"{power}")

    batch = random_transitions(td3.batch_size, td3, 42, cpu)
    noise = torch.randn((td3.batch_size, td3.action_dim),
                        generator=torch.Generator().manual_seed(43))
    frozen_cfg = td3._replace(actor_lr=0.0, critic_lr=0.0)
    agents, ms = {}, {}
    for key, dev, c in (("card", device, td3), ("cpu", cpu, td3),
                        ("frozen", device, frozen_cfg)):
        agents[key] = agent_copy(trainer.model["agent"], dev, c)
        _, ms[key] = rl.agent_update(
            agents[key], rl.TransitionBatch(*(v.to(dev) for v in batch)),
            noise.to(dev), c)
    le = max(rel_diff(ms["card"][k], ms["cpu"][k])
             for k in ("critic_loss", "actor_loss"))
    assert le <= TOL_RL_LOSS, f"agent_update: losses differ ({le:.3e})"
    start = trainer.model["agent"]
    check_agents("agent_update", agents["card"], agents["cpu"], start, 1,
                 td3.critic_lr)
    power = {n: network_errs(agents["frozen"][n], agents["cpu"][n],
                             start[n])[0] for n in rl.NETWORKS}
    assert min(power["critic1"], power["critic2"]) > TOL_RL_UPDATE, (
        f"agent_update: the update check passes a step with lr 0: {power}")

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
    for key, dev in (("card", device), ("cpu", cpu)):
        model = {**{k: on_device(trainer.model[k], dev)
                    for k in ("ae", "lgan")},
                 "agent": agent_copy(start, dev, td3)}
        buf = rb.ReplayBuffer(cfg.model.rl_agent.buffer_size,
                              td3.state_dim, td3.action_dim, dev)
        buf.add_batch(rl.TransitionBatch(*(v.to(dev) for v in pre)))
        model, buf, ou, sm = steps.rl_step(
            model, buf, rl.ou_init(td3, (envs,), dev),
            {"complete_pc": pc.to(dev), "pad": torch.zeros(envs, device=dev)},
            on_device(rl_draws, dev), cfg=td3, w_chamfer=cfg.loss.w_chamfer,
            w_gfv=cfg.loss.w_gfv, w_discriminator=cfg.loss.w_discriminator,
            start_training_size=rc.start_training_steps,
            updates_per_step=rc.updates_per_step, spec=trainer.preproc)
        rows = {name: getattr(buf, name)[:RL_PREFILL + envs]
                for name in rb.FIELDS}
        res[key] = (model, rows, ou, sm)
    (model, rows, ou, sm), (r_model, r_rows, r_ou, r_sm) = (res["card"],
                                                          res["cpu"])
    le = max(rel_diff(sm[k], r_sm[k]) for k in ("reward", "critic_loss",
                                                 "actor_loss"))
    be = max(scaled_err(rows[k].cpu(), r_rows[k]) for k in rows)
    oe = scaled_err(ou.cpu(), r_ou)
    assert le <= TOL_RL_LOSS and be <= TOL_RL_PARAM and oe <= TOL_RL_PARAM, (
        f"rl_step: the card disagrees with the CPU: reward and losses "
        f"{le:.3e}, buffer rows {be:.3e}, OU state {oe:.3e}")
    check_agents("rl_step", model["agent"], r_model["agent"], start,
                 rc.updates_per_step, td3.critic_lr)


@pytest.mark.cuda
def test_rl_path(cuda, phase4):
    """Phases 2-4 at full width from phase 1's checkpoint (batch 16, 3 D
    steps a G step; 64 environments, 64 TD3 updates an iteration from 256
    transitions on): finite GFVs, losses and rewards, the actor changed,
    K3 launched in the reward, ``rl_agent_final`` reloaded bit for bit
    into a fresh trainer and ``complete`` run on it; then ``rl_checks``."""
    trainer, cfg = phase4.trainer, phase4.cfg
    n_train = len(trainer.train_loader.dataset)
    latent = cfg.model.lgan.latent_dim
    assert all(v.shape == (n_train, latent) and np.isfinite(v).all()
               for v in phase4.gfvs.values()), (
        "GFV extraction: wrong shapes or non-finite values")
    (g_loss, d_loss), = trainer.lgan_losses
    assert np.isfinite([g_loss, d_loss]).all(), "non-finite LGAN loss"
    assert (Path(cfg.training.checkpoint_dir) / "lgan_best").exists()
    hist = trainer.rl_history
    rewards = [h["reward"] for h in hist]
    losses = [(float(h["critic_loss"]), float(h["actor_loss"]))
              for h in hist]
    assert (len(hist) == RL_ITERS and np.isfinite(rewards).all()
            and np.isfinite(losses).all()), (
        f"non-finite RL reward or loss: {rewards}, {losses}")
    updates = cfg.training.rl_agent.updates_per_step
    assert trainer.model["agent"]["step"] == (RL_ITERS - 3) * updates, (
        "wrong number of TD3 updates")
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(
        tree_leaves(trainer.model["agent"]["actor"]["params"]),
        phase4.actor))
    assert moved > 0, "the actor did not change"
    assert_launched(phase4.counts, RL_KERNELS, "RL")
    fresh = RLGANNetTrainer(cfg, device=cuda)
    fresh.load_checkpoint("rl_agent_final")
    for a, b in zip(tree_leaves(agent_to_numpy(trainer.model["agent"])),
                    tree_leaves(agent_to_numpy(fresh.model["agent"]))):
        assert np.array_equal(a, b), "rl_agent_final reloads differently"
    pc, mask = make_clouds(8, N_MAIN, seed=30, device=cuda)
    out = net.complete(fresh.model, pc, mask, cfg=fresh.td3)
    assert out["hybrid_output"].shape == (8, N_MAIN, 3) and all(
        bool(torch.isfinite(v).all()) for v in out.values()), (
        "complete on rl_agent_final: wrong shape or non-finite")
    rl_checks(cuda, trainer)


def joint_config(cfg, tmp: Path):
    """The recipe's joint block cut to the run (JOINT_EPOCHS,
    JOINT_REFRESH); evaluate's report under ``tmp``."""
    t = cfg.training
    return dataclasses.replace(cfg, training=dataclasses.replace(
        t, results_dir=str(tmp / "results_joint"),
        joint=dataclasses.replace(t.joint, epochs=JOINT_EPOCHS,
                                  refresh_d_steps=JOINT_REFRESH)))


def rewritten(folder: Path, names, fn):
    """Run ``fn`` after dating the files ``names`` back to 2001: the set of
    those it rewrote."""
    old = 10 ** 18
    for n in names:
        os.utime(folder / n, ns=(old, old))
    fn()
    return {n for n in names if os.stat(folder / n).st_mtime_ns != old}


def refresh_changes(ckpt: Path) -> list:
    """The leaves ``joint_calibrated`` changed from ``joint_best``."""
    best, _ = ckpt_lib.load_model_checkpoint(str(ckpt), "joint_best")
    cal, _ = ckpt_lib.load_model_checkpoint(str(ckpt), "joint_calibrated")
    return sorted(".".join(map(str, p)) for (p, a), (_, b) in zip(
        named_leaves(best), named_leaves(cal))
        if not np.array_equal(np.asarray(a), np.asarray(b)))


@pytest.fixture(scope="module")
def phase5(cuda, phase4, workdir):
    """Phases 5 and 5.5 from phase 4's ``rl_agent_final`` as ``--phase
    joint`` drives them (``joint_training``, then ``post_joint_refresh``),
    what they wrote, then the default command ``train_rl_gan_net --phase
    full --resume rl_agent_final`` and the checkpoints it rewrote."""
    cfg = joint_config(phase4.trainer.config, workdir)
    ckpt = Path(cfg.training.checkpoint_dir)
    cfg_path = write_config(cfg, workdir / "joint.json")
    assert load_config(str(cfg_path)) == cfg, "config JSON round trip"
    trainer = RLGANNetTrainer(cfg, device=cuda)
    trainer.load_checkpoint("rl_agent_final")
    before = dict(_cuda.launch_counts)
    best = trainer.joint_training()
    trainer.post_joint_refresh()
    written = [name for name in ("joint_best", "joint_calibrated",
                                 gate_lib.GATE_FILE)
               if (ckpt / name).is_file()]
    sidecar = json.loads((ckpt / gate_lib.GATE_FILE).read_text())
    changed = refresh_changes(ckpt)
    # the default command: the JAX trainer's rule restarts at the phase the
    # checkpoint records (phase 4 for rl_agent_final), so phases 1-3 are
    # skipped and phase 4 runs again before phases 5 and 5.5
    names = sorted(p.name for p in ckpt.iterdir() if p.is_file()
                   and p.name.startswith(("autoencoder", "lgan", "rl_agent",
                                          "joint", "final")))
    full_run = rewritten(ckpt, names, lambda: train_rl_gan_net.main(
        ["--config", str(cfg_path), "--phase", "full", "--resume",
         "rl_agent_final", "--device", cuda.type]))
    return types.SimpleNamespace(
        trainer=trainer, cfg=cfg, cfg_path=cfg_path, ckpt=ckpt, best=best,
        written=written, sidecar=sidecar, changed=changed,
        full_run=full_run, before=before)


@pytest.mark.cuda
def test_joint_path(cuda, phase5, workdir):
    """Phases 5 and 5.5 at full width (the recipe's joint block cut to 1
    epoch of 2 steps, 16 D refresh steps): finite losses; ``joint_best``,
    ``joint_calibrated`` and the gate sidecar scoped to them and
    ``final``; the calibrated gate no worse than a fixed one; only D
    changed by the refresh; ``--phase full --resume rl_agent_final``
    skipped phases 1-3 and wrote ``final``; the calibrated ``final``
    served by ``evaluate --export-engine`` and ``complete_clouds
    --checkpoint`` / ``--engine``, each printing and using the sidecar's
    gate. K1-K5 launch on the path. Then one f32 ``joint_train_step`` and
    one ``gate_stats_step`` on the card against CPU copies
    (``joint_checks``)."""
    trainer, cfg, ckpt = phase5.trainer, phase5.cfg, phase5.ckpt
    assert (len(trainer.joint_losses) == JOINT_EPOCHS
            and np.isfinite(trainer.joint_losses).all()
            and np.isfinite(phase5.best)), (
        f"non-finite or missing joint loss: {trainer.joint_losses}")
    d_losses = trainer.refresh_d_losses
    assert len(d_losses) == JOINT_REFRESH and np.isfinite(d_losses).all(), (
        f"non-finite or missing D refresh loss: {d_losses}")
    assert phase5.written == ["joint_best", "joint_calibrated",
                              gate_lib.GATE_FILE], phase5.written
    report = trainer.gate_report
    assert (phase5.sidecar == report and report["checkpoints"]
            == ["joint_calibrated", "final"]), f"gate sidecar {phase5.sidecar}"
    assert report["val_chamfer_calibrated"] <= min(
        report["val_chamfer_raw_gate"], report["val_chamfer_rl"],
        report["val_chamfer_ae"]), "the calibrated gate is worse than a fixed one"
    # the refresh changes D (its weights and spectral-norm vectors) and
    # nothing else, but the generator's BN running statistics, which the D
    # steps' training-mode generator advances (the JAX refresh keeps them)
    allowed = ("lgan.params.discriminator.", "lgan.state.discriminator.",
               "lgan.state.generator.")
    assert (all(c.startswith(allowed) for c in phase5.changed)
            and any(c.startswith(allowed[0]) for c in phase5.changed)), (
        f"the D refresh changed more than D: {phase5.changed}")
    written = phase5.full_run
    assert not any(n.startswith(("autoencoder", "lgan")) for n in written), (
        f"--phase full --resume rl_agent_final reran phases 1-3: {written}")
    assert ({"rl_agent_final", "joint_best", "joint_calibrated"} <= written
            and (ckpt / "final").is_file()), (
        "--phase full --resume rl_agent_final did not run phases 4-5.5 and "
        f"write final: {written}")
    report = json.loads((ckpt / gate_lib.GATE_FILE).read_text())
    assert report["checkpoints"] == ["joint_calibrated", "final"], report

    # serving the calibrated final
    gate = (report["gate_mode"], report["gate_bias"])
    calibrated = gate != (cfg.model.gate_mode, cfg.model.gate_bias)
    line = f"using calibrated gate: mode={gate[0]} bias={gate[1]:.4f}"
    engine_path = workdir / "engine_final.pkl"
    inputs = write_scans(workdir / "scans_joint", seed=8)
    _, out = evaluate_checked([
        "--config", str(phase5.cfg_path), "--checkpoint", "final",
        "--num-export", "2", "--export-engine", str(engine_path), "--device",
        cuda.type])
    assert (line in out) == calibrated, (
        f"evaluate did not report the calibrated gate {gate}")
    for args in (["--checkpoint", "final"], ["--engine", str(engine_path)]):
        _, out = captured(serve_files, inputs,
                          workdir / f"out_joint_{args[0][2:]}",
                          [*args, "--config", str(phase5.cfg_path),
                           "--device", cuda.type], N_MAIN)
        assert (line in out) == calibrated, (
            f"complete_clouds {args[0]} did not report the calibrated gate "
            f"{gate}")
    # used, not only printed: the checkpoint's completion of the first scan
    # is complete() with the sidecar's gate, in the scan's frame
    tree, _ = ckpt_lib.load_model_checkpoint(str(ckpt), "final")
    pc, mask, (centroid, scale) = complete_clouds._load_framed(
        str(inputs[0]), N_MAIN, np.random.RandomState(0))
    ref = net.complete(model_from_numpy(tree, device=cuda),
                       torch.from_numpy(pc[None]).to(cuda),
                       torch.from_numpy(mask[None]).to(cuda),
                       cfg=cfg.td3_config(), gate_mode=gate[0],
                       gate_bias=gate[1])["hybrid_output"][0].cpu().numpy()
    served = load_ply(workdir / "out_joint_checkpoint"
                      / f"{inputs[0].stem}_completed.ply")
    err = float(np.abs(served - (ref * scale + centroid)).max()) / scale
    assert err <= TOL_F32, (
        f"complete_clouds --checkpoint final did not use the calibrated "
        f"gate: {err:.3e}")
    assert_launched(launched_since(phase5.before), JOINT_KERNELS, "joint")
    joint_checks(cuda, trainer)


@pytest.mark.cuda
def test_pth_bridge(cuda, phase5, workdir):
    """The reference .pth bridge on the card, on the joint path's
    calibrated ``final`` (the PointNet family, which the reference layout
    holds): ``evaluate --checkpoint final --export-pth`` writes the pair,
    ``load_reference_checkpoint`` reads it back, and ``complete`` on it
    equals ``complete`` on the checkpoint bit for bit on the card."""
    cfg = load_config(str(phase5.cfg_path))
    pth = workdir / "final.pth"
    evaluate.main(["--config", str(phase5.cfg_path), "--checkpoint", "final",
                   "--metrics", "chamfer_distance", "--export-pth", str(pth),
                   "--device", cuda.type])
    bundle = load_reference_checkpoint(str(pth))
    served = {"ae": on_device(bundle["ae"], cuda),
              "lgan": on_device(bundle["lgan"], cuda),
              "agent": {"actor": on_device(bundle["agent_networks"]["actor"],
                                           cuda)}}
    tree, _ = ckpt_lib.load_model_checkpoint(cfg.training.checkpoint_dir,
                                             "final")
    model = model_from_numpy(tree, device=cuda)
    pc, mask = make_clouds(B_MAIN, N_MAIN, seed=80, device=cuda)
    ref = net.complete(model, pc, mask, cfg=cfg.td3_config())
    out = net.complete(served, pc, mask, cfg=cfg.td3_config())
    for k in ref:
        assert torch.equal(out[k], ref[k]), (
            f"complete on the .pth bridge's model differs in {k}")


# ---------------------------------------------------------------------------
# the repo's trained weights
# ---------------------------------------------------------------------------


def count_arrays(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_arrays(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_arrays(v) for v in tree)
    return int(isinstance(tree, np.ndarray))


def shapes(tree):
    return tree_map(np.shape, tree)


@pytest.mark.cuda
def test_trained_weights_path(cuda, dataset_cfg, tmp_path):
    """The committed trained checkpoints (the JAX package's orbax
    directories under runs/, read by the port's own reader from a copy):
    350 arrays, ``lgan_best``'s meta and the flagship's widths, its GFVs
    away from a random init's; the f32, bf16 and int8 engines on it at
    B=64, N=2048 against the serving limits, the int8 engine's GFVs
    against the same engine on the CPU; ``evaluate --checkpoint lgan_best
    --export-engine``, ``complete_clouds --checkpoint`` and ``--engine``;
    ``joint_checks`` on its weights. K1 (f32 and bf16), K6, K2, K3, K4 and
    K5 launch."""
    ckpt = tmp_path / "ckpt_trained"
    shutil.copytree(TRAINED_DIR, ckpt)
    before = dict(_cuda.launch_counts)
    trees = {name: ckpt_lib.load_model_checkpoint(str(ckpt), name)
             for name in ("autoencoder_best", "lgan_best")}
    tree, meta = trees["lgan_best"]
    assert (count_arrays(tree) + count_arrays(meta) == TRAINED_ARRAYS
            and count_arrays(trees["autoencoder_best"][0]) + 2
            == TRAINED_ARRAYS), "a trained checkpoint does not hold 350 arrays"
    assert (int(meta["epoch"]), PHASES[int(meta["phase_idx"])]) == (
        28, "lgan"), "lgan_best's meta"
    random_tree = init_numpy_model(flagship_config(), seed=0)
    for k in ("ae", "lgan"):
        assert shapes(tree[k]) == shapes(random_tree[k]), (
            f"lgan_best's {k} widths are not the flagship's")
    assert (shapes(tree["agent"]["actor"])
            == shapes(random_tree["agent"]["actor"])), (
        "lgan_best's actor widths are not the flagship's")

    td3 = flagship_config().td3_config()
    model = model_from_numpy(tree, device=cuda)
    target, mask = synthetic_clouds(B_MAIN, N_MAIN, seed=90, device=cuda)
    gfv = net.complete(model, target, mask, cfg=td3)["noisy_gfv"]
    rand = net.complete(model_from_numpy(random_tree, device=cuda),
                        target, mask, cfg=td3)["noisy_gfv"]
    assert bool(torch.isfinite(gfv).all()) and rel_err(gfv, rand) > 1e-2, (
        "trained GFVs are not finite or equal a random init's")
    # TOL_INT8_GFV was set on random weights; the JAX package's own int8
    # engine reads 2.2749e-2 on these weights and clouds
    _, engine_q = engine_checks(model, target, mask, td3,
                                int8_gfv_tol=TOL_INT8_GFV_TRAINED)
    # the int8 engine on the card against the same engine built and run on
    # the CPU (the plain K6, which equals the JAX package's int8 engine)
    engine_cpu = inference.prepare_inference_engine(
        model_from_numpy(tree, device=torch.device("cpu")),
        quantize_int8=True)
    card = inference.complete_fast(engine_q, target, mask, gate_mode="rl")
    ref = inference.complete_fast(engine_cpu, target.cpu(), mask.cpu(),
                                  gate_mode="rl")
    for k in ("noisy_gfv", "clean_gfv"):
        e = rel_err(card[k].cpu(), ref[k])
        assert e <= TOL_INT8_CARD, (
            f"int8 engine: the card disagrees with the CPU in {k}: {e:.3e}")

    cfg = dataclasses.replace(dataset_cfg, training=dataclasses.replace(
        dataset_cfg.training, checkpoint_dir=str(ckpt),
        results_dir=str(tmp_path / "results_trained")))
    cfg_path = write_config(cfg, tmp_path / "trained.json")
    engine_path = tmp_path / "engine_trained.pkl"
    evaluate_checked(["--config", str(cfg_path), "--checkpoint", "lgan_best",
                      "--num-export", "2", "--export-engine",
                      str(engine_path), "--device", cuda.type])
    inputs = write_scans(tmp_path / "scans_trained", seed=91)
    for args in (["--checkpoint", "lgan_best"],
                 ["--engine", str(engine_path)]):
        serve_files(inputs, tmp_path / f"out_trained_{args[0][2:]}",
                    [*args, "--config", str(cfg_path), "--device",
                     cuda.type], N_MAIN)
    trainer = RLGANNetTrainer(cfg, device=cuda)
    trainer.load_checkpoint("lgan_best")
    joint_checks(cuda, trainer)
    assert_launched(launched_since(before), TRAINED_KERNELS, "trained")


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------


def lgan30_config(data_dir: Path, ckpt_dir: Path):
    """runs/best7/probe_lgan30/config_lgan30.yaml (the recipe that trained
    the committed checkpoints) with ``data.data_dir`` and
    ``training.checkpoint_dir`` set to the run's copies, and its logs and
    results beside the checkpoints."""
    runs = {"checkpoint_dir": str(ckpt_dir),
            "log_dir": str(ckpt_dir.parent / "logs_data"),
            "results_dir": str(ckpt_dir.parent / "results_data")}
    return load_config(str(TRAINED_DIR.parent / "config_lgan30.yaml"),
                       overrides={"data": {"data_dir": str(data_dir)},
                                  "training": runs})


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
    def rows(x):
        return x[np.lexsort(x.T[::-1])]

    data = ds.as_array()
    for i in np.random.RandomState(seed).choice(len(ds), DATA_CHECKED,
                                                 replace=False):
        ref = load_txt_plain(Path(ds.files[i]["path"]))
        assert (ref.shape == data[i].shape
                and np.array_equal(rows(data[i]), rows(ref))), (
            f"{split} cloud {i} is not its file's rows")


def gfv_match(card: np.ndarray, committed: np.ndarray, device) -> dict:
    """Each card GFV's nearest committed GFV (L2, order-free): whether the
    map is one to one, and the pairs' largest differences as shares of the
    committed set's largest element."""
    a = torch.from_numpy(card).to(device)
    b = torch.from_numpy(committed).to(device)
    scale = float(b.abs().max())
    near, gaps = [], []
    for chunk in a.split(1024):
        d = torch.cdist(chunk, b,
                        compute_mode="donot_use_mm_for_euclid_dist")
        idx = d.topk(2, dim=1, largest=False).indices[:, 0]
        near.append(idx)
        gaps.append((chunk - b[idx]).abs().amax(dim=1) / scale)
    near, gaps = torch.cat(near), torch.cat(gaps).double()
    return {"one_to_one": int(torch.unique(near).numel()) == len(card),
            "max": float(gaps.max()),
            "p999": float(torch.quantile(gaps, 0.999)),
            "median": float(gaps.median())}


@pytest.mark.cuda
def test_data_path(cuda, tmp_path):
    """The data path (the port's C++ loader, the dataset, the batch plan,
    the two data CLIs) on best7's dataset, regenerated at full size, with
    the repo's trained AE: ``setup_dataset --synthetic
    --samples-per-category 1600 --test`` (12,800 / 3,200 / 3,200 clouds);
    each split cached at the config's workers, sampled clouds their files'
    rows, the shard-aligned plan; ``autoencoder_best``'s val Chamfer
    against the JAX package's f32 figure, two other hole streams reading
    other means, and with the cross term in bf16 against the TPU's; its
    clean train GFVs against the committed ones; ``test_rl_gan_net`` on
    the card. K3 launches in the validation."""
    data = tmp_path / "shapenet"
    out = subprocess.run(
        [sys.executable, "-m", "gan_rl_3d_tpu_torch.setup_dataset",
         "--data-dir", str(data), "--synthetic", "--samples-per-category",
         str(DATA_SAMPLES), "--test"], cwd=REPO, capture_output=True,
        text=True)
    assert out.returncode == 0, f"setup_dataset failed:\n{out.stderr}"
    assert "Data loading test passed" in out.stdout, out.stdout
    sizes = {s: len(list((data / s).rglob("*.txt")))
             for s in ("train", "val", "test")}
    per_cat = {"train": DATA_SAMPLES, "val": DATA_SAMPLES // 4,
               "test": DATA_SAMPLES // 4}
    assert sizes == {s: 8 * n for s, n in per_cat.items()}, sizes

    ckpt = tmp_path / "ckpt_data"
    shutil.copytree(TRAINED_DIR, ckpt)
    cfg = lgan30_config(data, ckpt)
    for i, split in enumerate(("train", "val", "test")):
        ds = ShapeNetDataset(str(data), split, N_MAIN,
                             seed=cfg.training.seed,
                             workers=cfg.training.num_workers)
        split_checks(ds, split, seed=i)
        if split == "train":
            loader = BatchLoader(ds, cfg.training.batch_size,
                                 seed=cfg.training.seed,
                                 shard_groups=DATA_SHARD_GROUPS)
            idx, _ = loader.epoch_indices()
            n, bs = len(ds), cfg.training.batch_size
            slot_group = np.arange(bs) // (bs // DATA_SHARD_GROUPS)
            assert (bool((idx // (n // DATA_SHARD_GROUPS)
                          == slot_group).all())
                    and np.array_equal(np.sort(idx.ravel()), np.arange(n))), (
                "the shard-aligned plan leaves a slot group's rows")
        del ds

    trainer = trainer_lib.RLGANNetTrainer(cfg, device=cuda)
    epoch, phase = trainer.load_checkpoint("autoencoder_best")
    assert (epoch, phase) == (191, "autoencoder"), (epoch, phase)
    ae_m = trainer.model["ae"]
    before = dict(_cuda.launch_counts)
    val = trainer._validate_ae(ae_m["params"], ae_m["state"])
    gfvs = trainer.generate_gfvs()
    counts = launched_since(before)
    assert abs(val / VAL_F32_JAX - 1) <= TOL_VAL, (
        f"val Chamfer {val} is not within {TOL_VAL:.0%} of {VAL_F32_JAX}")
    streams = {}
    for stream in (trainer_lib.JOINT_VAL_HOLES, trainer_lib.GATE_HOLES):
        with mock.patch.object(trainer_lib, "AE_VAL_HOLES", stream):
            streams[stream] = trainer._validate_ae(ae_m["params"],
                                                   ae_m["state"])
    with mock.patch.object(chamfer, "_nearest_forward", nearest_bf16_cross):
        bf16 = trainer._validate_ae(ae_m["params"], ae_m["state"])
    assert len({val, *streams.values()}) == 3, (
        f"two hole streams gave the same val Chamfer: {val}, {streams}")
    assert abs(bf16 / VAL_BF16_TPU - 1) <= TOL_VAL, (
        f"bf16 cross term: {bf16} is not within {TOL_VAL:.0%} of "
        f"{VAL_BF16_TPU}")

    committed = np.load(TRAINED_DIR / "gfv" / "gfvs_train.npz")["clean"]
    m = gfv_match(gfvs["clean"], committed, cuda)
    assert len(gfvs["clean"]) == len(committed) and m["one_to_one"], (
        "the clean GFVs do not match the committed ones one to one")
    assert (m["max"] <= TOL_GFV_MAX and m["p999"] <= TOL_GFV_P999
            and m["median"] <= TOL_GFV_MEDIAN), (
        f"the clean GFVs are too far from the committed ones: {m}")
    del trainer, gfvs
    shutil.rmtree(data)

    demo = subprocess.run(
        [sys.executable, "-m", "gan_rl_3d_tpu_torch.test_rl_gan_net"],
        cwd=REPO, capture_output=True, text=True)
    assert (demo.returncode == 0
            and "All integration checks passed" in demo.stdout), (
        f"test_rl_gan_net failed on the card:\n{demo.stderr}")
    assert_launched(counts, DATA_KERNELS, "data")


# ---------------------------------------------------------------------------
# the attention-encoder / adaptive-decoder family
# ---------------------------------------------------------------------------


def variant_run_config(cfg, tmp: Path):
    """The recipe with runs/variant/config_variant.yaml's model block (the
    attention encoder, the adaptive decoder; the flagship's widths) and
    the joint path's cuts: 1 AE epoch (2 steps at B=64), 1 LGAN epoch,
    VARIANT_RL_ITERS RL iterations, the joint block as JOINT_EPOCHS /
    JOINT_REFRESH; its checkpoints, metrics and report under ``tmp``."""
    t = cfg.training
    return dataclasses.replace(
        variant_config(cfg),
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


def is_kernel(name: str, key: str) -> bool:
    """Whether a traced kernel's name is the port's function ``key``
    (e.g. "nn_kernel" for K3; demangled, in any namespace, or mangled),
    never one of PyTorch's at::native kernels."""
    if "at::native" in name:
        return False
    return (key in re.findall(r"[A-Za-z_]\w*", name)
            or f"{len(key)}{key}" in name)


def profile_names_k3(folder: Path) -> bool:
    """Whether the one Chrome trace under ``folder`` holds a device
    kernel event of K3 (``nn_kernel``)."""
    (trace,) = folder.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    return any(e.get("cat") == "kernel"
               and is_kernel(e.get("name", ""), "nn_kernel")
               for e in events)


@pytest.mark.cuda
def test_variant_path(cuda, dataset_cfg, workdir):
    """The variant family at the flagship widths, random weights from seed
    0: the whole curriculum through ``train_rl_gan_net --phase full
    --profile`` at the recipe (bf16_selective) cut as the joint path is;
    its metrics.jsonl holds the AE/*, GAN/*, RL/*, Joint/* tags, its
    profile names K3's kernel, ``final`` and the gate sidecar are written;
    ``final`` served by ``complete_clouds --checkpoint`` and ``evaluate``;
    K3, K4, K5 and K2 launch; the engine fold and ``--export-pth`` refuse
    the family. Then one f32 variant ``ae_train_step`` and
    ``joint_checks`` on its ``final``, card against CPU; and the unfolded
    ``complete`` at B=64 and B=4096 finite and of its shape."""
    cfg = variant_run_config(dataset_cfg, workdir)
    ckpt, logs = Path(cfg.training.checkpoint_dir), Path(cfg.training.log_dir)
    cfg_path = write_config(cfg, workdir / "variant.json")
    before = dict(_cuda.launch_counts)
    train_rl_gan_net.main(["--config", str(cfg_path), "--phase", "full",
                           "--profile", "--device", cuda.type])
    records = [json.loads(line) for line in
               (logs / "metrics.jsonl").read_text().splitlines()]
    tags = sorted({r["tag"] for r in records})
    assert (all(any(tag.startswith(g) for tag in tags)
                for g in ("AE/", "GAN/", "RL/", "Joint/"))
            and all(np.isfinite(r["value"]) for r in records)), (
        f"variant metrics log: tags {tags}")
    assert profile_names_k3(logs / "profile"), (
        "the variant run's profile names no K3 kernel")
    for name in ("final", "joint_calibrated", gate_lib.GATE_FILE):
        assert (ckpt / name).is_file(), f"variant: {name} was not written"
    assert json.loads((ckpt / gate_lib.GATE_FILE).read_text())[
        "checkpoints"] == ["joint_calibrated", "final"], (
        "variant gate sidecar scope")
    inputs = write_scans(workdir / "scans_variant", seed=9)
    serve_files(inputs, workdir / "out_variant",
                ["--checkpoint", "final", "--config", str(cfg_path),
                 "--device", cuda.type], N_MAIN)
    evaluate_checked(["--config", str(cfg_path), "--checkpoint", "final",
                      "--num-export", "2", "--device", cuda.type])
    assert_launched(launched_since(before), VARIANT_KERNELS, "variant")

    trainer = RLGANNetTrainer(cfg, device=cuda)
    trainer.load_checkpoint("final")
    with pytest.raises(ValueError):
        inference.prepare_inference_engine(trainer.model)
    with pytest.raises(ValueError):
        evaluate.main(["--config", str(cfg_path), "--checkpoint", "final",
                       "--export-pth", str(workdir / "variant.pth"),
                       "--device", cuda.type])
    assert not (workdir / "variant.pth").exists(), "variant .pth written"
    variant_step_check(cuda, trainer)
    joint_checks(cuda, trainer)

    vcfg = variant_config(flagship_config())
    model = net.init_model(torch.Generator().manual_seed(0), vcfg, cuda)
    for bsz in (B_MAIN, B_VARIANT_BIG):
        pc, mask = make_clouds(bsz, N_MAIN, seed=19, device=cuda)
        out = net.complete(model, pc, mask, cfg=vcfg.td3_config())
        assert (out["hybrid_output"].shape == (bsz, N_MAIN, 3)
                and bool(torch.isfinite(out["hybrid_output"]).all())), (
            f"variant complete B={bsz}: non-finite or misshapen output")
        del pc, mask, out


# ---------------------------------------------------------------------------
# the multi path: the ("data", "model") mesh over torch.distributed
# ---------------------------------------------------------------------------


def multi_config(cfg, tmp: Path, name: str):
    """The recipe (the flagship family) cut as the variant path is: 1 AE
    epoch (2 steps at B=64), 1 LGAN epoch, VARIANT_RL_ITERS RL iterations,
    the joint block as JOINT_EPOCHS / JOINT_REFRESH; its checkpoints and
    logs under ``tmp/name``."""
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


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun_child(cfg_path: str, out_path: str) -> None:
    """Run under ``torch.distributed.run --nproc-per-node 1`` by
    ``test_multi_path``: joins the NCCL group torchrun describes and
    drives the whole curriculum through the training CLI's ``main`` in
    that group, counting its launches."""
    mesh_lib.init_distributed("nccl", "cuda")
    before = dict(_cuda.launch_counts)
    train_rl_gan_net.main(["--config", cfg_path, "--phase", "full"])
    counts = launched_since(before)
    world, backend = dist.get_world_size(), dist.get_backend()
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps({
        "counts": counts, "world": world, "backend": backend}))


def final_leaves(ckpt: Path) -> list:
    model, _ = ckpt_lib.load_model_checkpoint(str(ckpt), "final")
    return [np.asarray(x) for x in tree_leaves(model)]


def multi_torchrun(device, cfg, tmp: Path) -> dict:
    """(a) NCCL at world size 1 through the distributed code: ``python -m
    torch.distributed.run --nproc-per-node 1`` drives the training CLI
    over the whole curriculum (``torchrun_child``); its ``final`` against
    a plain one-process run's from the same seed, bit for bit. Returns the
    child's launch counts."""
    run_cfg = multi_config(cfg, tmp, "multi_torchrun")
    plain_cfg = multi_config(cfg, tmp, "multi_plain")
    out = tmp / "multi_torchrun_out.json"
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "1", "--master-addr", "localhost",
           "--master-port", str(free_port()), str(Path(__file__).resolve()),
           "--torchrun-child",
           str(write_config(run_cfg, tmp / "multi_torchrun.json")), str(out)]
    # the child runs this file as a script: the repo's root on its path
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, (str(REPO), os.environ.get("PYTHONPATH"))))}
    subprocess.run(cmd, check=True, timeout=900, cwd=str(REPO), env=env)
    child = json.loads(out.read_text())
    assert child["world"] == 1 and child["backend"] == "nccl", (
        f"torchrun child's group: {child['world']} {child['backend']}")
    train_rl_gan_net.main(["--config", str(write_config(
        plain_cfg, tmp / "multi_plain.json")), "--phase", "full"])
    a = final_leaves(Path(run_cfg.training.checkpoint_dir))
    b = final_leaves(Path(plain_cfg.training.checkpoint_dir))
    differ = [i for i, (x, y) in enumerate(zip(a, b))
              if x.shape != y.shape or not np.array_equal(x, y)]
    assert len(a) == len(b) and not differ, (
        f"torchrun's final differs from the plain run's in leaves "
        f"{differ[:10]}")
    return child["counts"]


def multi_rank(rank: int, world: int, backend: str, store: str,
               inputs_path: str, out_dir: str, shapes: list) -> None:
    """One rank of ``test_multi_path``'s gloo (or NCCL) runs: every job of
    ``multi_jobs`` on each mesh shape, its results and launch counts to
    ``out_dir/<shape>.<rank>.pt``. gloo ranks share card 0; NCCL rank r
    runs on card r."""
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        for shape in shapes:
            mesh = mesh_lib.make_mesh(*shape, device=device)
            before = dict(_cuda.launch_counts)
            res = multi_jobs(inputs, mesh, device, tp=shape[1] > 1)
            res["launches"] = launched_since(before)
            torch.save(res, Path(out_dir) / f"{shape[0]}x{shape[1]}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def to_cpu(tree):
    return tree_map(lambda v: v.detach().cpu().clone(), tree)


def load_adam(opt, params: list, sd: dict, mesh) -> None:
    """``sd`` (a one-process Adam state) into ``opt``, this rank's columns
    of a column-sharded leaf's moments."""
    opt.load_state_dict(copy.deepcopy(sd))
    for p in params:
        if mesh_lib.is_model_sharded(p):
            st = opt.state[p]
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = mesh_lib.column_block(mesh, st[k]).contiguous()


def scale_lr(opt, scale: float) -> None:
    for g in opt.param_groups:
        g["lr"] = g["lr"] * scale


def multi_ae(inputs, start, i, mesh, dev, bn_stats, lr_scale=1.0):
    """AE step ``i`` of the inputs from ``start`` (params, state, Adam
    state) under ``mesh``: (loss, network, Adam state)."""
    cfg = inputs["cfg"]
    params = on_device(start["params"], dev, grad=True)
    state = on_device(start["state"], dev)
    opt, _ = steps.make_ae_optimizer(params, cfg.training.autoencoder, 10)
    load_adam(opt, tree_leaves(params), start["opt"], mesh)
    scale_lr(opt, lr_scale)
    batch = mesh_lib.shard_batch(mesh, on_device(inputs["ae_batches"][i], dev))
    state, m = steps.ae_train_step(
        params, state, opt, batch, on_device(inputs["ae_draws"][i], dev),
        spec=cfg.preproc_spec(), bn_stats=bn_stats, mesh=mesh)
    return float(m["loss"]), {"params": to_cpu(params),
                              "state": to_cpu(state),
                              "opt": opt.state_dict()}


def multi_jobs(inputs, mesh, dev, tp: bool) -> dict:
    """The multi path's steps at the flagship widths from the inputs'
    weights and draws, under ``mesh`` (None: the one-process reference):
    the AE steps in both BN modes (each from the one-process state before
    it), a combined LGAN step, an rl_step of B_MAIN environments, a joint
    step (column-sharded on a mesh with a model axis) and DP serving."""
    cfg = inputs["cfg"]
    out = {}
    if tp:
        out["joint"] = multi_joint(inputs, mesh, dev)
        return out
    for mode in ("centered", "single_read_grouped"):
        out[f"ae_{mode}"] = [
            multi_ae(inputs, start, i, mesh, dev, mode)[:2]
            for i, start in enumerate(inputs[f"ae_starts_{mode}"])]
    real = inputs["lgan_real"]
    if mesh is not None:
        real = mesh_lib.local_rows(mesh, real, axis=1)
    sm, nets = lgan_step_on(dev, inputs["lgan_warm"], cfg, real,
                            inputs["lgan_draws"], mesh=mesh)
    out["lgan"] = ({k: float(v) for k, v in sm.items()}, to_cpu(nets))
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
    cfg = inputs["cfg"]
    td3 = multi_td3(cfg, lr_scale)
    rc = cfg.training.rl_agent
    model = {k: {"params": on_device(inputs["model"][k]["params"], dev),
                 "state": on_device(inputs["model"][k]["state"], dev)}
             for k in ("ae", "lgan")}
    model["agent"] = agent_from_numpy(inputs["agent"], td3, device=dev)
    bsz, prefill = len(inputs["rl_batch"]["pad"]), inputs["rl_prefill"]
    buf = rb.ReplayBuffer(cfg.model.rl_agent.buffer_size, td3.state_dim,
                          td3.action_dim, dev)
    buf.add_batch(random_transitions(prefill, td3, 52, dev))
    ou = rl.ou_init(td3, (bsz,), dev)
    model, buf, ou, m = steps.rl_step(
        model, buf, ou, mesh_lib.shard_batch(mesh, on_device(
            inputs["rl_batch"], dev)),
        on_device(inputs["rl_draws"], dev), cfg=td3, start_training_size=0,
        updates_per_step=rc.updates_per_step, spec=cfg.preproc_spec(),
        mesh=mesh, w_chamfer=cfg.loss.w_chamfer, w_gfv=cfg.loss.w_gfv,
        w_discriminator=cfg.loss.w_discriminator)
    return model, ({"reward": float(m["reward"])},
                   {k: to_cpu(model["agent"][k]) for k in
                    ("actor", "critic1", "critic2")},
                   {k: getattr(buf, k)[prefill:prefill + bsz].cpu()
                    for k in rb.FIELDS}, buf.size, ou.cpu())


def multi_joint(inputs, mesh, dev, lr_scale=1.0):
    """One f32 joint step of B_MAIN clouds from the warm joint model and
    Adam state, the model placed on ``mesh``: (metrics, networks)."""
    cfg = inputs["cfg"]
    jc = cfg.training.joint
    model, sd = inputs["joint_warm"]
    model = mesh_lib.shard_model_for_mesh(mesh, joint_model(model, dev))
    trainable = steps.joint_trainable(model, jc.freeze_generator)
    opt = steps.make_joint_optimizer(trainable, jc)
    load_adam(opt, tree_leaves(trainable), sd, mesh)
    scale_lr(opt, lr_scale)
    model, m = steps.joint_train_step(
        model, opt, mesh_lib.shard_batch(mesh, on_device(
            inputs["joint_batch"], dev)),
        on_device(inputs["joint_draws"], dev), mesh=mesh,
        **joint_kw(trainer_view(cfg)))
    nets = joint_networks(mesh_lib.gather_model(mesh, model))
    return {k: float(v) for k, v in m.items()}, to_cpu(nets)


def multi_inputs(cfg, device) -> dict:
    """Weights, warm Adam states, batches and draws of the multi path, on
    the CPU: one seed for every rank and the one-process reference. The AE
    trajectory is the reference's, on the card: each rank's step starts
    from the state before it."""
    cpu = torch.device("cpu")
    model = net.init_model(torch.Generator().manual_seed(0), cfg, cpu)
    td3 = multi_td3(cfg)
    spec = cfg.preproc_spec()
    gen = torch.Generator().manual_seed(90)
    pc, _ = make_clouds(B_MAIN, N_MAIN, seed=91, device=cpu)
    inputs = {"cfg": cfg,
              "model": {k: to_cpu(model[k]) for k in ("ae", "lgan")},
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
    tr = trainer_view(cfg, model=model)
    inputs["joint_warm"] = joint_warm(tr, 95)
    inputs["joint_batch"], inputs["joint_draws"] = joint_batch(tr, 97,
                                                               bsz=B_MAIN)
    # the AE's warm Adam: one step on the CPU, then the card's trajectory
    ae_params = on_device(model["ae"]["params"], cpu, grad=True)
    opt, _ = steps.make_ae_optimizer(ae_params, cfg.training.autoencoder, 10)
    state, _ = steps.ae_train_step(
        ae_params, to_cpu(model["ae"]["state"]), opt,
        {"complete_pc": pc, "pad": torch.zeros(B_MAIN)},
        pc_ops.draw_training_batch(gen, B_MAIN, N_MAIN, spec=spec),
        spec=spec)
    for mode in ("centered", "single_read_grouped"):
        start = {"params": to_cpu(ae_params), "state": to_cpu(state),
                 "opt": opt.state_dict()}
        starts = []
        for i in range(MULTI_AE_STEPS):
            starts.append(start)
            _, start = multi_ae(inputs, start, i, None, device, mode)
        inputs[f"ae_starts_{mode}"] = starts
    return inputs


def check_nets(what, got, ref, start, moved, tol, noise_tol, frozen=None):
    """Each network's update against the one process's (network_errs):
    within ``tol`` in the 2-norm and its state leaves within TOL_RL_PARAM
    of their largest element, or 4 x what the one-process run moves when
    its input clouds move by one part in 10^7 (``moved``), where that is
    more; the Adam-noise leaves within ``noise_tol``; a run at lr 0
    (``frozen``) must read over the update's bound."""
    for name in ref:
        floor, floor_state, _, _ = network_errs(moved[name], ref[name],
                                                start[name])
        bound = max(tol, 4 * floor)
        state_bound = max(TOL_RL_PARAM, 4 * floor_state)
        update, state, _, noise = network_errs(got[name], ref[name],
                                               start[name])
        assert (update <= bound and state <= state_bound
                and noise <= noise_tol), (
            f"{what} {name}: update {update:.3e} (tol {bound:.3e}), state "
            f"{state:.3e} (tol {state_bound:.3e}), noise {noise:.3e} "
            f"(tol {noise_tol:.3e})")
        if frozen is not None:
            wrong = network_errs(frozen[name], ref[name], start[name])[0]
            assert wrong > bound, (
                f"{what} {name}: lr 0 passed the check ({wrong})")


def close(what, got, ref, rtol):
    err = abs(got - ref) / max(abs(ref), 1e-30)
    assert err <= rtol, f"{what}: {got} against {ref} ({err:.2e} > {rtol:g})"


def np_tensors(tree):
    return tree_map(lambda v: torch.as_tensor(np.asarray(v)), tree)


def check_multi(res, ref, frozen, moved, inputs, what):
    """One rank's results of ``multi_jobs`` against the one-process
    reference on the card (``moved``: the reference with its input clouds
    moved by one part in 10^7, the steps' own conditioning)."""
    cfg = inputs["cfg"]
    if "ae_centered" in res:
        lr = cfg.training.autoencoder.lr
        for mode in ("centered", "single_read_grouped"):
            for i, ((loss, got), (rloss, rnet), start) in enumerate(zip(
                    res[f"ae_{mode}"], ref[f"ae_{mode}"],
                    inputs[f"ae_starts_{mode}"])):
                close(f"{what} AE {mode} step {i} loss", loss, rloss,
                      TOL_MULTI_LOSS)
                check_nets(f"{what} AE {mode} step {i}", {"ae": got},
                           {"ae": rnet}, {"ae": start},
                           {"ae": moved[f"ae_{mode}"][i][1]}, TOL_RL_UPDATE,
                           2 * lr, frozen["ae"] if mode == "centered"
                           and i == 0 else None)
        (lm, lnets), (rlm, rlnets) = res["lgan"], ref["lgan"]
        for k in rlm:
            close(f"{what} LGAN {k}", lm[k], rlm[k], TOL_MULTI_LOSS)
        lc = cfg.training.lgan
        warm = inputs["lgan_warm"][0]
        lstart = {k: {"params": warm["params"][k], "state": warm["state"][k]}
                  for k in ("generator", "discriminator")}
        check_nets(f"{what} LGAN", lnets, rlnets, lstart, moved["lgan"][1],
                   TOL_RL_UPDATE,
                   2 * max(lc.generator_lr, lc.discriminator_lr) * lc.d_steps,
                   frozen["lgan"])
        (rm, agent, ring, size, ou), (rrm, ragent, rring, rsize, rou) = (
            res["rl"], ref["rl"])
        close(f"{what} rl_step reward", rm["reward"], rrm["reward"],
              TOL_MULTI_LOSS)
        assert size == rsize, f"{what} ring size {size} against {rsize}"
        for k in ring:
            assert torch.allclose(ring[k], rring[k], rtol=1e-5, atol=1e-4), (
                f"{what} ring {k}: {(ring[k] - rring[k]).abs().max()}")
        assert torch.allclose(ou, rou, atol=1e-5), f"{what} OU state"
        td3 = multi_td3(cfg)
        astart = {k: {"params": inputs["agent"][k]["params"],
                      "state": inputs["agent"][k]["state"]}
                  for k in ("actor", "critic1", "critic2")}
        check_nets(f"{what} rl_step", agent, ragent, np_tensors(astart),
                   moved["rl"][1], TOL_RL_UPDATE,
                   2 * max(td3.actor_lr, td3.critic_lr)
                   * cfg.training.rl_agent.updates_per_step, frozen["rl"])
        err = scaled_err(res["serve"], ref["serve"])
        assert err <= TOL_MULTI_SERVE, (
            f"{what} DP serving: {err:.2e} > {TOL_MULTI_SERVE:g}")
    (jm, jnets), (rjm, rjnets) = res["joint"], ref["joint"]
    close(f"{what} joint loss", jm["loss"], rjm["loss"], TOL_MULTI_LOSS)
    wstart = joint_networks(inputs["joint_warm"][0])
    check_nets(f"{what} joint", jnets, rjnets, wstart, moved["joint"][1],
               TOL_JOINT_UPDATE, 2 * cfg.training.joint.lr, frozen["joint"])


def moved_inputs(inputs) -> dict:
    """The inputs with every cloud and real GFV scaled by 1 + 1e-7."""
    def up(x):
        return x * (1.0 + 1e-7)

    def batch(b):
        return {**b, "complete_pc": up(b["complete_pc"])}

    return {**inputs, "ae_batches": [batch(b) for b in inputs["ae_batches"]],
            "rl_batch": batch(inputs["rl_batch"]),
            "joint_batch": batch(inputs["joint_batch"]),
            "lgan_real": up(inputs["lgan_real"])}


@pytest.mark.cuda
def test_multi_path(cuda, dataset_cfg, tmp_path):
    """The multi path: (a) ``multi_torchrun``; (b) 2 and 4 ranks sharing
    the one card over gloo (host-staged collectives), each rank running
    ``multi_jobs`` from the same weights and draws, held against the
    one-process reference on the card (losses 1e-4 relative, each
    network's update 1e-2 of the one process's in the 2-norm, the joint
    step's 5e-2, Adam's noise leaves 2 lr an update, lr 0 failing, serving
    1e-5); at 4 ranks also a 2x2 (data, model) joint step with the decoder
    head column-sharded; (c) the same over NCCL on min(device count, 4)
    cards where more than one is visible. K1, K3, K4 and K5 launch on the
    path (every rank's and (a)'s launches)."""
    cfg = dataset_cfg
    counts = dict(multi_torchrun(cuda, cfg, tmp_path))
    inputs = multi_inputs(cfg, cuda)
    ref = multi_jobs(inputs, None, cuda, tp=False)
    moved = multi_jobs(moved_inputs(inputs), None, cuda, tp=False)
    frozen = {
        "ae": {"ae": multi_ae(inputs, inputs["ae_starts_centered"][0], 0,
                              None, cuda, "centered", lr_scale=0.0)[1]},
        "lgan": to_cpu(lgan_step_on(cuda, inputs["lgan_warm"], cfg,
                                    inputs["lgan_real"],
                                    inputs["lgan_draws"], lr_scale=0.0)[1]),
        "rl": multi_rl(inputs, None, cuda, lr_scale=0.0)[1][1],
        "joint": multi_joint(inputs, None, cuda, lr_scale=0.0)[1]}
    inputs_path = tmp_path / "multi_inputs.pt"
    torch.save(inputs, inputs_path)
    runs = [("gloo", world) for world in MULTI_WORLDS]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs.append(("nccl", min(n_cards, 4)))
    for backend, world in runs:
        shapes = [(world, 1)] + ([(2, 2)] if world == 4 else [])
        out_dir = tmp_path / f"multi_{backend}{world}"
        out_dir.mkdir()
        mp.spawn(multi_rank, args=(world, backend, str(out_dir / "store"),
                                   str(inputs_path), str(out_dir), shapes),
                 nprocs=world, join=True)
        for shape in shapes:
            tag = f"{shape[0]}x{shape[1]}"
            for rank in range(world):
                res = torch.load(out_dir / f"{tag}.{rank}.pt",
                                 weights_only=False)
                check_multi(res, ref, frozen, moved, inputs,
                            f"{backend} {tag} rank {rank}")
                for k, v in res["launches"].items():
                    counts[k] = counts.get(k, 0) + v
    assert_launched(counts, MULTI_KERNELS, "multi")


# ---------------------------------------------------------------------------
# the training BatchNorm + ReLU op (ops/bn_train.py, csrc/bn_train.cu)
# ---------------------------------------------------------------------------


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


def bn_leaves(inp):
    """z, b, scale and bias as copies that take a gradient."""
    return [inp[k].detach().clone().requires_grad_(True)
            for k in ("z", "b", "scale", "bias")]


def bn_composite(inp, dy=None):
    """The composite dense -> batchnorm_train (single_read_grouped) ->
    relu on z given: (y, state, gradients of z, b, scale, bias, y before
    the ReLU); no gradients without ``dy``."""
    z, b, scale, bias = bn_leaves(inp)
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
    z, b, scale, bias = bn_leaves(inp)
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for s, _ in BN_CELL_LAYERS])
def test_bn_op_at_the_cell_shapes(cuda, shape):
    """The training BatchNorm + ReLU op at an activation shape of the
    attn-adaptive-train-ae cell's step (B=2048): against the composite it
    replaces, y and the state bit for bit and the gradients within TOL_BN;
    a second run gives the same bits."""
    inp = bn_inputs(shape, seed=40, device=cuda)
    pre = bn_composite(inp)[3]
    dy = torch.where(pre.abs() > BN_BAND * pre.abs().max(), inp["dy"],
                     torch.zeros((), device=cuda))
    del pre
    ref = bn_composite(inp, dy)
    out = bn_op(inp, dy)
    errs = bn_errors(out, ref)
    del ref
    assert max(errs.values()) <= TOL_BN, (
        f"bn_train {shape}: the op disagrees with the composite: {errs}")
    again = bn_op(inp, dy)
    assert all(torch.equal(a, b) for a, b in zip(
        (out[0], *out[1].values(), *out[2]),
        (again[0], *again[1].values(), *again[2]))), (
        f"bn_train {shape}: two runs differ")


@pytest.mark.cuda
def test_steps_through_the_bn_op(cuda):
    """The card-vs-CPU step checks that run through the op, on fresh
    weights: ``step_check`` (a flagship f32 AE step),
    ``variant_step_check`` (seed 1) and ``joint_step_check`` (seed 11,
    tests/test_torch_port_cuda.py's joint step; on seed 2's fresh weights
    the generator's update reads 6.5e-2 with the op and without it alike:
    the joint step's conditioning), lr 0 and twice the lr failing the last
    two."""
    cfg = flagship_config()
    step_check(cuda, net.init_model(torch.Generator().manual_seed(0), cfg,
                                    torch.device("cpu"))["ae"])
    for fcfg, seed, check in ((variant_config(cfg), 1, variant_step_check),
                              (cfg, 11, joint_step_check)):
        check(cuda, trainer_view(fcfg, model=net.init_model(
            torch.Generator().manual_seed(seed), fcfg, cuda)))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-child"]:
        torchrun_child(*sys.argv[2:4])
