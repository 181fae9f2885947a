"""The PCN cell on the CPU: its counts of work against hand arithmetic, its
readers with nothing to read, its weights and draws against the
program's, a run at the cell's small sizes that the check passes, and a
staircase that decays smoothly, which the learning-rate check fails."""

import contextlib
import json
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from perfbench import harness, weights, work, work_pcn
from perfbench.modes import train_pcn_epochs
from perfbench.reference import pcn as ref_pcn

from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
PCN = json.loads((CONFIGS / "pcn-cd.json").read_text())["model"][
    "autoencoder"]
CELL = "pcn-train-16k"


def test_folding_counts_266240_macs_a_fine_point():
    per_fine, per_cloud = work_pcn.decoder_macs(PCN)
    assert per_fine == 5 * 512 + 512 * 512 + 512 * 3 == 266_240
    assert per_cloud == 1024 * 1024 * 2 + 1024 * 3072 + 1024 * 512
    # the published concatenation: 790,528 a fine point
    assert per_fine + 1024 * 512 == 790_528


def test_encoder_counts_688512_macs_a_kept_point():
    per_point, per_cloud = work_pcn.encoder_macs(PCN)
    assert per_point == 3 * 128 + 128 * 256 + 256 * 512 + 512 * 1024 \
        == 688_512
    assert per_cloud == 256 * 512


def test_training_flops_and_k3_launches_a_step():
    kept, clouds = 170_000, 128
    forward = 2 * (688_512 * kept + (131_072 + 5_767_168) * clouds
                   + 266_240 * 16_384 * clouds)
    assert work_pcn.forward_flops(PCN, kept, clouds) == forward
    assert work_pcn.train_flops(PCN, kept, clouds) == 3 * forward
    launches = work_pcn.k3_launches(PCN, 128, 16_384)
    assert launches == [work.k3(128, 1024, 16384), work.k3(128, 16384, 1024),
                        work.k3(128, 16384, 16384), work.k3(128, 16384, 16384)]
    pairs = sum(f for f, _ in launches) // 8 // 128
    assert pairs == 2 * 1024 * 16384 + 2 * 16384 ** 2


class _NoCard:
    device, host = [], []

    @staticmethod
    def kernel_seconds(pattern):
        return 0, 0.0


@pytest.mark.parametrize("name", ["folding_ms.per_step", "mfu.pcn_train",
                                  "k3_roofline.pcn"])
def test_the_new_readers_give_nothing_without_a_card(name):
    cell = harness.Cell(CELL, 1)
    ctx = {"trace": _NoCard(), "cell": cell, "steps": 4, "clouds": 512,
           "points": 2048, "timed_kept_points": [1] * 4,
           "kept_points": [1] * 4}
    assert harness.reader(name).read(ctx) is None


def test_k3_roofline_reads_only_four_launches_a_step():
    cell = harness.Cell(CELL, 1)
    trace = SimpleNamespace(device=[(0.0, 1.0, "x")],
                            kernel_seconds=lambda p: (7, 1.0))
    ctx = {"trace": trace, "cell": cell, "steps": 2, "clouds": 256}
    assert harness.reader("k3_roofline.pcn").read(ctx) is None
    trace.kernel_seconds = lambda p: (8, 1.0)
    bound = sum(work.bound_seconds(*k)
                for k in work_pcn.k3_launches(PCN, 128, 16384))
    assert harness.reader("k3_roofline.pcn").read(ctx) == pytest.approx(
        100.0 * 2 * bound)


def test_weights_are_the_programs_tree_glorot_with_zero_biases():
    small = dict(PCN, num_coarse=16)
    tree = weights.build(train_pcn_epochs.pcn_spec(small),
                         torch.Generator().manual_seed(1))["ae"]["params"]
    prog, _ = ae.autoencoder_init(
        torch.Generator().manual_seed(2), 3, 1024, 256, PCN["encoder_dims"],
        [1024, 1024, 48], "pcn", "folding", num_coarse=16)
    shapes = lambda t: weights.tree_map(lambda v: tuple(v.shape), t)  # noqa
    assert shapes(tree) == shapes(prog)
    w = tree["decoder"]["folding"][0]["w"]
    assert float(w.abs().max()) <= (6 / (1029 + 512)) ** 0.5
    assert not tree["decoder"]["folding"][0]["b"].any()


def test_the_reference_replays_the_programs_draws_and_input():
    gt = torch.rand(3, 256, 3, generator=torch.Generator().manual_seed(3))
    spec = pc_ops.PreprocSpec(rotation=False, jitter=False, scale=False,
                              normalize=False)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(4), 3,
                                       256, spec=spec, input_points=64)
    d = ref_pcn.draw_step(torch.Generator().manual_seed(4), 3, 256, 64, 0.2,
                          0.5)
    for k, r in (("subsample", "subsample"), ("ratio", "ratio"),
                 ("method", "method"), ("rand_scores", "scores"),
                 ("center", "center"), ("normal", "normal")):
        assert torch.equal(draws[k], d[r]), k
    _, pc, mask = pc_ops.apply_training_batch(gt, draws, spec=spec)
    ref_pc, ref_mask = ref_pcn.prepare(gt, d)
    assert torch.equal(pc, ref_pc) and torch.equal(mask, ref_mask)


def test_a_small_run_passes_its_check():
    cell = harness.Cell(CELL, 2**31 + 21)
    cell.traffic.update(cell.spec["small"])
    result = harness.run(cell, 0.05, False, torch.device("cpu"), time.time())
    assert result["correct"], result["checks"]
    assert result["metrics"]["ae_train_throughput"]["value"] > 0


def test_a_smooth_staircase_fails_the_learning_rate_check():
    """PCN's rate falls in whole steps of 50,000 updates, so a window of a
    few hundred updates never reaches the first; a schedule that decays
    smoothly, gamma ** (count / decay_steps), moves it from the first
    update, by about 7e-6 an update, and lr_gap reads it."""
    from gan_rl_3d_tpu_torch.train import steps

    make = steps.make_ae_optimizer

    def smooth(params, cfg, steps_per_epoch):
        opt, sched = make(params, cfg, steps_per_epoch)
        sched.lr_lambdas[0] = lambda c: cfg.scheduler_gamma ** (
            c / cfg.decay_steps)
        return opt, sched

    readings = {}
    for name, patch in (("sound", contextlib.nullcontext()),
                        ("smooth", mock.patch.object(
                            steps, "make_ae_optimizer", smooth))):
        cell = harness.Cell(CELL, 2**31 + 23)
        cell.traffic.update(cell.spec["small"])
        mode = cell.mode()
        with patch:
            run = mode.Run(cell, torch.device("cpu"))
            run.window(0.05)
        readings[name] = mode.numbers(run.answers(),
                                      run.reference(tf32=False))
    limit = cell.limits["lr_gap"]["limit"]
    assert readings["sound"]["lr_gap"] == 0.0
    assert readings["smooth"]["lr_gap"] > 3 * limit
    assert harness.judge(readings["sound"], cell.limits)[0]
    assert not harness.judge(readings["smooth"], cell.limits)[0]
