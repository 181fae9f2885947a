"""The port's trainer and training CLI under torch.distributed: the
curriculum of tests/test_torch_port_joint.py's tiny config on two gloo
ranks, started as torchrun starts them (tests/torch_port_dist_worker.py
sets RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR / MASTER_PORT and calls
the CLI's main), against the same CLI in one process."""

import json

import numpy as np
import pytest

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.train import RLGANNetTrainer as JaxTrainer
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.train import gate as tgate
from gan_rl_3d_tpu_torch.train_rl_gan_net import main as train_main
from gan_rl_3d_tpu_torch.utils import checkpoint as tckpt
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves
from test_torch_port_joint import tiny_config
from test_torch_port_modules import N_POINTS

import torch_port_dist_worker as worker

NAMES = ("autoencoder_best", "lgan_best", "lgan_final", "rl_agent_best",
         "rl_agent_final", "joint_best", "joint_calibrated", "final")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``--phase full`` in one process and on two gloo ranks, from the
    same config and seed."""
    data = tmp_path_factory.mktemp("dist_cli_data")
    tdataset.setup_dataset(str(data), synthetic=True, samples_per_category=2,
                           num_points=N_POINTS)
    out = {}
    for name, world in (("single", 1), ("dist", 2)):
        root = tmp_path_factory.mktemp(f"dist_cli_{name}")
        path = tiny_config(root, data, refresh_d_steps=3,
                           calibrate_gate=True)
        argv = ["--config", str(path), "--device", "cpu"]
        if world == 1:
            assert train_main(argv) is None
        else:
            worker.spawn_cli(world, [*argv, "--dist-backend", "gloo"])
        out[name] = (root, path)
    return out


def _files(root):
    return sorted(p.relative_to(root).as_posix()
                  for p in (root / "ckpt").rglob("*") if p.is_file())


def test_cli_on_two_ranks_writes_one_set_of_checkpoints(runs):
    """Rank 0 alone writes: the same files as one process, one metrics
    log with one line per (tag, step), one gate sidecar."""
    (single, _), (dist, _) = runs["single"], runs["dist"]
    assert _files(dist) == _files(single)
    for name in NAMES:
        assert (dist / "ckpt" / name).is_file(), name

    def tags(root):
        lines = (root / "logs" / "metrics.jsonl").read_text().splitlines()
        return [(r["tag"], r["step"]) for r in map(json.loads, lines)]

    assert tags(dist) == tags(single)
    report = json.loads((dist / "ckpt" / tgate.GATE_FILE).read_text())
    assert report["checkpoints"] == ["joint_calibrated", "final"]
    assert report["n_samples"] == json.loads(
        (single / "ckpt" / tgate.GATE_FILE).read_text())["n_samples"]


def _metrics(root):
    lines = (root / "logs" / "metrics.jsonl").read_text().splitlines()
    return [(r["tag"], r["value"]) for r in map(json.loads, lines)]


# the agent's TD3 losses and the D refresh run Adam through many updates on
# data that differ by rounding (the Chamfer reward's neighbour picks): 2e-2
LOOSE_TAGS = ("RL/Critic_Loss", "RL/Actor_Loss", "GAN/Refresh_D_Loss")


def test_cli_on_two_ranks_matches_one_process(runs):
    """The two-rank curriculum against the one-process one. The first
    checkpoint (phase 1, two AE steps from a fresh Adam) within the step
    tests' bound: the update within 1e-2 of the one-process update in the
    2-norm, the Adam-noise leaves within 2 lr an update. Every logged
    scalar (AE, GAN, RL and joint losses, eval rewards) within 1e-3
    relative, the agent's TD3 losses and the D refresh loss within 2e-2.
    Every checkpoint has the one-process layout, meta and finite
    leaves."""
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer

    (single, path), (dist, _) = runs["single"], runs["dist"]
    init = RLGANNetTrainer(str(path), device="cpu")
    start = worker.as_numpy(init.model["ae"])
    init.close()
    a, _ = tckpt.load_model_checkpoint(str(dist / "ckpt"), NAMES[0])
    b, _ = tckpt.load_model_checkpoint(str(single / "ckpt"), NAMES[0])
    _, noise, state, norm = worker.update_errors(a["ae"], b["ae"], start)
    lr = init.config.training.autoencoder.lr
    assert norm <= 1e-2 and noise <= 2 * lr * 2 and state <= 1e-4, (
        norm, noise, state)
    for (tag, x), (_, y) in zip(_metrics(dist), _metrics(single)):
        tol = 2e-2 if tag in LOOSE_TAGS else 1e-3
        assert abs(x - y) <= tol * abs(y), (tag, x, y)
    for name in NAMES:
        a, meta_a = tckpt.load_model_checkpoint(str(dist / "ckpt"), name)
        b, meta_b = tckpt.load_model_checkpoint(str(single / "ckpt"), name)
        assert {k: int(v) for k, v in meta_a.items()} == \
            {k: int(v) for k, v in meta_b.items()}
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.dtype == y.dtype
            assert x.dtype.kind != "f" or np.isfinite(x).all()


def test_jax_loads_the_two_rank_final(runs):
    """The JAX package restores the two-rank run's ``final`` as it does a
    one-process port file."""
    _, path = runs["dist"]
    jtrainer = JaxTrainer(jcfg.load_config(str(path)), use_orbax=False)
    try:
        assert jtrainer.load_checkpoint("final")[1] == "joint"
    finally:
        jtrainer.close()

