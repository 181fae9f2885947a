"""The JAX trainer resumes the port: from each phase's periodic checkpoint
and pickle ``_trainstate`` written by the port, the JAX trainer
(use_orbax=False) restores the train state and runs only the epoch (RL:
the iteration) that is left, with finite losses. CPU, tiny config; phases
1 and 3 here, 4 and 5 in test_torch_port_resume_jax_late.py (each JAX
phase compiles its own programs)."""

import json

import numpy as np
import pytest

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.train import RLGANNetTrainer as JaxTrainer
from test_torch_port_resume import (  # noqa: F401 (fixtures)
    ENVS, PORT_NAMES, data_dir, port_run, tiny)

RUNS = {"autoencoder": ("train_autoencoder", 2, "AE/Train_Loss"),
        "lgan": ("train_latent_gan", 2, "GAN/Generator_Loss"),
        "rl_agent": ("train_rl_agent", 2 * ENVS, "RL/Episode_Reward"),
        "joint": ("joint_training", 2, "Joint/Train_Loss")}


def jax_resumes(port_run, data_dir, phase, capsys, tmp_path):
    root, _ = port_run
    cfg = tiny(root, data_dir)
    cfg["training"]["log_dir"] = str(tmp_path)  # this run's metrics alone
    jt = JaxTrainer(jcfg.load_config(None, overrides=cfg), use_orbax=False)
    capsys.readouterr()
    jt.load_checkpoint(PORT_NAMES[phase])
    method, length, tag = RUNS[phase]
    getattr(jt, method)(length)
    jt.close()
    out = capsys.readouterr().out
    assert f"restored {phase} train state" in out
    steps = [json.loads(line) for line in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    logged = [r for r in steps if r["tag"] == tag]
    # epoch (iteration) index 1 only; the RL reward is logged per
    # iteration at episodes (it + 1) * envs
    assert [r["step"] for r in logged] == (
        [2 * ENVS] if phase == "rl_agent" else [1])
    assert all(np.isfinite(r["value"]) for r in logged)


@pytest.mark.parametrize("phase", ["autoencoder", "lgan"])
def test_jax_trainer_resumes_a_port_trainstate_and_runs_what_is_left(
        port_run, data_dir, phase, capsys, tmp_path):
    jax_resumes(port_run, data_dir, phase, capsys, tmp_path)
