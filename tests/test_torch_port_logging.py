"""The port's metrics log, profiling and training-CLI flags against the
JAX package's (gan_rl_3d_tpu/utils/metrics_logging.py, utils/profiling.py,
the root train_rl_gan_net.py): the trainer writes the JAX trainer's
(tag, step) sequence over the whole curriculum, on the variant family
too; ``load_config(overrides=)``; ``trace`` as tests/test_profiling.py
checks it; ``--profile``, ``--debug-nans`` and
an interrupt; the logger without TensorBoard or wandb. CPU, small
widths."""

import json
import logging
import sys

import numpy as np
import pytest
import torch

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.train import RLGANNetTrainer as JaxTrainer
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
from gan_rl_3d_tpu_torch.train_rl_gan_net import main as train_main
from gan_rl_3d_tpu_torch.utils import metrics_logging, profiling
from test_torch_port_modules import N_POINTS, SMALL
from test_torch_port_variants import VARIANT

TAG_GROUPS = ("AE/", "GAN/", "RL/", "Joint/")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    data = tmp_path_factory.mktemp("logging_data")
    tdataset.setup_dataset(str(data), synthetic=True, samples_per_category=2,
                           num_points=N_POINTS)
    return data


def tiny(root, data, variant=False):
    """The whole curriculum in a few steps, every AE step logged, the logs
    under ``root``; batches of 8 and 8 environments, which the JAX
    trainer's 8-device test mesh divides."""
    model = dict(SMALL["model"], rl_agent={**SMALL["model"]["rl_agent"],
                                          "buffer_size": 32, "batch_size": 8})
    if variant:
        model["autoencoder"] = {**model["autoencoder"], **VARIANT}
    return {"model": model,
            "training": {
                "precision": "float32", "batch_size": 8,
                "checkpoint_dir": str(root / "ckpt"),
                "log_dir": str(root / "logs"),
                "results_dir": str(root / "results"),
                "autoencoder": {"epochs": 2},
                "lgan": {"epochs": 2, "batch_size": 8, "d_steps": 2},
                "rl_agent": {"episodes": 24, "envs_per_step": 8,
                             "updates_per_step": 2,
                             "start_training_steps": 8, "actor_warmup": 1,
                             "actor_lr_ramp": 2},
                "joint": {"epochs": 2, "w_ae_recon": 1.0,
                          "refresh_d_steps": 3, "calibrate_gate": True}},
            "logging": {"use_tensorboard": False, "log_frequency": 1},
            "data": {"data_dir": str(data)}}


def write_config(root, data, **kw):
    root.mkdir(parents=True, exist_ok=True)
    path = root / "tiny.json"
    path.write_text(json.dumps(tiny(root, data, **kw)))
    return path


def read_log(root):
    return [json.loads(line)
            for line in (root / "logs" / "metrics.jsonl").read_text()
            .splitlines()]


@pytest.mark.parametrize("variant", [False, True], ids=["pointnet", "variant"])
def test_trainer_writes_the_jax_trainers_tags_and_steps(tmp_path, data_dir,
                                                        variant):
    """``--phase full --profile`` through the port's CLI and
    ``train_full_pipeline`` in the JAX trainer on the same config: the
    same (tag, step) sequence in the same order, AE/*, GAN/*, RL/* and
    Joint/* all present, every value finite, one line per record with a
    time; the profile is a Chrome trace under <log_dir>/profile."""
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    path = write_config(port_root, data_dir, variant=variant)
    assert train_main(["--config", str(path), "--device", "cpu",
                       "--profile"]) is None
    jt = JaxTrainer(jcfg.load_config(None, overrides=tiny(
        jax_root, data_dir, variant)), use_orbax=False)
    jt.train_full_pipeline(start_phase="autoencoder")
    jt.close()
    port, ref = read_log(port_root), read_log(jax_root)
    assert [(r["tag"], r["step"]) for r in port] == \
        [(r["tag"], r["step"]) for r in ref]
    tags = {r["tag"] for r in port}
    assert all(any(tag.startswith(g) for tag in tags) for g in TAG_GROUPS)
    assert "GAN/Refresh_D_Loss" in tags and "RL/Eval_Chamfer" in tags
    assert all(np.isfinite(r["value"]) and r["time"] > 0 for r in port)
    traces = list((port_root / "logs" / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_load_config_overrides_match_jax(tmp_path):
    """``load_config(None, overrides=)`` and ``load_config(path,
    overrides=)``: nested keys merge into the file's block, other values
    replace, as in the JAX package; the logger's keys are real fields."""
    overrides = {"model": {"autoencoder": {"latent_dim": 64, **VARIANT}},
                 "training": {"batch_size": 16,
                              "autoencoder": {"lr": "5e-4"}},
                 "logging": {"use_wandb": True, "project_name": "p"}}
    port = tcfg.load_config(None, overrides=overrides)
    ref = jcfg.load_config(None, overrides=overrides)
    a, r = port.model.autoencoder, ref.model.autoencoder
    assert (a.latent_dim, a.encoder_type, a.decoder_type) == (
        r.latent_dim, r.encoder_type, r.decoder_type) == (64, "attention",
                                                          "adaptive")
    assert port.training.autoencoder.lr == ref.training.autoencoder.lr == 5e-4
    assert port.training.batch_size == 16
    for k in ("use_tensorboard", "use_wandb", "project_name",
              "log_frequency", "save_model_frequency"):
        assert getattr(port.logging, k) == getattr(ref.logging, k), k
    base = {"model": {"autoencoder": {"num_points": 512,
                                      "decoder_dims": [64, 64, 1536]}},
            "training": {"seed": 7, "autoencoder": {"epochs": 3}}}
    (tmp_path / "base.json").write_text(json.dumps(base))
    merged = tcfg.load_config(str(tmp_path / "base.json"),
                              overrides=overrides)
    assert merged.model.autoencoder.num_points == 512
    assert merged.model.autoencoder.latent_dim == 64
    assert merged.training.seed == 7 and merged.training.batch_size == 16
    assert merged.training.autoencoder.epochs == 3
    assert merged.training.autoencoder.lr == 5e-4
    assert tcfg._deep_merge({"a": {"b": 1}, "c": 2},
                            {"a": {"d": 3}, "c": {"e": 4}}) == {
        "a": {"b": 1, "d": 3}, "c": {"e": 4}}


def test_trace_context(tmp_path):
    """tests/test_profiling.py::test_trace_context and
    test_trace_disabled on the port: a Chrome trace of what ran inside,
    and nothing written when disabled."""
    with profiling.trace(str(tmp_path / "prof")):
        (torch.ones(32) * 2).sum()
    (trace,) = list((tmp_path / "prof").glob("*.pt.trace.json"))
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert "aten::mul" in names
    with profiling.trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_debug_nans_fails_fast_on_a_non_finite_batch(tmp_path, data_dir,
                                                     monkeypatch):
    """``--debug-nans``: a cloud with a NaN makes the first AE step's loss
    NaN and the CLI raises FloatingPointError before the backward pass;
    anomaly mode is off again afterwards. Without the flag the same run
    goes on."""
    orig = tdataset.ShapeNetDataset.as_array

    def poisoned(self):
        a = np.array(orig(self))
        a[0, 0, 0] = np.nan
        return a

    monkeypatch.setattr(tdataset.ShapeNetDataset, "as_array", poisoned)
    path = write_config(tmp_path, data_dir)
    argv = ["--config", str(path), "--phase", "autoencoder", "--device",
            "cpu"]
    with pytest.raises(FloatingPointError, match="non-finite AE loss"):
        train_main([*argv, "--debug-nans"])
    assert not torch.is_anomaly_enabled()
    assert read_log(tmp_path) == []
    train_main(argv)
    assert not np.isfinite(read_log(tmp_path)[0]["value"])


def test_an_interrupt_still_closes_the_logger(tmp_path, data_dir,
                                              monkeypatch, capsys):
    """Ctrl-C inside a phase: the CLI prints "Training interrupted by
    user", returns None, and closes the metrics log, which holds what the
    finished phase wrote."""
    closed = []
    close = metrics_logging.MetricsLogger.close

    def recording_close(self):
        closed.append(self.log_dir)
        close(self)

    def interrupted(self, *a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(metrics_logging.MetricsLogger, "close",
                        recording_close)
    monkeypatch.setattr(RLGANNetTrainer, "train_latent_gan", interrupted)
    path = write_config(tmp_path, data_dir)
    assert train_main(["--config", str(path), "--device", "cpu"]) is None
    assert "Training interrupted by user" in capsys.readouterr().out
    assert closed == [tmp_path / "logs"]
    assert {r["tag"] for r in read_log(tmp_path)} == {
        "AE/Batch_Loss", "AE/Train_Loss", "AE/Val_Loss"}


def test_logger_without_tensorboard_or_wandb(tmp_path, monkeypatch, caplog):
    """``use_tensorboard`` / ``use_wandb`` where the package is missing:
    one warning each, and the JSONL file is written all the same."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    with caplog.at_level(logging.WARNING):
        logger = metrics_logging.MetricsLogger(
            str(tmp_path), use_tensorboard=True, use_wandb=True)
        logger.log_scalar("AE/Train_Loss", 0.5, 1)
        logger.log_dict("RL", {"Eval_Reward": -3.0}, 2)
        logger.close()
        logger.close()
    warned = [r.getMessage() for r in caplog.records]
    assert len(warned) == 2
    assert "tensorboard is not installed" in warned[0]
    assert "wandb is not installed" in warned[1]
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in lines] == [
        ("AE/Train_Loss", 0.5, 1), ("RL/Eval_Reward", -3.0, 2)]
    assert not list(tmp_path.glob("events.out.tfevents.*"))


def test_tensorboard_logging(tmp_path):
    """tests/test_profiling.py::test_tensorboard_logging on the port, where
    tensorboard is installed: tfevents beside the JSONL."""
    pytest.importorskip("tensorboard")
    logger = metrics_logging.MetricsLogger(str(tmp_path),
                                           use_tensorboard=True)
    logger.log_scalar("AE/Train_Loss", 0.5, 1)
    logger.close()
    assert list(tmp_path.glob("events.out.tfevents.*"))
    assert (tmp_path / "metrics.jsonl").read_text().count("AE/Train_Loss")
