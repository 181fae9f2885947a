"""Port parity for the serving side's checkpoint and evaluation entry
points, on the CPU: full-model pickles written by the JAX package (optax
states and a ``_ganpath`` sibling included) read by the port, the serving
model's inits, the PLY sample and report writers, the evaluation metrics
on JAX-drawn holes, and CPU runs of ``gan_rl_3d_tpu_torch.evaluate`` and
``complete_clouds --checkpoint`` at a tiny config."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu.models import inference as jinf
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu.ops import metrics as jmetrics
from gan_rl_3d_tpu.ops import pointcloud as jpc
from gan_rl_3d_tpu.utils import checkpoint as jckpt
from gan_rl_3d_tpu.utils import ply as jply
from gan_rl_3d_tpu.utils import torch_convert as jtc
from gan_rl_3d_tpu_torch import complete_clouds as tcc
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch import evaluate as tev
from gan_rl_3d_tpu_torch import nn as tnn
from gan_rl_3d_tpu_torch.convert import model_from_numpy
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.data.dataset import load_ply
from gan_rl_3d_tpu_torch.models import inference as tinf
from gan_rl_3d_tpu_torch.models import latent_gan as tlg
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
from gan_rl_3d_tpu_torch.utils import checkpoint as tckpt
from gan_rl_3d_tpu_torch.utils import ply as tply
from test_torch_port_modules import (GATE_MODES, N_POINTS, SMALL, close,
                                     port_small_config, small_clouds,
                                     small_config, small_model_tree, t)

METRICS = ("chamfer_distance", "completion_ratio", "hausdorff_distance",
           "f_score", "emd")
CENTRE = np.array([4.0, -1.0, 2.0])


def _write_jax_checkpoint(ckpt_dir, name, seed):
    """What the JAX trainer writes with use_orbax=False: the full model
    (agent critics, targets and optax states included) and the gan_path
    snapshot as a sibling. Returns the JAX tree with its snapshot."""
    _, tree = small_model_tree(seed=seed, gan_path=True)
    model = {k: v for k, v in tree.items() if k != "gan_path"}
    jckpt.save_checkpoint(str(ckpt_dir / name),
                          {"model": model, "meta": {"epoch": np.int32(7),
                                                    "phase_idx": np.int32(3)}},
                          use_orbax=False)
    jckpt.save_checkpoint(str(ckpt_dir / f"{name}_ganpath"), tree["gan_path"],
                          use_orbax=False)
    return tree


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny synthetic dataset, a JSON config of SMALL widths pointing at
    it, and a JAX-written full-model checkpoint ``jax_full``."""
    root = tmp_path_factory.mktemp("eval")
    tdataset.setup_dataset(str(root / "data"), synthetic=True,
                           samples_per_category=2, num_points=N_POINTS)
    cfg = {**SMALL,
           "training": {"batch_size": 8, "checkpoint_dir": str(root / "ckpt"),
                        "results_dir": str(root / "results")},
           "data": {"data_dir": str(root / "data")},
           "evaluation": {"metrics": list(METRICS)}}
    (root / "tiny.json").write_text(json.dumps(cfg))
    (root / "ckpt").mkdir()
    tree = _write_jax_checkpoint(root / "ckpt", "jax_full", seed=21)
    return root, tree


def test_jax_full_model_pickle_serves_in_the_port(run_dir):
    """The optax states unpickle into stand-ins; the port's complete on the
    restored model matches the JAX complete on every output key."""
    root, tree = run_dir
    model, meta = tckpt.load_model_checkpoint(str(root / "ckpt"), "jax_full")
    assert (int(meta["epoch"]), int(meta["phase_idx"])) == (7, 3)
    adam, empty = model["agent"]["opt"]["actor"]
    assert isinstance(adam, tckpt.ScaleByAdamState)
    assert isinstance(empty, tckpt.EmptyState)
    np.testing.assert_array_equal(
        adam.mu["mlp"][0]["dense"]["w"],
        np.asarray(tree["agent"]["opt"]["actor"][0].mu["mlp"][0]["dense"]["w"]))
    port = model_from_numpy(model, device="cpu")
    assert set(port) == {"ae", "lgan", "agent", "gan_path"}
    pc, mask = small_clouds(seed=22)
    for gate_mode in GATE_MODES:
        ref = jnet.complete(tree, pc, mask, cfg=small_config().td3_config(),
                            gate_mode=gate_mode, gate_bias=0.01)
        out = tnet.complete(port, t(pc), t(mask),
                            cfg=port_small_config().td3_config(),
                            gate_mode=gate_mode, gate_bias=0.01)
        assert set(out) == set(ref)
        for k in ref:
            close(out[k], ref[k], 1e-5, rtol=1e-5)


def test_checkpoint_reader_refuses_other_classes_and_orbax(tmp_path):
    with open(tmp_path / "evil", "wb") as f:
        pickle.dump({"model": {"x": print}}, f)
    with pytest.raises(ValueError, match="numpy arrays only"):
        tckpt.load_checkpoint(str(tmp_path / "evil"))
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="_METADATA"):
        tckpt.load_checkpoint(str(tmp_path / "orbax_dir"))
    with pytest.raises(FileNotFoundError):
        tckpt.load_model_checkpoint(str(tmp_path), "missing")


def test_trainer_restores_and_writes_the_serving_model(run_dir, tmp_path):
    """load_checkpoint restores ae, lgan, the agent and the snapshot;
    save_checkpoint writes them in the JAX layout, the snapshot as a
    sibling that the JAX package reads."""
    root, tree = run_dir
    cfg = tcfg.load_config(str(root / "tiny.json"))
    trainer = RLGANNetTrainer(cfg, device="cpu")
    fresh = trainer.model
    assert set(fresh) == {"ae", "lgan", "agent"}
    assert set(fresh["agent"]) == set(tree["agent"])
    assert (trainer.load_checkpoint("jax_full")) == (7, "joint")
    w = trainer.model["lgan"]["params"]["generator"]["mlp"][0]["dense"]["w"]
    np.testing.assert_array_equal(
        w.numpy(), tree["lgan"]["params"]["generator"]["mlp"][0]["dense"]["w"])
    assert trainer.model["ae"]["params"]["encoder"]["point_mlp"][0]["dense"][
        "w"].requires_grad
    trainer.checkpoint_dir = tmp_path
    trainer.save_checkpoint("again", 7, "joint")
    back = jckpt.load_checkpoint(str(tmp_path / "again"), use_orbax=False)
    snap = jckpt.load_checkpoint(str(tmp_path / "again_ganpath"),
                                 use_orbax=False)
    assert set(back["model"]) == {"ae", "lgan", "agent"}
    for mine, ref in ((back["model"]["ae"], tree["ae"]),
                      (back["model"]["agent"]["actor"],
                       tree["agent"]["actor"]),
                      (snap, tree["gan_path"])):
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
    # without a snapshot the stale sibling goes
    del trainer.model["gan_path"]
    trainer.save_checkpoint("again", 7, "joint")
    assert not (tmp_path / "again_ganpath").exists()


def test_serving_inits_have_the_jax_layout():
    """init_model's tree has the JAX init_model's serving subtrees, leaf for
    leaf in shape, with the JAX inits' laws: xavier-uniform actor weights
    and 0.01 biases, unit spectral-norm vectors, LayerNorm at 1 / 0."""
    pcfg = port_small_config()
    model = tnet.init_model(torch.Generator().manual_seed(0), pcfg)
    _, ref = small_model_tree(seed=0)
    for key in ("ae", "lgan"):
        assert (jax.tree.structure(jax.tree.map(lambda x: 0, model[key]))
                == jax.tree.structure(jax.tree.map(lambda x: 0, ref[key])))
        for a, b in zip(jax.tree.leaves(model[key]),
                        jax.tree.leaves(ref[key])):
            assert tuple(a.shape) == b.shape
    actor = model["agent"]["actor"]
    for a, b in zip(jax.tree.leaves(actor),
                    jax.tree.leaves(ref["agent"]["actor"])):
        assert tuple(a.shape) == b.shape
    for layer in actor["params"]["mlp"]:
        w = layer["dense"]["w"]
        assert float(w.abs().max()) <= (6.0 / sum(w.shape)) ** 0.5
        assert bool((layer["dense"]["b"] == 0.01).all())
    for p, s in zip(model["lgan"]["params"]["discriminator"]["layers"],
                    model["lgan"]["state"]["discriminator"]["layers"]):
        for v in s["sn"].values():
            assert abs(float(v.norm()) - 1.0) < 1e-5
        if "ln" in p:
            assert bool((p["ln"]["scale"] == 1).all())
    d_p, d_s = tlg.discriminator_init(torch.Generator().manual_seed(1), 8,
                                      (16, 1), spectral_norm=False)
    assert d_s == {"layers": [{}, {}]} and "ln" not in d_p["layers"][1]
    np.testing.assert_allclose(
        tnn.xavier_uniform(torch.Generator().manual_seed(2), (300, 100))
        .abs().max(), (6.0 / 400) ** 0.5, rtol=1e-2)


def test_ply_samples_and_report_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    inc, gt, rec = (rng.randn(40, 3).astype(np.float32) for _ in range(3))
    mask = (rng.rand(40) > 0.3).astype(np.float32)
    for mod, d in ((jply, "j"), (tply, "t")):
        mod.save_completion_sample(str(tmp_path / d), 2, "lamp", inc, gt, rec,
                                   incomplete_mask=mask)
        mod.write_results_html(str(tmp_path / d / "r.html"),
                               {"chamfer_distance": 0.0123456789},
                               ["sample_02_lamp"])
    for role in ("incomplete", "ground_truth", "reconstructed"):
        name = f"sample_02_lamp_{role}.ply"
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text())
    html = (tmp_path / "t" / "r.html").read_text()
    assert "<tr><td>chamfer_distance</td><td>0.0123457</td></tr>" in html
    assert "<li><code>sample_02_lamp</code></li>" in html


def test_evaluate_metrics_on_jax_holes_match_jax():
    """One evaluation batch on holes drawn by the JAX package: the port's
    batch_metrics against jnet.complete + evaluate_completion(reduce=False).
    Distances to 1e-5 (f32 sums in another order); the threshold counts
    (completion ratio, F-scores) exactly; the Sinkhorn EMD to 1e-4."""
    config, tree = small_model_tree(seed=23, gan_path=True)
    complete = small_clouds(seed=24, n_valid=N_POINTS)[0]
    c, inc, mask = jpc.make_training_batch(jax.random.PRNGKey(123),
                                           jnp.asarray(complete),
                                           do_augment=False)
    ref_out = jnet.complete(tree, inc, mask, cfg=config.td3_config())
    ev = config.evaluation
    ref = jmetrics.evaluate_completion(
        ref_out["hybrid_output"], c, METRICS,
        fscore_threshold=ev.fscore_threshold,
        fscore_thresholds=ev.fscore_thresholds,
        completion_threshold=ev.completion_threshold, reduce=False)
    pred, out = tev.batch_metrics(
        model_from_numpy(tree, device="cpu"), t(c), t(inc), t(mask),
        td3=port_small_config().td3_config(), gate_mode="discriminator",
        gate_bias=0.0, output="hybrid_output", metrics=METRICS,
        eval_cfg=tcfg.EvaluationConfig())
    close(pred, ref_out["hybrid_output"], 1e-5, rtol=1e-5)
    assert set(out) == set(ref)
    for k in ref:
        atol = 1e-4 if k == "emd" else 1e-5
        close(out[k], ref[k], atol)


def _write_clouds(folder, specs):
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    paths = []
    for name, n in specs:
        path = folder / name
        np.savetxt(path, rng.randn(n, 3) * [1.0, 0.5, 0.3] + CENTRE)
        paths.append(path)
    return paths


def test_evaluate_cli_on_cpu(run_dir, tmp_path):
    """The evaluation CLI on the JAX checkpoint: finite metrics, PLY
    samples, the report, an f32 engine the JAX package serves with the
    port's outputs, and a reference .pth pair the JAX package's loader
    reads back to the checkpoint's weights."""
    root, tree = run_dir
    engine_path = tmp_path / "engine.pkl"
    stats = tev.main(["--config", str(root / "tiny.json"), "--checkpoint",
                      "jax_full", "--device", "cpu", "--ablate-z",
                      "--num-export", "2", "--export-engine",
                      str(engine_path)])
    assert {"chamfer_distance", "emd", "f_score@0.02"} <= set(stats)
    assert all(np.isfinite(v) for v in stats.values())
    results = root / "results"
    assert "chamfer_distance" in (results / "results_viewer.html").read_text()
    assert len(list((results / "point_clouds").glob("sample_0*_*.ply"))) == 6
    pc, mask = small_clouds(seed=25)
    ref = jinf.complete_fast(jinf.load_engine(str(engine_path)),
                             jnp.asarray(pc), jnp.asarray(mask))
    out = tinf.complete_fast(tinf.load_engine(str(engine_path), device="cpu"),
                             t(pc), t(mask))
    for k in ref:
        close(out[k], ref[k], 1e-4, rtol=1e-4)
    # gate forced, metrics overridden
    forced = tev.main(["--config", str(root / "tiny.json"), "--checkpoint",
                       "jax_full", "--device", "cpu", "--gate-mode", "union",
                       "--metrics", "chamfer_distance"])
    assert set(forced) == {"chamfer_distance"}
    # the reference .pth pair, read back by the JAX package's loader
    pth = tmp_path / "model.pth"
    tev.main(["--config", str(root / "tiny.json"), "--checkpoint",
              "jax_full", "--device", "cpu", "--metrics", "chamfer_distance",
              "--export-pth", str(pth)])
    back = jtc.load_reference_checkpoint(str(pth))
    for got, want in ((back["ae"], tree["ae"]), (back["lgan"], tree["lgan"]),
                      (back["agent_networks"]["critic1_target"],
                       tree["agent"]["critic1_target"])):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                        strict=True):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_complete_clouds_serves_a_checkpoint_on_cpu(run_dir, tmp_path, capsys):
    """complete_clouds --checkpoint writes the unfolded complete's output in
    each input's frame; a gate sidecar scoped to another checkpoint is not
    applied. An int8 engine file serves through --engine."""
    root, tree = run_dir
    (root / "ckpt" / "gate_calibration.json").write_text(json.dumps(
        {"gate_mode": "ae", "gate_bias": 0.5, "checkpoints": ["other"]}))
    (src,) = _write_clouds(tmp_path / "in", [("a.txt", 300)])
    out = tmp_path / "out"
    tcc.main([str(src), "--checkpoint", "jax_full", "--config",
              str(root / "tiny.json"), "--output-dir", str(out), "--device",
              "cpu"])
    assert "scoped to ['other']" in capsys.readouterr().out
    pc, mask, (centroid, scale) = tcc._load_framed(
        str(src), N_POINTS, np.random.RandomState(0))
    model = model_from_numpy(tree, device="cpu")
    ref = tnet.complete(model, t(pc[None]), t(mask[None]),
                        cfg=port_small_config().td3_config())["hybrid_output"]
    np.testing.assert_allclose(load_ply(out / "a_completed.ply"),
                               ref[0].numpy() * scale + centroid, atol=2e-5)
    (root / "ckpt" / "gate_calibration.json").unlink()

    engine_q = tmp_path / "engine_q.pkl"
    tinf.save_engine(str(engine_q),
                     tinf.prepare_inference_engine(model, quantize_int8=True))
    tcc.main([str(src), "--engine", str(engine_q), "--config",
              str(root / "tiny.json"), "--output-dir", str(tmp_path / "q"),
              "--device", "cpu", "--gate-mode", "rl"])
    pts = load_ply(tmp_path / "q" / "a_completed.ply")
    assert pts.shape == (N_POINTS, 3) and np.isfinite(pts).all()
    assert np.abs(pts.mean(0) - CENTRE).max() < 1.0
    with pytest.raises(SystemExit):
        tcc.main([str(src), "--checkpoint", "jax_full", "--engine",
                  str(engine_q), "--device", "cpu"])
