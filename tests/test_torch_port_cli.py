"""The port's CLIs on the CPU: serving (gan_rl_3d_tpu_torch.complete_clouds
--engine) with its device and checkpoint refusals and the engine-file
guard; training (gan_rl_3d_tpu_torch.train_rl_gan_net --phase
autoencoder), whose checkpoint the JAX package reads back (the later
phases: tests/test_torch_port_rl.py, tests/test_torch_port_joint.py); and
the import hygiene of the port (no JAX anywhere in it)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gan_rl_3d_tpu.models import autoencoder as jae
from gan_rl_3d_tpu.models import inference as jinf
from gan_rl_3d_tpu.utils import checkpoint as jckpt
from gan_rl_3d_tpu_torch import complete_clouds as tcc
from gan_rl_3d_tpu_torch.convert import model_to_numpy, tree_from_numpy
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.data.dataset import load_ply
from gan_rl_3d_tpu_torch.models import autoencoder as tae
from gan_rl_3d_tpu_torch.models import inference as tinf
from gan_rl_3d_tpu_torch.utils.ply import save_ply
from test_torch_port_modules import N_POINTS, SMALL, close, small_model_tree, t

ROOT = Path(__file__).resolve().parent.parent
CENTRE = np.array([10.0, -2.0, 3.0])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX-written f32 engine and a YAML config of the same widths."""
    root = tmp_path_factory.mktemp("served")
    _, tree = small_model_tree(seed=5)
    engine = jinf.prepare_inference_engine(tree)
    jinf.save_engine(str(root / "engine.pkl"), engine)
    (root / "config.yaml").write_text(yaml.safe_dump(SMALL))
    return root


def _write_clouds(folder, specs):
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    paths = []
    for name, n in specs:
        pts = rng.randn(n, 3) * [1.0, 0.5, 0.3] + CENTRE
        path = folder / name
        if path.suffix == ".ply":
            save_ply(str(path), pts)
        else:
            np.savetxt(path, pts)
        paths.append(path)
    return paths


@pytest.mark.parametrize("gate_mode,factor", [("discriminator", 1),
                                              ("union", 2)])
def test_cli_completes_files_in_their_frame(served, tmp_path, gate_mode,
                                            factor):
    inputs = _write_clouds(tmp_path / "in", [("a.txt", 300), ("b.ply", 100),
                                             ("c.txt", 50)])
    out = tmp_path / "out"
    tcc.main([*map(str, inputs), "--engine", str(served / "engine.pkl"),
              "--config", str(served / "config.yaml"), "--output-dir",
              str(out), "--device", "cpu", "--batch-size", "2",
              "--gate-mode", gate_mode])
    for src in inputs:
        pts = load_ply(out / f"{src.stem}_completed.ply")
        assert pts.shape == (factor * N_POINTS, 3)
        assert np.isfinite(pts).all()
        assert np.abs(pts.mean(0) - CENTRE).max() < 1.0


def test_cli_matches_complete_fast(served, tmp_path):
    """What the CLI writes is complete_fast's output, mapped back to the
    input frame."""
    (src,) = _write_clouds(tmp_path / "in", [("a.txt", 400)])
    out = tmp_path / "out"
    tcc.main([str(src), "--engine", str(served / "engine.pkl"), "--config",
              str(served / "config.yaml"), "--output-dir", str(out),
              "--device", "cpu", "--output", "completed_pc"])
    pc, mask, (centroid, scale) = tcc._load_framed(
        str(src), N_POINTS, np.random.RandomState(0))
    engine = tinf.load_engine(str(served / "engine.pkl"), device="cpu")
    ref = tinf.complete_fast(engine, torch.from_numpy(pc[None]),
                             torch.from_numpy(mask[None]))["completed_pc"]
    np.testing.assert_allclose(load_ply(out / "a_completed.ply"),
                               ref[0].numpy() * scale + centroid, atol=2e-5)


def test_cli_watch_mode(served, tmp_path):
    watch = tmp_path / "incoming"
    _write_clouds(watch, [("s0.txt", 300), ("s1.ply", 200)])
    (watch / "notes.md").write_text("ignored: wrong suffix")
    out = tmp_path / "out"
    tcc.main(["--watch", str(watch), "--engine", str(served / "engine.pkl"),
              "--config", str(served / "config.yaml"), "--output-dir",
              str(out), "--device", "cpu", "--max-files", "2", "--settle",
              "0", "--poll-interval", "0.01"])
    assert sorted(p.name for p in out.iterdir()) == ["s0_completed.ply",
                                                     "s1_completed.ply"]


def test_cli_refuses_a_missing_gpu_and_checkpoints(served, tmp_path):
    (src,) = _write_clouds(tmp_path / "in", [("a.txt", 50)])
    args = [str(src), "--engine", str(served / "engine.pkl"), "--config",
            str(served / "config.yaml"), "--output-dir", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcc.main(args)
    with pytest.raises(SystemExit):
        tcc.main([str(src), "--checkpoint", "joint_best", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcc.main([str(src), "--device", "cpu"])


def test_bf16_jax_engine_is_refused(tmp_path):
    """A JAX engine file holding an ml_dtypes type other than bfloat16
    (here one float8 leaf in a bf16 engine) is refused; the bf16 engine
    itself loads (tests/test_torch_port_int8.py)."""
    import ml_dtypes

    _, tree = small_model_tree(seed=6)
    jeng = jax.tree.map(np.asarray, jinf.prepare_inference_engine(
        tree, dtype=jnp.bfloat16))
    w, b = jeng["decoder"][0]
    jeng["decoder"][0] = (w.astype(ml_dtypes.float8_e4m3fn), b)
    jinf.save_engine(str(tmp_path / "bf16.pkl"), jeng)
    with pytest.raises(ValueError, match="ml_dtypes.float8_e4m3fn arrays"):
        tinf.load_engine(str(tmp_path / "bf16.pkl"), device="cpu")


def test_engine_file_admits_numpy_arrays_only(tmp_path):
    import pickle

    with open(tmp_path / "evil.pkl", "wb") as f:
        pickle.dump({"encoder": print}, f)
    with pytest.raises(ValueError, match="numpy arrays only"):
        tinf.load_engine(str(tmp_path / "evil.pkl"), device="cpu")


def test_cli_trains_phase_one_and_jax_reads_the_checkpoint(tmp_path):
    data = tmp_path / "data"
    tdataset.setup_dataset(str(data), synthetic=True, samples_per_category=2,
                           num_points=N_POINTS)
    cfg = {**SMALL, "training": {
        "precision": "float32", "batch_size": 8,
        "checkpoint_dir": str(tmp_path / "ckpt"),
        "autoencoder": {"epochs": 2, "lr_schedule": "cosine"}},
        "data": {"data_dir": str(data)}}
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    res = subprocess.run(
        [sys.executable, "-m", "gan_rl_3d_tpu_torch.train_rl_gan_net",
         "--config", str(tmp_path / "tiny.yaml"), "--phase", "autoencoder",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert "AE epoch 2/2 train" in res.stdout and "val" in res.stdout
    tree = jckpt.load_checkpoint(str(tmp_path / "ckpt" / "autoencoder_best"),
                                 use_orbax=False)
    assert int(tree["meta"]["epoch"]) == 1
    assert int(tree["meta"]["phase_idx"]) == 0
    ae_tree = tree["model"]["ae"]
    pc = (np.random.RandomState(40).randn(3, N_POINTS, 3) * 0.5).astype(np.float32)
    mask = np.ones((3, N_POINTS), np.float32)
    mask[:, 200:] = 0.0
    (ref, _), _ = jae.autoencoder_apply(ae_tree["params"], ae_tree["state"],
                                        pc, mask)
    port_ae = tree_from_numpy(ae_tree, torch.device("cpu"))
    (out, _), _ = tae.autoencoder_apply(port_ae["params"], port_ae["state"],
                                        t(pc), t(mask))
    close(out, ref, 1e-5)
    # and back: the port's tree as numpy is the checkpoint's tree
    again = model_to_numpy({"ae": port_ae})["ae"]
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(ae_tree)):
        np.testing.assert_array_equal(a, b)


def test_port_imports_no_jax():
    """Import every module of the port and chip_smoke in a fresh process:
    none of jax, optax, ml_dtypes or the JAX package may be loaded."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(ROOT)!r})
        import gan_rl_3d_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            gan_rl_3d_tpu_torch.__path__, "gan_rl_3d_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [k for k in ("jax", "jaxlib", "optax", "ml_dtypes",
                           "gan_rl_3d_tpu") if k in sys.modules]
        assert not bad, bad
        print(len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
