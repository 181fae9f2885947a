"""The port's data entry points against the JAX package's:
``create_dataloader``; ``PointCloudDataset`` / ``collate_fn``
(gan_rl_3d_tpu/data/simple_dataset.py), synthetic and ``.h5``; the
``setup_dataset`` CLI against the root ``setup_dataset.py`` (the files,
the ``--test`` lines, the instructions without ``--synthetic``); the
``test_rl_gan_net`` demo on the CPU against the shapes the JAX functions
the root script calls give, and its failure on perturbed weights; a loader
build that fails raises. CPU."""

import importlib.util
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.data import dataset as jdataset
from gan_rl_3d_tpu.data import simple_dataset as jsimple
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu_torch import runtime as truntime
from gan_rl_3d_tpu_torch import setup_dataset as tsetup
from gan_rl_3d_tpu_torch import test_rl_gan_net as tdemo
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.data import simple_dataset as tsimple
from gan_rl_3d_tpu_torch.utils import checkpoint as tckpt
from gan_rl_3d_tpu_torch.utils.tree import tree_map
from test_torch_port_data import cloud, write_tree


ROOT = Path(__file__).resolve().parent.parent
DEMO_OVERRIDES = {"model": {"rl_agent": {"buffer_size": 10000,
                                         "batch_size": 32}}}


def root_cli(name: str):
    """A root script as a module (its ``main`` reads ``sys.argv``)."""
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# create_dataloader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split,batch,shuffle,drop_last,kw", [
    ("train", 4, None, False, {}),
    ("test", 2, None, True, {"seed": 3}),
    ("val", 5, True, False, {"categories": ["lamp", "airplane"],
                              "workers": 2}),
])
def test_create_dataloader_matches_jax(tmp_path, split, batch, shuffle,
                                       drop_last, kw):
    tree = write_tree(tmp_path / "tree")
    ref = jdataset.create_dataloader(str(tree), split, batch, 128,
                                     shuffle=shuffle, drop_last=drop_last,
                                     **kw)
    port = tdataset.create_dataloader(str(tree), split, batch, 128,
                                      shuffle=shuffle, drop_last=drop_last,
                                      **kw)
    assert port.shuffle == ref.shuffle and len(port) == len(ref) > 0
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b) == ["complete_pc", "pad"]
            np.testing.assert_array_equal(a["complete_pc"], b["complete_pc"])
            np.testing.assert_array_equal(a["pad"], b["pad"])


# ---------------------------------------------------------------------------
# simple_dataset
# ---------------------------------------------------------------------------


def write_h5(folder: Path, split: str, clouds: np.ndarray) -> None:
    folder.mkdir(parents=True, exist_ok=True)
    with h5py.File(folder / f"{split}.h5", "w") as f:
        f["point_clouds"] = clouds


@pytest.mark.parametrize("source,split,n_rows", [
    ("synthetic", "train", 64), ("synthetic", "val", 64),
    ("h5", "train", 100), ("h5", "test", 64)])
def test_point_cloud_dataset_matches_jax(tmp_path, source, split, n_rows):
    """Sample for sample, in call order (the holes and any resampling
    draw from the dataset's RNG), and the collated batch."""
    if source == "h5":
        write_h5(tmp_path, split,
                 np.stack([cloud(i, n_rows) for i in range(5)]))
    kw = dict(split=split, num_points=64, missing_ratio=0.3, seed=4,
              n_synthetic=10)
    ref = jsimple.PointCloudDataset(str(tmp_path), **kw)
    port = tsimple.PointCloudDataset(str(tmp_path), **kw)
    assert len(port) == len(ref) > 0
    np.testing.assert_array_equal(port.data, ref.data)
    order = [0, len(ref) - 1, 0]
    got, want = [port[i] for i in order], [ref[i] for i in order]
    for a, b in zip(got, want):
        for k in ("complete", "incomplete", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
    batch, ref_batch = tsimple.collate_fn(got), jsimple.collate_fn(want)
    assert sorted(batch) == sorted(ref_batch)
    for k in batch:
        assert batch[k].shape == (len(order), 64, 3)[:batch[k].ndim]
        np.testing.assert_array_equal(batch[k], ref_batch[k])


# ---------------------------------------------------------------------------
# the setup_dataset CLI
# ---------------------------------------------------------------------------


def files_of(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*.txt"))}


def test_setup_dataset_cli_writes_the_root_clis_files(tmp_path, capsys,
                                                      monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", [
        "setup_dataset.py", "--data-dir", str(jdir), "--synthetic",
        "--samples-per-category", "2", "--test"])
    assert root_cli("setup_dataset").main() == 0
    want = capsys.readouterr().out.replace(str(jdir), "DIR")
    assert tsetup.main(["--data-dir", str(tdir), "--synthetic",
                        "--samples-per-category", "2", "--test"]) == 0
    got = capsys.readouterr().out.replace(str(tdir), "DIR")
    assert got == want
    assert "Complete point cloud shape: (4, 2048, 3)" in got
    assert "Train dataset size: 16" in got and "Data loading test passed" \
        in got
    ref, port = files_of(jdir), files_of(tdir)
    assert len(port) == 32 and port == ref  # 16 train, 8 val, 8 test


def test_setup_dataset_cli_without_synthetic_prints_the_instructions(
        tmp_path, capsys):
    data = tmp_path / "shapenet"
    jdataset.setup_dataset(str(data))
    instructions = capsys.readouterr().out
    assert tsetup.main(["--data-dir", str(data)]) == 0
    out = capsys.readouterr().out
    assert instructions in out and "latent_3d_points" in instructions
    assert out.splitlines()[-1] == f"Dataset location: {data.absolute()}"
    assert not data.exists()


# ---------------------------------------------------------------------------
# the test_rl_gan_net demo
# ---------------------------------------------------------------------------


def jax_demo_lines() -> list:
    """The root demo's shape lines, from the JAX functions it calls, by
    shape inference."""
    config = jcfg.load_config(None, overrides=DEMO_OVERRIDES)
    td3 = config.td3_config()
    key = jax.random.PRNGKey(0)
    model = jax.eval_shape(lambda k: jnet.init_model(k, config), key)
    pc = jax.ShapeDtypeStruct((4, config.model.autoencoder.num_points, 3),
                              jnp.float32)

    def run(fn):
        return jax.eval_shape(fn, model, pc)

    ae = run(lambda m, x: jnet.forward(m, x, phase="autoencoder",
                                       mode="training"))
    lg = run(lambda m, x: jnet.forward(m, x, phase="lgan", mode="training",
                                       key=key))
    rl = run(lambda m, x: jnet.forward(m, x, phase="rl_agent",
                                       mode="training", cfg=td3))
    inf = run(lambda m, x: jnet.complete(m, x, cfg=td3))
    return [f"input shape: {pc.shape}",
            f"[autoencoder] noisy GFV {ae['noisy_gfv'].shape}, "
            f"reconstruction {ae['ae_reconstruction'].shape}",
            f"[lgan] clean GFV {lg['clean_gfv'].shape}, "
            f"completed {lg['completed_pc'].shape}",
            f"[rl_agent] z {rl['z_vector'].shape}, "
            f"completed {rl['completed_pc'].shape}",
            f"[inference] hybrid output {inf['hybrid_output'].shape}, "
            f"scores {inf['rl_gan_score'].shape}",
            "[checkpoint] save -> load round trip OK",
            "All integration checks passed"]


def test_demo_prints_the_root_scripts_lines_on_the_cpu(capsys):
    assert tdemo.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "devices: [cpu]"
    assert lines[2:] == jax_demo_lines()


def test_demo_fails_when_the_loaded_weights_differ(capsys, monkeypatch):
    """The round trip's check has teeth: a decoder scaled on load."""
    load = tckpt.load_checkpoint

    def perturbed(path):
        tree = load(path)
        ae = tree["model"]["ae"]["params"]
        ae["decoder"] = tree_map(lambda v: v * 1.5, ae["decoder"])
        return tree

    monkeypatch.setattr(tdemo.ckpt, "load_checkpoint", perturbed)
    assert tdemo.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "checkpoint round trip changed outputs" in out
    assert "All integration checks passed" not in out


# ---------------------------------------------------------------------------
# the loader's build
# ---------------------------------------------------------------------------


def test_failed_loader_build_raises(tmp_path, monkeypatch):
    """A compile error raises with the compiler's output, and a dataset
    does not fall back to numpy."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("extern \"C\" long grl_parse_xyz_file( {\n")
    monkeypatch.setattr(truntime, "SOURCE", bad)
    monkeypatch.setattr(truntime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(truntime, "_lib", None)
    tree = write_tree(tmp_path / "tree")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ exit.*error"):
        truntime.parse_xyz_file(str(next(tree.rglob("*.txt"))))
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        tdataset.ShapeNetDataset(str(tree), "train", 64)
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(truntime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(truntime, "_lib", None)
    monkeypatch.setattr(truntime.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        truntime.resample(cloud(0, 10), 16)

