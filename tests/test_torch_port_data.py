"""The port's data layer against the JAX package's
(gan_rl_3d_tpu/runtime, gan_rl_3d_tpu/data/dataset.py): the C++ loader's
five entries and ``load_files_parallel`` bit for bit on files this test
writes; ``ShapeNetDataset.as_array()`` and ``__getitem__`` equal to JAX's
(the loader's seed draw and its copy of clouds that already have the
target size); ``BatchLoader.epoch_indices`` with ``drop_last`` and the
shard-aligned plan, alone and as the trainers build it under
``training.data_residency``; the trainer's fixed hole streams. CPU, small
clouds."""

import itertools
import shutil
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu import runtime as jruntime
from gan_rl_3d_tpu.data import dataset as jdataset
from gan_rl_3d_tpu.train import RLGANNetTrainer as JaxTrainer
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch import runtime as truntime
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.ops import pointcloud as tpc
from gan_rl_3d_tpu_torch.train import trainer as ttrainer
from test_torch_port_modules import SMALL

N_TARGET = 256
SIZES = (100, 256, 700)  # below, at and above the target
EXTS = (".txt", ".pts", ".ply")


def cloud(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3) * rng.uniform(0.2, 3.0, 3)).astype(np.float32)


def write_cloud(path: Path, pts: np.ndarray) -> Path:
    """A .txt/.pts cloud as the synthetic set writes it, or an ASCII PLY
    with a color per vertex."""
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = "".join("%.6f %.6f %.6f\n" % tuple(p) for p in pts)
    if path.suffix == ".ply":
        rows = "".join("%.6f %.6f %.6f 10 20 30\n" % tuple(p) for p in pts)
        rows = ("ply\nformat ascii 1.0\nelement vertex %d\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n" % len(pts)) + rows
    path.write_text(rows)
    return path


# ---------------------------------------------------------------------------
# the C++ loader's entries, bit for bit
# ---------------------------------------------------------------------------

TEXTS = {
    "plain": "1.5 -2.25 3\n4 5 6\n-0.000001 7e-3 8E+2\n",
    "header": "x y z\n1 2 3\n4 5 6\n",
    "extra_columns": "1 2 3 0.1 0.2 0.3\n4 5 6 7\n",
    "crlf": "1.25 2 3\r\n4 5 6\r\n7 8 9\r\n",
    "blank_lines": "\n\n  1 2 3  \n\t4\t5\t6\n\n\n7 8 9",
    "non_numeric": "abc 1 2\n1 2 abc\n1 2\n.5 -.25 1e-3\nnan 1 2 3\n3 4 5",
    "no_final_newline": "1 2 3\n4 5 6",
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_xyz_file_matches_jax(tmp_path, name):
    path = tmp_path / f"{name}.txt"
    path.write_text(TEXTS[name], newline="")
    ref = jruntime.parse_xyz_file(str(path))
    got = truntime.parse_xyz_file(str(path))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_parse_truncates_and_fails_as_jax(tmp_path):
    path = write_cloud(tmp_path / "c.txt", cloud(0, 100))
    np.testing.assert_array_equal(truntime.parse_xyz_file(str(path), 37),
                                  jruntime.parse_xyz_file(str(path), 37))
    empty = tmp_path / "empty.txt"
    empty.write_text("x y z\n")
    for path in (empty, tmp_path / "missing.txt"):
        with pytest.raises(IOError):
            jruntime.parse_xyz_file(str(path))
        with pytest.raises(IOError):
            truntime.parse_xyz_file(str(path))
    no_header = tmp_path / "bad.ply"
    no_header.write_text("1 2 3\n")
    with pytest.raises(IOError):
        truntime.parse_ply_file(str(no_header))


def test_parse_ply_file_matches_jax(tmp_path):
    path = write_cloud(tmp_path / "c.ply", cloud(1, 300))
    ref = jruntime.parse_ply_file(str(path))
    np.testing.assert_array_equal(truntime.parse_ply_file(str(path)), ref)
    assert ref.shape == (300, 3)


@pytest.mark.parametrize("case", ["random", "far", "constant", "one_point"])
def test_normalize_unit_sphere_matches_jax(case):
    pts = {"random": cloud(2, 500), "far": cloud(3, 64) * 1e3 + 7e3,
           "constant": np.full((10, 3), 2.5, np.float32),
           "one_point": np.array([[1.0, -2.0, 3.0]], np.float32)}[case]
    ref = jruntime.normalize_unit_sphere(pts.copy())
    np.testing.assert_array_equal(truntime.normalize_unit_sphere(pts.copy()),
                                  ref)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", [0, 1, 12345, (1 << 40) + 3])
def test_resample_matches_jax(n, seed):
    pts = cloud(n, n)
    ref = jruntime.resample(pts, N_TARGET, seed=seed)
    got = truntime.resample(pts, N_TARGET, seed=seed)
    np.testing.assert_array_equal(got, ref)
    if n == N_TARGET:  # a cloud at the target size is copied unchanged
        np.testing.assert_array_equal(got, pts)


@pytest.mark.parametrize("seed,workers", [(0, 1), (5, 3), ((1 << 30) - 1, 8)])
def test_load_files_parallel_matches_jax(tmp_path, seed, workers):
    """Every format and size; seed 0 takes the C++ side's fixed seed for
    file 0."""
    paths = [str(write_cloud(tmp_path / f"c{i}{ext}", cloud(i, n)))
             for i, (ext, n) in enumerate(itertools.product(EXTS, SIZES))]
    ref = jruntime.load_files_parallel(paths, N_TARGET, seed=seed,
                                       workers=workers)
    got = truntime.load_files_parallel(paths, N_TARGET, seed=seed,
                                       workers=workers)
    assert got.shape == (len(paths), N_TARGET, 3)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# F3: the dataset's arrays
# ---------------------------------------------------------------------------


def write_tree(root: Path, flat: bool = False, h5: bool = False) -> Path:
    """Clouds of every size and format in three categories (one named by
    its ShapeNet id), per split directories or a flat tree."""
    cats = ("chair", "02691156", "lamp")
    splits = ("",) if flat else ("train", "val", "test")
    k = 0
    for split in splits:
        for cat in cats:
            for j in range(6 if flat else 3):
                ext, n = EXTS[k % 3], SIZES[(k // 3) % 3]
                write_cloud(root / split / cat / f"{cat}_{split}{j}{ext}",
                            cloud(k, n))
                k += 1
    if h5:
        with h5py.File(root / "train" / "chair" / "extra.h5", "w") as f:
            f["data"] = cloud(99, 300)
    return root


def both(tmp_path, tree, split, num_points=N_TARGET, **kw):
    """The JAX and the port dataset, each over its own copy of the tree
    (each writes its own index)."""
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(tree, jroot)
    shutil.copytree(tree, troot)
    return (jdataset.ShapeNetDataset(str(jroot), split, num_points, **kw),
            tdataset.ShapeNetDataset(str(troot), split, num_points, **kw))


DATASET_CASES = {
    "per_split_train": (dict(), "train", dict(seed=3)),
    "per_split_val": (dict(), "val", dict(seed=0, workers=1)),
    "fractions": (dict(flat=True), "train",
                  dict(split_fractions=(0.6, 0.2, 0.2))),
    "categories": (dict(), "train", dict(categories=["chair", "airplane"])),
    "h5_numpy_path": (dict(h5=True), "train", dict(seed=1)),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_as_array_matches_jax(tmp_path, case):
    layout, split, kw = DATASET_CASES[case]
    tree = write_tree(tmp_path / "tree", **layout)
    ref, port = both(tmp_path, tree, split, **kw)
    assert len(port) == len(ref) > 0
    assert ([(e["category"], e["model_id"]) for e in port.files]
            == [(e["category"], e["model_id"]) for e in ref.files])
    got = port.as_array()
    assert got.shape == (len(ref), N_TARGET, 3)
    np.testing.assert_array_equal(got, ref.as_array())
    if case == "categories":
        assert {e["category"] for e in port.files} == {"chair", "airplane"}


def test_uncached_getitem_matches_jax(tmp_path):
    """Without the cache each item is parsed and resampled on the
    dataset's RNG, in call order; ``as_array`` then draws after them."""
    tree = write_tree(tmp_path / "tree")
    ref, port = both(tmp_path, tree, "train", cache_in_memory=False, seed=7)
    for i in (4, 0, 4, 8, 1):
        a, b = port[i], ref[i]
        assert (a["category"], a["model_id"]) == (b["category"],
                                                  b["model_id"])
        np.testing.assert_array_equal(a["complete_pc"], b["complete_pc"])
    np.testing.assert_array_equal(port.as_array(), ref.as_array())
    np.testing.assert_array_equal(port[2]["complete_pc"],
                                  ref[2]["complete_pc"])


def test_synthetic_split_matches_jax(tmp_path):
    """The synthetic set (every cloud exactly 2048 rows) as the trainer
    loads it: each cloud its file's rows in file order."""
    root = tmp_path / "syn"
    tdataset.setup_dataset(str(root), synthetic=True, samples_per_category=1)
    ref, port = both(tmp_path, root, "train", num_points=2048, seed=42,
                     workers=2)
    got = port.as_array()
    np.testing.assert_array_equal(got, ref.as_array())
    np.testing.assert_array_equal(
        got[0], tdataset.load_txt_plain(Path(port.files[0]["path"])))


# ---------------------------------------------------------------------------
# F4: the batch plan
# ---------------------------------------------------------------------------


PLAN_CASES = [  # rows, batch, drop_last, shard groups, shuffle
    (64, 16, False, 8, True),    # grouped, aligned
    (72, 16, False, 8, True),    # grouped, each group's tail wraps
    (72, 16, True, 8, True),     # grouped, tail dropped
    (64, 16, False, 8, False),   # grouped, in order
    (60, 16, False, 8, True),    # rows not a multiple of the groups
    (64, 12, False, 8, True),    # batch not a multiple of the groups
    (13, 4, True, 1, True),
    (5, 8, False, 1, True),      # smaller than a batch: tiled
    (5, 8, True, 1, True),       # smaller than a batch: empty epochs
    (5, 16, False, 8, True),     # smaller than a batch, misaligned
]


@pytest.mark.parametrize("n,bs,drop_last,groups,shuffle", PLAN_CASES)
def test_epoch_indices_match_jax_with_shard_groups(n, bs, drop_last, groups,
                                                   shuffle):
    ds = list(range(n))  # the plan reads only len(dataset)
    kw = dict(shuffle=shuffle, seed=11, drop_last=drop_last,
              shard_groups=groups)
    ref = jdataset.BatchLoader(ds, bs, **kw)
    port = tdataset.BatchLoader(ds, bs, **kw)
    assert len(port) == len(ref)
    for _ in range(3):  # the RNG stream carries over epochs
        (i, p), (ri, rp) = port.epoch_indices(), ref.epoch_indices()
        assert i.dtype == np.int32 and p.dtype == np.float32
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(p, rp)
        if groups > 1 and n % groups == 0 and bs % groups == 0:
            # every slot group inside its row group
            g_slot = np.arange(bs) // (bs // groups)
            assert (i // (n // groups) == g_slot).all()


def tiny_trainer_config(root: Path, data: Path, residency: str) -> dict:
    return {"model": dict(SMALL["model"]),
            "training": {"precision": "float32", "batch_size": 8,
                         "seed": 5, "num_workers": 3,
                         "data_residency": residency,
                         "checkpoint_dir": str(root / "ckpt"),
                         "log_dir": str(root / "logs"),
                         "results_dir": str(root / "results")},
            "logging": {"use_tensorboard": False},
            "data": {"data_dir": str(data)}}


@pytest.mark.parametrize("residency", ["replicated", "sharded"])
def test_trainer_plan_and_first_batch_match_jax(tmp_path, residency):
    """16 train clouds at batch 8: with ``sharded`` both trainers build the
    8-group plan; the first epoch's first batch is the same clouds."""
    data = tmp_path / "data"
    tdataset.setup_dataset(str(data), synthetic=True, samples_per_category=2,
                           num_points=N_TARGET)
    shutil.copytree(data, tmp_path / "jdata")
    ref = JaxTrainer(jcfg.load_config(None, overrides=tiny_trainer_config(
        tmp_path / "j", tmp_path / "jdata", residency)), use_orbax=False)
    port = ttrainer.RLGANNetTrainer(tcfg.load_config(
        None, overrides=tiny_trainer_config(tmp_path / "t", data, residency)),
        device="cpu")
    groups = 8 if residency == "sharded" else 1
    assert port.train_loader.shard_groups == ref.train_loader.shard_groups \
        == groups
    assert port.val_loader.shard_groups == 1
    assert port.train_loader.dataset.workers == 3
    for _ in range(2):
        (i, p), (ri, rp) = (port.train_loader.epoch_indices(),
                            ref.train_loader.epoch_indices())
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(
        port.train_loader.dataset.as_array()[i[0]],
        ref.train_loader.dataset.as_array()[ri[0]])
    np.testing.assert_array_equal(port.val_loader.dataset.as_array(),
                                  ref.val_loader.dataset.as_array())


# ---------------------------------------------------------------------------
# F5: the fixed hole streams
# ---------------------------------------------------------------------------


def test_fixed_hole_streams_differ():
    """AE validation, joint validation and gate calibration draw their own
    holes for every batch; the CPU generator keeps only a seed's low 32
    bits, so streams seeded apart only above them would coincide."""
    fake = SimpleNamespace(device=torch.device("cpu"),
                           preproc=tpc.DEFAULT_PREPROC, input_points=None)
    streams = (ttrainer.AE_VAL_HOLES, ttrainer.JOINT_VAL_HOLES,
               ttrainer.GATE_HOLES)
    draws = {(s, i): ttrainer.RLGANNetTrainer._fixed_holes(fake, s, i, 4, 64)
             for s in streams for i in range(4)}
    for a, b in itertools.combinations(draws, 2):
        assert not torch.equal(draws[a]["rand_scores"],
                               draws[b]["rand_scores"]), (a, b)
    again = ttrainer.RLGANNetTrainer._fixed_holes(fake, streams[1], 2, 4, 64)
    for k, v in again.items():  # fixed: the same in every epoch
        assert torch.equal(v, draws[(streams[1], 2)][k])
