"""The port's orbax reader on the CPU, layer by layer against the tools
orbax itself uses: the zstd decoder (``utils.zstd``) against the
``zstandard`` binding, the OCDBT walk (``utils.ocdbt``) against
tensorstore's OCDBT store, and the restore (``utils.checkpoint``)
against the JAX package's orbax restore, on the three committed trained
checkpoints and on directories the JAX package writes here. Then the
serving path on the trained ``lgan_best`` against the JAX package's, and
the port's ``evaluate`` / ``complete_clouds --checkpoint`` on an orbax
checkpoint the JAX trainer wrote."""

import io
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts
import zstandard

import card_checks
from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.models import inference as jinf
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu.train import RLGANNetTrainer as JaxTrainer
from gan_rl_3d_tpu.utils import checkpoint as jckpt
from gan_rl_3d_tpu_torch import complete_clouds as tcc
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch import evaluate as tev
from gan_rl_3d_tpu_torch.convert import model_from_numpy
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.data.dataset import load_ply
from gan_rl_3d_tpu_torch.models import inference as tinf
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.utils import checkpoint as tckpt
from gan_rl_3d_tpu_torch.utils import ocdbt, zstd
from test_torch_port_modules import (GATE_MODES, N_POINTS, SMALL,
                                     port_small_config, t)

ROOT = Path(__file__).resolve().parent.parent
TRAINED = ROOT / "runs" / "best7" / "probe_lgan30" / "ckpt_lgan30"
NAMES = ("autoencoder_best", "lgan_best", "lgan_final")
LOAD_BUDGET_S = 30.0
TOL_SERVE = 1e-4  # scaled by max(1, |ref|)


def ref_decompress(frame: bytes) -> bytes:
    """zstandard's decode of one buffer, frames back to back."""
    return zstandard.ZstdDecompressor().stream_reader(
        io.BytesIO(frame), read_across_frames=True).read()


def assert_same_tree(port, ref, path="tree"):
    """Structure, types, dtypes, shapes and values, leaf for leaf."""
    if isinstance(ref, dict):
        assert type(port) is dict and set(port) == set(ref), path
        for k in ref:
            assert_same_tree(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_same_tree(p, r, f"{path}.{i}")
    elif ref is None:
        assert port is None, path
    else:
        ref = np.asarray(ref)
        assert type(port) is np.ndarray, (path, type(port))
        assert port.dtype == ref.dtype and port.shape == ref.shape, path
        assert np.array_equal(port, ref), path


def count_arrays(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_arrays(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_arrays(v) for v in tree)
    return int(isinstance(tree, np.ndarray))


@pytest.fixture(scope="module")
def restored():
    """Each committed checkpoint restored once by each package, with the
    port's seconds."""
    out = {}
    for name in NAMES:
        t0 = time.perf_counter()
        port = tckpt.load_checkpoint(str(TRAINED / name))
        seconds = time.perf_counter() - t0
        out[name] = (port, jckpt.load_checkpoint(str(TRAINED / name)),
                     seconds)
    return out


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------


def _frames_of(root: Path) -> list:
    """Every zstd frame of an orbax checkpoint: each array chunk in the
    OCDBT store, and the bodies of the manifest and B-tree nodes."""
    store = ocdbt.OcdbtStore(root)
    frames = [store.read(k) for k in store.list_keys()
              if not k.endswith(".zarray")]
    for path in [root / "manifest.ocdbt", *root.glob("ocdbt.process_*/"
                                                     "manifest.ocdbt")]:
        frames.append(path.read_bytes()[14:-4])
    for path in (root / "d").iterdir():
        frames.append(path.read_bytes()[14:-4])  # the root's B-tree node
    return frames


@pytest.mark.parametrize("name", NAMES)
def test_zstd_decodes_every_frame_of_the_committed_checkpoints(name):
    frames = _frames_of(TRAINED / name)
    out = zstd.decompress_many(frames)
    assert len(out) == len(frames) > 350
    for frame, got in zip(frames, out):
        assert got == ref_decompress(frame)


def _inputs():
    rng = np.random.RandomState(0)
    return {"random": rng.bytes(5000),
            "text": b"the quick brown fox jumps over the lazy dog. " * 900,
            "float32": rng.randn(30000).astype(np.float32).tobytes(),
            "empty": b"",
            # past one 128 KB block, text and noise interleaved
            "multi_block": (b"abcdefgh" * 30000 + rng.bytes(200000)
                            + b"0123" * 20000)}


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_zstd_matches_zstandard_byte_for_byte(level, content_size):
    for what, data in _inputs().items():
        frame = zstandard.ZstdCompressor(
            level=level, write_content_size=content_size).compress(data)
        assert zstd.decompress(frame) == data, what


def test_zstd_frames_back_to_back_and_checksums():
    inputs = list(_inputs().values())
    frames = [zstandard.ZstdCompressor(level=3, write_checksum=True)
              .compress(x) for x in inputs]
    assert zstd.decompress(b"".join(frames)) == b"".join(inputs)
    assert zstd.decompress_many(frames) == inputs
    bad = bytearray(frames[2])
    bad[-1] ^= 0x01  # the stored XXH64 bits
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


def test_zstd_refuses_a_dictionary_frame():
    samples = [(f"record {i}: value={i * 7 % 13} tag=" + "abc" * (i % 5))
               .encode() for i in range(400)]
    d = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[3] * 3)
    with pytest.raises(ValueError, match="dictionar"):
        zstd.decompress(frame)


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


def _assert_store_matches_tensorstore(root: Path):
    ref = ts.KvStore.open({"driver": "ocdbt",
                           "base": f"file://{root}/"}).result()
    keys = sorted(k.decode() for k in ref.list().result())
    store = ocdbt.OcdbtStore(root)
    assert store.list_keys() == keys
    for k in keys:
        assert store.read(k) == ref.read(k).result().value, k


@pytest.mark.parametrize("name", NAMES)
def test_ocdbt_matches_tensorstore_on_the_committed_checkpoints(name):
    _assert_store_matches_tensorstore(TRAINED / name)


@pytest.mark.parametrize("compression", [{"id": "zstd", "level": 5}, None])
def test_ocdbt_walks_interior_nodes_like_tensorstore(tmp_path, compression):
    """Nodes of at most 300 bytes make a tree several levels deep, with
    values inline and in data files."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16,
                                     "compression": compression}}).result()
    for i in range(60):
        kv.write(f"k{i % 7}/x{i:03d}", bytes([i]) * (i % 40)).result()
    _assert_store_matches_tensorstore(tmp_path)


def _with_valid_crc(blob: bytes) -> bytes:
    body = blob[:-4]
    return body + ocdbt.crc32c(body).to_bytes(4, "little")


def test_ocdbt_checks_and_refusals(tmp_path):
    root = tmp_path / "ckpt"
    shutil.copytree(TRAINED / "lgan_best", root)
    manifest = root / "manifest.ocdbt"
    good = manifest.read_bytes()
    assert ocdbt.crc32c(good[:-4]) == int.from_bytes(good[-4:], "little")
    manifest.write_bytes(good[:-1] + bytes([good[-1] ^ 1]))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtStore(root)
    manifest.write_bytes(_with_valid_crc(good[:13] + b"\x02" + good[14:]))
    with pytest.raises(ValueError, match="compression 2"):
        ocdbt.OcdbtStore(root)
    manifest.write_bytes(_with_valid_crc(good[:12] + b"\x01" + good[13:]))
    with pytest.raises(ValueError, match="version 1"):
        ocdbt.OcdbtStore(root)
    manifest.write_bytes(b"\x00" + good[1:])
    with pytest.raises(ValueError, match="magic"):
        ocdbt.OcdbtStore(root)
    manifest.write_bytes(good)
    meta = json.loads((root / "_METADATA").read_text())
    (root / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3"):
        tckpt.load_checkpoint(str(root))
    (root / "_METADATA").unlink()
    with pytest.raises(ValueError, match="_METADATA"):
        tckpt.load_checkpoint(str(root))


# ---------------------------------------------------------------------------
# the restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_restore_equals_orbax_on_the_committed_checkpoints(restored, name):
    port, ref, seconds = restored[name]
    print(f"{name}: the port's load_checkpoint took {seconds:.2f} s")
    assert_same_tree(port, ref)
    assert count_arrays(port) == 350
    assert port["model"]["agent"]["opt"]["actor"][1] is None
    assert port["model"]["ae"]["state"]["decoder"]["mlp"][2] == {}


def test_load_model_checkpoint_reads_lgan_best_within_budget(tmp_path):
    shutil.copytree(TRAINED, tmp_path / "ckpt")
    t0 = time.perf_counter()
    model, meta = tckpt.load_model_checkpoint(str(tmp_path / "ckpt"),
                                              "lgan_best")
    seconds = time.perf_counter() - t0
    print(f"load_model_checkpoint(lgan_best): {seconds:.2f} s on this CPU")
    assert seconds <= LOAD_BUDGET_S
    assert (int(meta["epoch"]), int(meta["phase_idx"])) == (28, 1)
    assert set(model) == {"ae", "lgan", "agent"}


def test_restore_equals_orbax_on_directories_the_jax_package_writes(
        tmp_path):
    rng = np.random.RandomState(3)
    tree = {
        "f32": rng.randn(3, 5).astype(np.float32),
        "i32": rng.randint(-9, 9, (4,)).astype(np.int32),
        "i8": rng.randint(-128, 127, (2, 3, 4)).astype(np.int8),
        "u8": rng.randint(0, 255, (7,)).astype(np.uint8),
        "flag": rng.rand(5) > 0.5,
        "scalar": np.float32(2.5), "count": np.int32(7),
        "seq": [np.zeros(2, np.float32), {"a": np.ones((1, 1), np.int32)},
                [np.arange(3, dtype=np.int32)]],
        "empty": {}, "none": None, "empty_list": [], "empty_tuple": (),
        "big": rng.randn(300, 200).astype(np.float32),  # > one zstd block
    }
    jckpt.save_checkpoint(str(tmp_path / "fresh"), tree)
    assert (tmp_path / "fresh" / "_METADATA").exists()
    port = tckpt.load_checkpoint(str(tmp_path / "fresh"))
    assert_same_tree(port, jckpt.load_checkpoint(str(tmp_path / "fresh")))
    assert port["big"].nbytes > 128 * 1024


# ---------------------------------------------------------------------------
# serving the trained checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate_mode", GATE_MODES)
def test_trained_lgan_best_serves_as_in_jax(restored, gate_mode):
    """The port's complete on lgan_best as the port reads it, against the
    JAX package's complete on lgan_best as orbax restores it, at B=2 and
    N=2048 with the shipped recipe's widths."""
    port_tree, ref_tree, _ = restored["lgan_best"]
    rng = np.random.RandomState(11)
    pc = (rng.randn(2, 2048, 3) * [0.4, 0.3, 0.2]).astype(np.float32)
    mask = np.ones((2, 2048), np.float32)
    mask[1, 1600:] = 0.0
    ref = jnet.complete(
        ref_tree["model"], pc, mask,
        cfg=jcfg.load_config(str(ROOT / "configs" / "config.yaml"))
        .td3_config(), gate_mode=gate_mode)
    out = tnet.complete(model_from_numpy(port_tree["model"], device="cpu"),
                        t(pc), t(mask),
                        cfg=tcfg.flagship_config().td3_config(),
                        gate_mode=gate_mode)
    assert set(out) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        err = np.abs(out[k].numpy() - r).max() / max(1.0, np.abs(r).max())
        assert err <= TOL_SERVE, (k, err)


def test_trained_int8_engine_matches_jax(restored):
    """The int8 engine of lgan_best, port against the JAX package, on the
    synthetic clouds the trained-weights card test serves it (B=64): every output within 1e-4
    scaled. Both miss the random-weight GFV bound (2e-2 of the largest
    element, tests/test_fused_encoder.py:98-100) by the same amount on
    these weights, and JAX's reading sets the card tests' trained-weight
    limit (card_checks.TOL_INT8_GFV_TRAINED)."""
    port_tree, ref_tree, _ = restored["lgan_best"]
    pc, mask = card_checks.synthetic_clouds(64, 2048, seed=90, device="cpu")
    model = model_from_numpy(port_tree["model"], device="cpu")
    out = {q: tinf.complete_fast(tinf.prepare_inference_engine(
        model, quantize_int8=q), pc, mask, gate_mode="rl")
        for q in (False, True)}
    ref = {q: jinf.complete_fast(jinf.prepare_inference_engine(
        ref_tree["model"], quantize_int8=q), pc.numpy(), mask.numpy(),
        gate_mode="rl") for q in (False, True)}
    for k in ref[True]:
        r = np.asarray(ref[True][k])
        err = np.abs(out[True][k].numpy() - r).max() / max(1.0,
                                                           np.abs(r).max())
        assert err <= TOL_SERVE, (k, err)

    def gfv_err(o):
        a, b = (np.asarray(o[x]["noisy_gfv"]) for x in (True, False))
        return np.abs(a - b).max() / np.abs(b).max()
    port_err, jax_err = gfv_err(out), gfv_err(ref)
    print(f"int8 GFV vs f32 on lgan_best: port {port_err:.4e}, JAX "
          f"{jax_err:.4e}")
    assert abs(port_err - jax_err) <= 1e-5
    assert jax_err <= card_checks.TOL_INT8_GFV_TRAINED


# ---------------------------------------------------------------------------
# the CLIs on an orbax checkpoint the JAX trainer wrote
# ---------------------------------------------------------------------------


def test_cli_serves_an_orbax_checkpoint_of_the_jax_trainer(tmp_path):
    tdataset.setup_dataset(str(tmp_path / "data"), synthetic=True,
                           samples_per_category=2, num_points=N_POINTS)
    cfg = {**SMALL,
           "training": {"batch_size": 8,
                        "checkpoint_dir": str(tmp_path / "ckpt"),
                        "log_dir": str(tmp_path / "logs"),
                        "results_dir": str(tmp_path / "results")},
           "logging": {"use_tensorboard": False},
           "data": {"data_dir": str(tmp_path / "data")},
           "evaluation": {"metrics": ["chamfer_distance", "f_score"]}}
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    jtrainer = JaxTrainer(jcfg.load_config(None, overrides=cfg),
                          use_orbax=True)
    jtrainer.save_checkpoint("jax_orbax", 3, "autoencoder")
    jtrainer.close()
    assert (tmp_path / "ckpt" / "jax_orbax" / "_METADATA").exists()

    stats = tev.main(["--config", str(tmp_path / "tiny.json"),
                      "--checkpoint", "jax_orbax", "--device", "cpu",
                      "--num-export", "1"])
    assert {"chamfer_distance", "f_score"} <= set(stats)
    assert all(np.isfinite(v) for v in stats.values())

    src = tmp_path / "in" / "a.txt"
    src.parent.mkdir()
    np.savetxt(src, np.random.RandomState(1).randn(300, 3) + [4.0, -1.0, 2.0])
    tcc.main([str(src), "--checkpoint", "jax_orbax", "--config",
              str(tmp_path / "tiny.json"), "--output-dir",
              str(tmp_path / "out"), "--device", "cpu"])
    pc, mask, (centroid, scale) = tcc._load_framed(
        str(src), N_POINTS, np.random.RandomState(0))
    tree = jckpt.load_checkpoint(str(tmp_path / "ckpt" / "jax_orbax"))
    ref = tnet.complete(model_from_numpy(tree["model"], device="cpu"),
                        t(pc[None]), t(mask[None]),
                        cfg=port_small_config().td3_config())["hybrid_output"]
    np.testing.assert_allclose(load_ply(tmp_path / "out" / "a_completed.ply"),
                               ref[0].numpy() * scale + centroid, atol=2e-5)
