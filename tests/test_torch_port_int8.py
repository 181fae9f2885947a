"""Port parity for the int8 engine: ops/quantize.py, K6's plain version and
the int8 ``complete_fast`` against the JAX package (its Pallas kernel in
interpret mode), on the same numpy weights and clouds, on the CPU; and
int8 engine files crossing between the two packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu.models import inference as jinf
from gan_rl_3d_tpu.ops import encoder_kernel as jek
from gan_rl_3d_tpu.ops import quantize as jq
from gan_rl_3d_tpu_torch.convert import engine_from_numpy, model_from_numpy
from gan_rl_3d_tpu_torch.models import inference as tinf
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.ops import _cuda
from gan_rl_3d_tpu_torch.ops import encoder_kernel as tek
from gan_rl_3d_tpu_torch.ops import quantize as tq
from test_torch_port_modules import (GATE_MODES, close, port_small_config,
                                     small_clouds, small_model_tree, t)

# K6's plain version against the JAX kernel: the JAX package's own
# kernel-vs-twin bound (tests/test_fused_encoder.py:96-97). A last-bit
# difference upstream can move y / s_x across a rounding boundary, which
# changes that activation by one quantum.
RTOL, ATOL = 1e-2, 1e-3
KEYS = ("noisy_gfv", "z_vector", "clean_gfv", "completed_pc",
        "ae_reconstruction")
SMALL_DIMS = (3, 16, 32, 32, 64, 32)
FLAGSHIP_DIMS = (3, 64, 128, 128, 256, 128)


def _folded(dims, seed):
    """BN-folded-like (w, b) layers as numpy, one output channel of the
    second layer all zero (its weight scale clamps at 1e-12)."""
    rng = np.random.RandomState(seed)
    layers = []
    for k, c in zip(dims[:-1], dims[1:]):
        w = rng.uniform(-1, 1, (k, c)).astype(np.float32) / np.sqrt(k)
        b = rng.uniform(-0.1, 0.1, c).astype(np.float32)
        layers.append((w, b))
    layers[1][0][:, 3] = 0.0
    return layers


def _bundles(dims, seed):
    """The same folded layers quantized by both packages."""
    layers = _folded(dims, seed)
    jb = jax.tree.map(np.asarray, jq.quantize_encoder(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]))
    tb = tq.quantize_encoder([(t(w), t(b)) for w, b in layers])
    return jb, tb


def test_quantize_matches_jax_exactly():
    rng = np.random.RandomState(0)
    w = rng.randn(48, 24).astype(np.float32)
    w[:, 5] = 0.0
    x = np.abs(rng.randn(10, 48)).astype(np.float32)
    x[3] = 0.0
    for port_fn, jax_fn, arr in ((tq.quantize_weight_per_channel,
                                  jq.quantize_weight_per_channel, w),
                                 (tq.quantize_rows, jq.quantize_rows, x)):
        q, s = port_fn(t(arr))
        jq_, js = jax_fn(jnp.asarray(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # halves round to even on both sides
    halves = np.array([[0.5, 1.5, 2.5, -0.5, 127.0]], np.float32)
    np.testing.assert_array_equal(tq.quantize_rows(t(halves))[0].numpy(),
                                  np.asarray(jq.quantize_rows(halves)[0]))
    xq, sx = tq.quantize_rows(t(x))
    wq, sw = tq.quantize_weight_per_channel(t(w))
    bias = rng.randn(24).astype(np.float32)
    ref = jq.int8_dense(jnp.asarray(xq.numpy()), jnp.asarray(sx.numpy()),
                        jnp.asarray(wq.numpy()), jnp.asarray(sw.numpy()),
                        jnp.asarray(bias))
    close(tq.int8_dense(xq, sx, wq, sw, t(bias)), ref, 1e-6, rtol=1e-6)


@pytest.mark.parametrize("dims", [SMALL_DIMS, FLAGSHIP_DIMS])
def test_quantize_encoder_bundle_matches_jax(dims):
    jb, tb = _bundles(dims, seed=1)
    np.testing.assert_array_equal(tb["layer0"][0].numpy(), jb["layer0"][0])
    np.testing.assert_array_equal(tb["layer0"][1].numpy(), jb["layer0"][1])
    assert len(tb["layers_q"]) == len(jb["layers_q"]) == len(dims) - 2
    for (wq, sw, b), (jwq, jsw, jb_) in zip(tb["layers_q"], jb["layers_q"]):
        assert wq.dtype == torch.int8 and jwq.dtype == np.int8
        np.testing.assert_array_equal(wq.numpy(), jwq)
        np.testing.assert_array_equal(sw.numpy(), jsw)
        np.testing.assert_array_equal(b.numpy(), jb_)


@pytest.mark.parametrize("dims", [SMALL_DIMS, FLAGSHIP_DIMS])
@pytest.mark.parametrize("masked", [False, True])
def test_int8_pool_plain_matches_jax_kernel(dims, masked):
    """fused_encoder_pool_int8_plain against the JAX kernel in interpret
    mode, and encode_int8_plain against encode_int8_xla; a fully masked
    cloud pools to -inf in both."""
    jb, tb = _bundles(dims, seed=2)
    pc, mask = small_clouds(seed=3, bsz=4, n=256, n_valid=180)
    mask[3] = 0.0
    m = mask if masked else None
    ref = np.asarray(jek.fused_encoder_pool_int8(
        jnp.asarray(pc), jax.tree.map(jnp.asarray, jb),
        None if m is None else jnp.asarray(m), interpret=True))
    out = tek.fused_encoder_pool_int8_plain(t(pc), tb,
                                            None if m is None else t(m))
    assert out.shape == ref.shape == (4, dims[-1])
    np.testing.assert_array_equal(np.isinf(out.numpy()), np.isinf(ref))
    fin = np.isfinite(ref)
    close(out.numpy()[fin], ref[fin], ATOL, rtol=RTOL)
    if masked:
        assert np.isneginf(out.numpy()[3]).all()
    ref_xla = np.asarray(jq.encode_int8_xla(
        jnp.asarray(pc), jax.tree.map(jnp.asarray, jb),
        None if m is None else jnp.asarray(m)))
    xla = tq.encode_int8_plain(t(pc), tb, None if m is None else t(m))
    close(xla.numpy()[fin], ref_xla[fin], ATOL, rtol=RTOL)
    # the two clamp orders agree unless a row's maximum is below 1.27e-10
    close(xla, out, 0.0)


def test_int8_pool_routes_cpu_tensors_to_the_plain_version():
    _, tb = _bundles(SMALL_DIMS, seed=4)
    pc, mask = small_clouds(seed=5, bsz=2, n=100, n_valid=60)
    before = dict(_cuda.launch_counts)
    assert torch.equal(tek.fused_encoder_pool_int8(t(pc), tb, t(mask)),
                       tek.fused_encoder_pool_int8_plain(t(pc), tb, t(mask)))
    assert dict(_cuda.launch_counts) == before


def test_int8_weight_packing_feeds_dp4a():
    """pack_int8_weight's words, read back byte by byte as __dp4a reads
    them, give the int8 product exactly."""
    g = torch.Generator().manual_seed(6)
    wq = torch.randint(-127, 128, (16, 24), generator=g).to(torch.int8)
    xq = torch.randint(-127, 128, (5, 16), generator=g).to(torch.int8)
    words = tek.pack_int8_weight(wq)
    assert words.shape == (4, 24) and words.dtype == torch.int32
    unpacked = words.view(torch.int8).reshape(4, 24, 4).permute(0, 2, 1)
    assert torch.equal(unpacked.reshape(16, 24), wq)
    ref = xq.long() @ wq.long()
    assert torch.equal(tq.int8_matmul(xq, wq).long(), ref)


@pytest.fixture(scope="module")
def models():
    _, tree = small_model_tree(seed=8, gan_path=True)
    plain = {k: v for k, v in tree.items() if k != "gan_path"}
    return {"jax": {False: plain, True: tree},
            "port": {False: model_from_numpy(plain, device="cpu"),
                     True: model_from_numpy(tree, device="cpu")}}


def _compare(out, ref, atol, rtol):
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k], atol, rtol=rtol)


@pytest.mark.parametrize("gate_mode", GATE_MODES)
@pytest.mark.parametrize("with_gan_path", [False, True])
def test_int8_complete_fast_matches_jax(models, gate_mode, with_gan_path):
    """The int8 engine with an f32 tail against the JAX one (the bound
    above), and against the unfolded complete within 0.1 on completed_pc
    (tests/test_fused_encoder.py:119-121)."""
    pc, mask = small_clouds(seed=9)
    jeng = jinf.prepare_inference_engine(models["jax"][with_gan_path],
                                         quantize_int8=True)
    ref = jinf.complete_fast(jeng, jnp.asarray(pc), jnp.asarray(mask),
                             gate_mode=gate_mode, gate_bias=-0.02)
    engine = tinf.prepare_inference_engine(models["port"][with_gan_path],
                                           quantize_int8=True)
    out = tinf.complete_fast(engine, t(pc), t(mask), gate_mode=gate_mode,
                             gate_bias=-0.02)
    _compare(out, ref, ATOL, RTOL)
    plain = tnet.complete(models["port"][with_gan_path], t(pc), t(mask),
                          cfg=port_small_config().td3_config(),
                          gate_mode=gate_mode, gate_bias=-0.02)
    err = float((out["completed_pc"] - plain["completed_pc"]).abs().max())
    assert err <= 0.1, err


def test_int8_engine_layout_and_bf16_tail(models):
    """encoder_q is quantized from an f32 fold and left alone by the bf16
    cast; the bf16-tail int8 engine agrees with the JAX one within the
    bf16 engine's bound (2e-2 relative)."""
    engine = tinf.prepare_inference_engine(models["port"][True],
                                           dtype=torch.bfloat16,
                                           quantize_int8=True)
    f32 = tinf.prepare_inference_engine(models["port"][True],
                                        quantize_int8=True)
    assert engine["encoder"]["layers"][1][0].dtype == torch.bfloat16
    for a, b in zip(engine["encoder_q"]["layers_q"],
                    f32["encoder_q"]["layers_q"]):
        assert a[0].dtype == torch.int8 and a[1].dtype == torch.float32
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    pc, mask = small_clouds(seed=10)
    jeng = jinf.prepare_inference_engine(models["jax"][True],
                                         dtype=jnp.bfloat16,
                                         quantize_int8=True)
    ref = jinf.complete_fast(jeng, jnp.asarray(pc), jnp.asarray(mask),
                             dtype=jnp.bfloat16, gate_mode="rl")
    out = tinf.complete_fast(engine, t(pc), t(mask), gate_mode="rl")
    for k in KEYS:
        r = np.asarray(ref[k], np.float32)
        rel = np.abs(out[k].float().numpy() - r).max() / np.abs(r).max()
        assert rel <= 2e-2, (k, rel)


def test_int8_engine_files_cross_between_packages(models, tmp_path):
    """A JAX-written int8 engine file serves in the port with the outputs
    of the same tree handed over in memory; the port's file of it loads in
    the JAX package with the JAX outputs of the original, bit for bit."""
    pc, mask = small_clouds(seed=11)
    jeng = jinf.prepare_inference_engine(models["jax"][True],
                                         quantize_int8=True)
    jinf.save_engine(str(tmp_path / "jax_q.pkl"), jeng)
    engine = tinf.load_engine(str(tmp_path / "jax_q.pkl"), device="cpu")
    assert engine["encoder_q"]["layers_q"][0][0].dtype == torch.int8
    direct = engine_from_numpy(jax.tree.map(np.asarray, jeng), device="cpu")
    a = tinf.complete_fast(engine, t(pc), t(mask))
    b = tinf.complete_fast(direct, t(pc), t(mask))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ref = jinf.complete_fast(jeng, jnp.asarray(pc), jnp.asarray(mask))
    _compare(a, ref, ATOL, RTOL)

    tinf.save_engine(str(tmp_path / "port_q.pkl"), engine)
    back = jinf.load_engine(str(tmp_path / "port_q.pkl"))
    assert np.asarray(back["encoder_q"]["layers_q"][0][0]).dtype == np.int8
    again = jinf.complete_fast(back, jnp.asarray(pc), jnp.asarray(mask))
    for k in ref:
        np.testing.assert_array_equal(np.asarray(again[k]),
                                      np.asarray(ref[k]))
