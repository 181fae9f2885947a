"""Port parity for the slice as a whole: the folded engine
(prepare_inference_engine / complete_fast / save_engine / load_engine)
against the JAX package's, on the same weights and clouds, on the CPU."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu.models import inference as jinf
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu_torch.convert import engine_from_numpy, model_from_numpy
from gan_rl_3d_tpu_torch.models import inference as tinf
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from test_torch_port_modules import (GATE_MODES, close, port_small_config,
                                     small_clouds, small_config,
                                     small_model_tree, t)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import card_checks  # noqa: E402

KEYS = ("noisy_gfv", "z_vector", "clean_gfv", "completed_pc",
        "ae_reconstruction")


@pytest.fixture(scope="module")
def models():
    _, tree = small_model_tree(seed=3, gan_path=True)
    plain = {k: v for k, v in tree.items() if k != "gan_path"}
    return {
        "jax": {False: plain, True: tree},
        "port": {False: model_from_numpy(plain, device="cpu"),
                 True: model_from_numpy(tree, device="cpu")},
    }


def _compare(out, ref, atol):
    assert set(out) == set(ref)
    for k in ref:
        # discriminator scores are O(1-10): their f32 rounding is relative
        close(out[k], ref[k], atol, rtol=atol)


@pytest.mark.parametrize("gate_mode", GATE_MODES)
@pytest.mark.parametrize("with_gan_path", [False, True])
def test_complete_fast_f32_matches_jax(models, gate_mode, with_gan_path):
    pc, mask = small_clouds(seed=11)
    jeng = jinf.prepare_inference_engine(models["jax"][with_gan_path])
    ref = jinf.complete_fast(jeng, jnp.asarray(pc), jnp.asarray(mask),
                             gate_mode=gate_mode, gate_bias=-0.02)
    engine = tinf.prepare_inference_engine(models["port"][with_gan_path])
    out = tinf.complete_fast(engine, t(pc), t(mask), gate_mode=gate_mode,
                             gate_bias=-0.02)
    _compare(out, ref, 1e-4)
    # and the folded engine against the port's own unfolded path
    plain = tnet.complete(models["port"][with_gan_path], t(pc), t(mask),
                          cfg=port_small_config().td3_config(),
                          gate_mode=gate_mode, gate_bias=-0.02)
    _compare(out, plain, 1e-4)


def test_complete_fast_unmasked_and_no_hybrid(models):
    pc, _ = small_clouds(seed=12)
    jeng = jinf.prepare_inference_engine(models["jax"][False])
    ref = jinf.complete_fast(jeng, jnp.asarray(pc), hybrid=False)
    engine = tinf.prepare_inference_engine(models["port"][False])
    out = tinf.complete_fast(engine, t(pc), hybrid=False)
    _compare(out, ref, 1e-4)
    with pytest.raises(ValueError, match="invalid gate_mode"):
        tinf.complete_fast(engine, t(pc), gate_mode="bogus")


@pytest.mark.parametrize("with_gan_path", [False, True])
def test_complete_fast_bf16_matches_jax(models, with_gan_path):
    pc, mask = small_clouds(seed=13)
    jeng = jinf.prepare_inference_engine(models["jax"][with_gan_path],
                                         dtype=jnp.bfloat16)
    ref = jinf.complete_fast(jeng, jnp.asarray(pc), jnp.asarray(mask),
                             dtype=jnp.bfloat16, gate_mode="rl")
    engine = tinf.prepare_inference_engine(models["port"][with_gan_path],
                                           dtype=torch.bfloat16)
    assert engine["encoder"]["layers"][0][1].dtype == torch.bfloat16
    assert engine["encoder"]["head"][1].dtype == torch.float32
    out = tinf.complete_fast(engine, t(pc), t(mask), gate_mode="rl")
    for k in KEYS:
        r = np.asarray(ref[k], np.float32)
        rel = np.abs(out[k].float().numpy() - r).max() / np.abs(r).max()
        assert rel <= 2e-2, (k, rel)


def test_jax_engine_file_serves_in_the_port(models, tmp_path):
    """A JAX save_engine f32 file loads as it is and gives JAX's outputs;
    the port's engine file loads in the JAX package."""
    pc, mask = small_clouds(seed=14)
    jeng = jinf.prepare_inference_engine(models["jax"][True])
    ref = jinf.complete_fast(jeng, jnp.asarray(pc), jnp.asarray(mask))
    jinf.save_engine(str(tmp_path / "jax.pkl"), jeng)
    engine = tinf.load_engine(str(tmp_path / "jax.pkl"), device="cpu")
    _compare(tinf.complete_fast(engine, t(pc), t(mask)), ref, 1e-4)

    tinf.save_engine(str(tmp_path / "port.pkl"), engine)
    back = jinf.load_engine(str(tmp_path / "port.pkl"))
    _compare(jinf.complete_fast(back, jnp.asarray(pc), jnp.asarray(mask)),
             ref, 1e-4)

    # cast at load time: the same engine as folding straight to bf16
    bf16 = tinf.load_engine(str(tmp_path / "jax.pkl"), device="cpu",
                            dtype=torch.bfloat16)
    direct = tinf.prepare_inference_engine(models["port"][True],
                                           dtype=torch.bfloat16)
    a = tinf.complete_fast(bf16, t(pc), t(mask), gate_mode="rl")
    b = tinf.complete_fast(direct, t(pc), t(mask), gate_mode="rl")
    for k in KEYS:
        close(a[k].float(), b[k].float(), 1e-2)


def test_engine_from_numpy_rejects_other_trees(models):
    jeng = jax.tree.map(np.asarray,
                        jinf.prepare_inference_engine(models["jax"][False]))
    engine = engine_from_numpy(jeng, device="cpu")
    assert set(engine) == set(jeng)
    # an int8 engine's bundle converts with its int8 weights kept int8
    qeng = jax.tree.map(np.asarray, jinf.prepare_inference_engine(
        models["jax"][False], quantize_int8=True))
    engine_q = engine_from_numpy(qeng, device="cpu")
    wq, s_w, _ = engine_q["encoder_q"]["layers_q"][0]
    assert wq.dtype == torch.int8 and s_w.dtype == torch.float32
    with pytest.raises(ValueError, match="missing"):
        engine_from_numpy({"encoder": jeng["encoder"]}, device="cpu")


def test_smoke_model_tree_has_the_jax_layout():
    """The card tests' random weights (card_checks.init_numpy_model) feed the JAX package's own complete
    unchanged, and the port agrees with it on them."""
    pcfg = port_small_config()
    tree = card_checks.init_numpy_model(pcfg, seed=0)
    pc, mask = small_clouds(seed=15)
    ref = jnet.complete(tree, pc, mask, cfg=small_config().td3_config())
    out = tnet.complete(model_from_numpy(tree, device="cpu"), t(pc), t(mask),
                        cfg=pcfg.td3_config())
    _compare(out, ref, 1e-5)

