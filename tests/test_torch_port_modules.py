"""Port parity, module by module: gan_rl_3d_tpu_torch against gan_rl_3d_tpu
on the same numpy weights and inputs, at small widths on the CPU.

The helpers at the top (small config, randomised model tree) are shared
with the other tests/test_torch_port_*.py files."""

import json

import jax
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu import nn as jnn
from gan_rl_3d_tpu.data import dataset as jdataset
from gan_rl_3d_tpu.models import autoencoder as jae
from gan_rl_3d_tpu.models import latent_gan as jlg
from gan_rl_3d_tpu.models import rl_agent as jrl
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu.train import gate as jgate
from gan_rl_3d_tpu.utils import ply as jply
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch import nn as tnn
from gan_rl_3d_tpu_torch.convert import model_from_numpy
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.models import autoencoder as tae
from gan_rl_3d_tpu_torch.models import latent_gan as tlg
from gan_rl_3d_tpu_torch.models import rl_agent as trl
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.train import gate as tgate
from gan_rl_3d_tpu_torch.utils import ply as tply

N_POINTS = 256
SMALL = {"model": {
    "autoencoder": {"latent_dim": 32, "num_points": N_POINTS,
                    "encoder_dims": [16, 32, 32, 64, 32],
                    "decoder_dims": [64, 64, N_POINTS * 3]},
    "lgan": {"z_dim": 4, "latent_dim": 32, "generator_dims": [32, 64, 32],
             "discriminator_dims": [32, 64, 1]},
    "rl_agent": {"state_dim": 32, "action_dim": 4,
                 "hidden_dims": [32, 32, 32]},
}}
GATE_MODES = ("discriminator", "rl", "ae", "union")


def small_config():
    return jcfg.load_config(None, overrides=SMALL)


def port_small_config():
    m = SMALL["model"]
    return tcfg.Config(model=tcfg.ModelConfig(
        autoencoder=tcfg.AutoencoderModelConfig(
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in m["autoencoder"].items()}),
        lgan=tcfg.LGANModelConfig(
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in m["lgan"].items()}),
        rl_agent=tcfg.RLAgentModelConfig(
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in m["rl_agent"].items()})))


def _randomise_norms(tree, rng):
    """Non-trivial BN running stats and norm affine params, so folding and
    normalisation are exercised (the init values are 0/1)."""
    if isinstance(tree, dict):
        if set(tree) == {"mean", "var"}:
            d = tree["mean"].shape
            return {"mean": rng.uniform(-0.3, 0.3, d).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, d).astype(np.float32)}
        if set(tree) == {"scale", "bias"}:
            d = tree["scale"].shape
            return {"scale": rng.uniform(0.8, 1.2, d).astype(np.float32),
                    "bias": rng.uniform(-0.1, 0.1, d).astype(np.float32)}
        return {k: _randomise_norms(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_randomise_norms(v, rng) for v in tree)
    return tree


def small_model_tree(seed=0, gan_path=False):
    """JAX model tree (numpy leaves) at SMALL widths, randomised norms; with
    ``gan_path`` a snapshot drawn from another seed rides along."""
    config = small_config()
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray,
                        jnet.init_model(jax.random.PRNGKey(seed), config))
    tree["ae"] = _randomise_norms(tree["ae"], rng)
    tree["lgan"] = _randomise_norms(tree["lgan"], rng)
    tree["agent"]["actor"] = _randomise_norms(tree["agent"]["actor"], rng)
    if gan_path:
        other = jax.tree.map(np.asarray, jnet.init_model(
            jax.random.PRNGKey(seed + 100), config))
        other = _randomise_norms(other, rng)
        tree["gan_path"] = {
            "generator": {"params": other["lgan"]["params"]["generator"],
                          "state": other["lgan"]["state"]["generator"]},
            "decoder": {"params": other["ae"]["params"]["decoder"],
                        "state": other["ae"]["state"]["decoder"]},
        }
    return config, tree


def small_clouds(seed=0, bsz=3, n=N_POINTS, n_valid=200):
    rng = np.random.RandomState(seed)
    pc = (rng.randn(bsz, n, 3) * 0.5).astype(np.float32)
    mask = np.zeros((bsz, n), np.float32)
    mask[:, :n_valid] = 1.0
    return pc, mask


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_defaults_match_jax():
    j, p = jcfg.Config(), tcfg.Config()
    for section in ("autoencoder", "lgan"):
        jd = jcfg.dataclasses.asdict(getattr(j.model, section))
        pd = jcfg.dataclasses.asdict(getattr(p.model, section))
        # the port's PCN fields (the folding decoder, the subsampled
        # input) have no JAX counterpart
        extra = {"num_coarse", "grid_size", "grid_scale", "input_points"} \
            if section == "autoencoder" else set()
        assert set(pd) - set(jd) == extra
        assert {k: pd[k] for k in jd} == jd
    jr = jcfg.dataclasses.asdict(j.model.rl_agent)
    for k, v in jcfg.dataclasses.asdict(p.model.rl_agent).items():
        assert jr[k] == v
    assert (p.model.gate_mode, p.model.gate_bias) == (j.model.gate_mode,
                                                       j.model.gate_bias)
    assert p.training.checkpoint_dir == j.training.checkpoint_dir
    jt, pt = j.td3_config(), p.td3_config()
    for k in trl.TD3Config._fields:
        assert getattr(pt, k) == getattr(jt, k), k


def test_flagship_config_equals_shipped_yaml():
    from pathlib import Path

    path = str(Path(__file__).resolve().parent.parent / "configs" / "config.yaml")
    assert tcfg.flagship_config() == tcfg.load_config(path)
    j = jcfg.load_config(path)
    assert tcfg.flagship_config().model.lgan.z_dim == j.model.lgan.z_dim == 8
    with pytest.raises(ValueError, match="gate_mode"):
        tcfg.ModelConfig(gate_mode="bogus")


# ---------------------------------------------------------------------------
# nn
# ---------------------------------------------------------------------------


def test_nn_layers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7).astype(np.float32)
    dense = {"w": rng.randn(7, 6).astype(np.float32),
             "b": rng.randn(6).astype(np.float32)}
    close(tnn.dense({k: t(v) for k, v in dense.items()}, t(x)),
          jnn.dense_apply(dense, x), 1e-5)
    bn_p = {"scale": rng.rand(7).astype(np.float32) + 0.5,
            "bias": rng.randn(7).astype(np.float32)}
    bn_s = {"mean": rng.randn(7).astype(np.float32),
            "var": rng.rand(7).astype(np.float32) + 0.5}
    ref, _ = jnn.batchnorm_apply(bn_p, bn_s, x, training=False)
    close(tnn.batchnorm_eval({k: t(v) for k, v in bn_p.items()},
                             {k: t(v) for k, v in bn_s.items()}, t(x)),
          ref, 1e-5)
    close(tnn.layernorm({k: t(v) for k, v in bn_p.items()}, t(x)),
          jnn.layernorm_apply(bn_p, x), 1e-5)
    sn = jax.tree.map(np.asarray,
                      jnn.spectral_norm_init(jax.random.PRNGKey(1), (7, 6)))
    ref, _ = jnn.spectral_norm_apply(dense["w"], sn, training=False)
    close(tnn.spectral_norm_eval(t(dense["w"]), {k: t(v) for k, v in sn.items()}),
          ref, 1e-5)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    config, tree = small_model_tree(seed=0, gan_path=True)
    return config, tree, model_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_autoencoder_matches_jax(small, masked):
    _, tree, model = small
    pc, mask = small_clouds()
    m = mask if masked else None
    ae_p, ae_s = tree["ae"]["params"], tree["ae"]["state"]
    ref_gfv, _ = jae.encoder_apply(ae_p["encoder"], ae_s["encoder"], pc, m)
    gfv = tae.encoder_apply(model["ae"]["params"]["encoder"],
                            model["ae"]["state"]["encoder"], t(pc),
                            None if m is None else t(m))
    close(gfv, ref_gfv, 1e-5)
    ref_pc, _ = jae.decoder_apply(ae_p["decoder"], ae_s["decoder"], ref_gfv)
    out = tae.decoder_apply(model["ae"]["params"]["decoder"],
                            model["ae"]["state"]["decoder"], t(ref_gfv))
    assert out.shape == (3, N_POINTS, 3)
    close(out, ref_pc, 1e-5)


@pytest.mark.parametrize("spectral_norm", [True, False])
def test_latent_gan_matches_jax(spectral_norm):
    cfg = small_config().model.lgan
    p, s = jlg.lgan_init(jax.random.PRNGKey(3), cfg.z_dim, cfg.latent_dim,
                         cfg.generator_dims, cfg.discriminator_dims,
                         spectral_norm=spectral_norm)
    rng = np.random.RandomState(3)
    p = _randomise_norms(jax.tree.map(np.asarray, p), rng)
    s = _randomise_norms(jax.tree.map(np.asarray, s), rng)
    tp = jax.tree.map(t, p)
    ts = jax.tree.map(t, s)
    z = rng.randn(4, cfg.z_dim).astype(np.float32)
    ref, _ = jlg.generator_apply(p["generator"], s["generator"], z)
    close(tlg.generator_apply(tp["generator"], ts["generator"], t(z))[0], ref,
          1e-5)
    gfv = np.tanh(rng.randn(4, cfg.latent_dim)).astype(np.float32)
    ref, _ = jlg.discriminator_apply(p["discriminator"], s["discriminator"],
                                     gfv)
    # scores reach ~30: f32 rounding is relative
    close(tlg.discriminator_apply(tp["discriminator"], ts["discriminator"],
                                  t(gfv))[0], ref, 1e-5, rtol=1e-5)


def test_select_action_matches_jax_with_shared_noise(small):
    config, tree, model = small
    jcfg_td3 = config.td3_config()
    pcfg = port_small_config().td3_config()
    s = np.random.RandomState(1).randn(3, 32).astype(np.float32)
    ref, _ = jrl.select_action(tree["agent"], s, jcfg_td3, add_noise=False)
    a, _ = trl.select_action(model["agent"], t(s), pcfg)
    close(a, ref, 1e-5)
    # OU noise: the same standard-normal draw on both sides
    key = jax.random.PRNGKey(7)
    ou = np.full((3, 4), 0.1, np.float32)
    ref, ref_ou = jrl.select_action(tree["agent"], s, jcfg_td3, key=key,
                                    ou_state=ou, add_noise=True)
    normal = np.asarray(jax.random.normal(key, ou.shape))
    a, new_ou = trl.select_action(model["agent"], t(s), pcfg, ou_state=t(ou),
                                  add_noise=True, normal=t(normal))
    close(new_ou, ref_ou, 1e-6)
    close(a, ref, 1e-5)
    # a generator draws the noise when none is given
    a1, _ = trl.select_action(model["agent"], t(s), pcfg, ou_state=t(ou),
                              add_noise=True,
                              generator=torch.Generator().manual_seed(0))
    a2, _ = trl.select_action(model["agent"], t(s), pcfg, ou_state=t(ou),
                              add_noise=True,
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(a1, a2) and float(a1.abs().max()) <= 1.0


@pytest.mark.parametrize("gate_mode", GATE_MODES)
@pytest.mark.parametrize("with_gan_path", [False, True])
def test_complete_matches_jax(small, gate_mode, with_gan_path):
    config, tree, model = small
    if not with_gan_path:
        tree = {k: v for k, v in tree.items() if k != "gan_path"}
        model = {k: v for k, v in model.items() if k != "gan_path"}
    pc, mask = small_clouds(seed=2)
    ref = jnet.complete(tree, pc, mask, cfg=config.td3_config(),
                        gate_mode=gate_mode, gate_bias=0.01)
    out = tnet.complete(model, t(pc), t(mask),
                        cfg=port_small_config().td3_config(),
                        gate_mode=gate_mode, gate_bias=0.01)
    assert set(out) == set(ref)
    for k in ref:
        # discriminator scores are O(1-10): their f32 rounding is relative
        close(out[k], ref[k], 1e-5, rtol=1e-5)


def test_complete_rejects_bad_gate_mode(small):
    _, _, model = small
    pc, mask = small_clouds()
    with pytest.raises(ValueError, match="invalid gate_mode"):
        tnet.complete(model, t(pc), t(mask), gate_mode="bogus")


def test_model_from_numpy_keeps_serving_subtrees(small):
    _, tree, model = small
    assert set(model) == {"ae", "lgan", "agent", "gan_path"}
    assert set(model["agent"]) == {"actor"}
    w = model["ae"]["params"]["encoder"]["point_mlp"][0]["dense"]["w"]
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    np.testing.assert_array_equal(
        w.numpy(), tree["ae"]["params"]["encoder"]["point_mlp"][0]["dense"]["w"])


# ---------------------------------------------------------------------------
# data, ply, gate sidecar
# ---------------------------------------------------------------------------


def test_loaders_and_ply_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    pts = rng.randn(50, 3).astype(np.float32)
    np.savetxt(tmp_path / "c.txt", pts)
    jply.save_ply(str(tmp_path / "j.ply"), pts)
    tply.save_ply(str(tmp_path / "t.ply"), pts)
    assert (tmp_path / "j.ply").read_text() == (tmp_path / "t.ply").read_text()
    for name in ("c.txt", "t.ply"):
        np.testing.assert_array_equal(
            tdataset.load_point_cloud(str(tmp_path / name)),
            jdataset.load_point_cloud(str(tmp_path / name)))
    for n_points in (32, 80):
        a = tdataset.resample_with_mask(pts, n_points, np.random.RandomState(1))
        b = jdataset.resample_with_mask(pts, n_points, np.random.RandomState(1))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="unsupported"):
        tdataset.load_point_cloud(str(tmp_path / "c.obj"))


def test_load_h5_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    pts = np.random.RandomState(2).randn(40, 3).astype(np.float32)
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f["points"] = pts
    np.testing.assert_array_equal(
        tdataset.load_point_cloud(str(tmp_path / "c.h5")),
        jdataset.load_point_cloud(str(tmp_path / "c.h5")))


@pytest.mark.parametrize("sidecar,checkpoint", [
    (None, None),
    ({"gate_mode": "rl", "gate_bias": 0.3}, None),
    ({"gate_mode": "rl", "gate_bias": 0.3, "checkpoint_s": 1}, "x"),
    ({"gate_mode": "ae", "gate_bias": -0.1, "checkpoints": ["final"]}, "final"),
    ({"gate_mode": "ae", "gate_bias": -0.1, "checkpoints": ["final"]}, "best"),
    ({"gate_mode": "ae", "gate_bias": -0.1, "checkpoints": ["final"]}, None),
    ("not json", None),
])
def test_gate_calibration_matches_jax(tmp_path, sidecar, checkpoint):
    assert tgate.GATE_FILE == jgate.GATE_FILE
    if sidecar is not None:
        text = sidecar if isinstance(sidecar, str) else json.dumps(sidecar)
        (tmp_path / tgate.GATE_FILE).write_text(text)
    kw = dict(checkpoint=checkpoint, default_mode="discriminator",
              default_bias=0.05)
    assert (tgate.load_gate_calibration(str(tmp_path), **kw)
            == jgate.load_gate_calibration(str(tmp_path), **kw))
