"""Port parity for the attention encoder and the adaptive decoder
(gan_rl_3d_tpu/models/variants.py) and the model family they make: each
network in eval and training mode (both BN statistics modes), padded
clouds, fewer points than the generator's maximum, the dispatch by tree
structure, ``complete`` in every gate mode, the engine fold's refusal,
the bf16_selective cast, and tests/test_variant_pipeline.py run on the
port. Against the JAX package on the same numpy weights and inputs; CPU,
small widths. The helpers at the top are shared with
tests/test_torch_port_variants_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu import nn as jnn
from gan_rl_3d_tpu.models import autoencoder as jae
from gan_rl_3d_tpu.models import inference as jinf
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu.models import variants as jvar
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch.convert import model_from_numpy
from gan_rl_3d_tpu_torch.models import autoencoder as tae
from gan_rl_3d_tpu_torch.models import inference as tinf
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.models import variants as tvar
from gan_rl_3d_tpu_torch.ops import pointcloud as tpc
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_lgan import close_scaled
from test_torch_port_modules import (GATE_MODES, N_POINTS, SMALL,
                                     _randomise_norms, small_clouds, t)

TOL = 1e-5  # scaled by max(1, |ref|)
VARIANT = {"encoder_type": "attention", "decoder_type": "adaptive"}
SMALL_VARIANT = {"model": {**SMALL["model"], "autoencoder": {
    **SMALL["model"]["autoencoder"], **VARIANT}}}
ENC_DIMS = SMALL["model"]["autoencoder"]["encoder_dims"]
LATENT = SMALL["model"]["autoencoder"]["latent_dim"]


def variant_config():
    return jcfg.load_config(None, overrides=SMALL_VARIANT)


def port_variant_config():
    return tcfg.load_config(None, overrides=SMALL_VARIANT)


def variant_model_tree(seed=0):
    """The JAX model tree (numpy leaves) of the variant family at SMALL
    widths, with non-trivial BN statistics and norm parameters."""
    config = variant_config()
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray,
                        jnet.init_model(jax.random.PRNGKey(seed), config))
    for k in ("ae", "lgan"):
        tree[k] = _randomise_norms(tree[k], rng)
    tree["agent"]["actor"] = _randomise_norms(tree["agent"]["actor"], rng)
    return config, tree


def _networks(seed, max_points=N_POINTS):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    rng = np.random.RandomState(seed)
    enc = [_randomise_norms(jax.tree.map(np.asarray, x), rng)
           for x in jvar.attention_encoder_init(k1, 3, LATENT, ENC_DIMS)]
    dec = [_randomise_norms(jax.tree.map(np.asarray, x), rng)
           for x in jvar.adaptive_decoder_init(k2, LATENT, max_points)]
    return enc, dec


def varied_clouds(seed, bsz=8, n=N_POINTS, n_valid=200):
    """Clouds of per-cloud extent and offset, and a mask of ``n_valid``
    points: the weighted pool averages over the points, so iid clouds of
    one extent pool to nearly one feature and a training BN over the batch
    would divide by that rounding-level spread."""
    rng = np.random.RandomState(seed)
    pc = (rng.randn(bsz, n, 3) * rng.uniform(0.3, 1.0, (bsz, 1, 3))
          + rng.uniform(-0.3, 0.3, (bsz, 1, 3))).astype(np.float32)
    mask = np.zeros((bsz, n), np.float32)
    mask[:, :n_valid] = 1.0
    return pc, mask


def _close_trees(port, ref, tol):
    port_l, ref_l = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_l) == len(ref_l)
    for a, b in zip(port_l, ref_l):
        close_scaled(a, b, tol)


@pytest.mark.parametrize("training,bn_stats", [
    (False, "centered"), (True, "centered"), (True, "single_read_grouped")])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_encoder_matches_jax(training, bn_stats, masked):
    (p, s), _ = _networks(seed=1)
    pc, mask = varied_clouds(seed=2)
    m = mask if masked else None
    with jnn.bn_stats_mode(bn_stats):
        ref, ref_s = jvar.attention_encoder_apply(
            p, s, jnp.asarray(pc), None if m is None else jnp.asarray(m),
            training=training)
    gfv, new_s = tvar.attention_encoder_apply(
        tree_map(t, p), tree_map(t, s), t(pc), None if m is None else t(m),
        training=training, bn_stats=bn_stats)
    close_scaled(gfv, ref, TOL)
    _close_trees(new_s, ref_s, TOL)


def test_attention_encoder_gives_padded_points_no_weight():
    """tests/test_variants.py:11-30 on the port: a cloud padded with far
    junk points under a mask of zeros gives its unpadded twin's GFV, and
    JAX's."""
    (p, s), _ = _networks(seed=3)
    pc, _ = small_clouds(seed=4, bsz=4, n=200)
    padded = np.concatenate([pc, np.full((4, 56, 3), 50.0, np.float32)], 1)
    mask = np.concatenate([np.ones((4, 200)), np.zeros((4, 56))],
                          1).astype(np.float32)
    tp, ts = tree_map(t, p), tree_map(t, s)
    g_masked, _ = tvar.attention_encoder_apply(tp, ts, t(padded), t(mask))
    g_clean, _ = tvar.attention_encoder_apply(tp, ts, t(pc))
    np.testing.assert_allclose(g_masked.numpy(), g_clean.numpy(), rtol=1e-4,
                               atol=1e-4)
    ref, _ = jvar.attention_encoder_apply(p, s, jnp.asarray(padded),
                                          jnp.asarray(mask))
    close_scaled(g_masked, ref, TOL)


@pytest.mark.parametrize("training,bn_stats", [
    (False, "centered"), (True, "centered"), (True, "single_read_grouped")])
@pytest.mark.parametrize("num_points", [None, 100])
def test_adaptive_decoder_matches_jax(training, bn_stats, num_points):
    """The feature MLP, the tanh generator, the slice to ``num_points``
    and the refinement, whose training BN sees (B * num_points, 64) rows."""
    _, (p, s) = _networks(seed=5)
    gfv = np.random.RandomState(6).randn(8, LATENT).astype(np.float32)
    with jnn.bn_stats_mode(bn_stats):
        ref, ref_s = jvar.adaptive_decoder_apply(
            p, s, jnp.asarray(gfv), num_points=num_points, training=training)
    out, new_s = tvar.adaptive_decoder_apply(
        tree_map(t, p), tree_map(t, s), t(gfv), num_points=num_points,
        training=training, bn_stats=bn_stats)
    assert out.shape == (8, num_points or N_POINTS, 3)
    close_scaled(out, ref, TOL)
    _close_trees(new_s, ref_s, TOL)
    with pytest.raises(ValueError, match="max_points"):
        tvar.adaptive_decoder_apply(tree_map(t, p), tree_map(t, s), t(gfv),
                                    num_points=N_POINTS + 1)


def test_variant_inits_have_the_jax_layout_and_draw_from_the_generator():
    """autoencoder_init builds either family with JAX's tree structure and
    shapes (the adaptive decoder ignores decoder_dims and has no
    num_points*3 check); a seed gives the same weights, another seed
    others; unknown types are refused."""
    a = SMALL["model"]["autoencoder"]
    args = (3, a["latent_dim"], N_POINTS, a["encoder_dims"], (7, 9, 11))
    ref = jae.autoencoder_init(jax.random.PRNGKey(0), *args, **VARIANT)
    port = tae.autoencoder_init(torch.Generator().manual_seed(0), *args,
                                **VARIANT)
    assert (jax.tree.structure(jax.tree.map(np.asarray, ref))
            == jax.tree.structure(tree_map(lambda v: v.numpy(), port)))
    for x, y in zip(tree_leaves(port), jax.tree.leaves(ref)):
        assert tuple(x.shape) == y.shape and x.dtype == torch.float32
    again = tae.autoencoder_init(torch.Generator().manual_seed(0), *args,
                                 **VARIANT)
    other = tae.autoencoder_init(torch.Generator().manual_seed(1), *args,
                                 **VARIANT)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(port),
                                                 tree_leaves(again)))
    assert not torch.equal(port[0]["encoder"]["attention"]["fc1"]["w"],
                           other[0]["encoder"]["attention"]["fc1"]["w"])
    for bad in ({"encoder_type": "bogus"}, {"decoder_type": "bogus"}):
        with pytest.raises(ValueError, match="unknown"):
            tae.autoencoder_init(torch.Generator(), **bad)


def _pointnet_ae(seed):
    """The PointNet / MLP autoencoder (params, state) at SMALL widths."""
    return jax.tree.map(np.asarray, jae.autoencoder_init(
        jax.random.PRNGKey(seed), 3, LATENT, N_POINTS, ENC_DIMS,
        SMALL["model"]["autoencoder"]["decoder_dims"]))


def _with_halves(tree, plain, encoder, decoder):
    """``tree`` with its encoder and/or decoder taken from ``plain``."""
    ae_p, ae_s = dict(tree["ae"]["params"]), dict(tree["ae"]["state"])
    for half, take in (("encoder", encoder), ("decoder", decoder)):
        if take:
            ae_p[half], ae_s[half] = plain[0][half], plain[1][half]
    return dict(tree, ae={"params": ae_p, "state": ae_s})


@pytest.mark.parametrize("family", ["variant", "mixed"])
def test_autoencoder_dispatches_by_tree_structure(family):
    """autoencoder_apply on either family, and on a mixed pair (attention
    encoder, MLP decoder), matches JAX in training mode; eval-mode
    encoder_apply / decoder_apply dispatch too."""
    _, tree = variant_model_tree(seed=7)
    if family == "mixed":
        tree = _with_halves(tree, _pointnet_ae(8), False, True)
    p, s = tree["ae"]["params"], tree["ae"]["state"]
    pc, mask = varied_clouds(seed=9)
    (ref_rec, ref_gfv), ref_s = jae.autoencoder_apply(
        p, s, jnp.asarray(pc), jnp.asarray(mask), training=True)
    (rec, gfv), new_s = tae.autoencoder_apply(
        tree_map(t, p), tree_map(t, s), t(pc), t(mask), training=True)
    close_scaled(gfv, ref_gfv, TOL)
    close_scaled(rec, ref_rec, TOL)
    _close_trees(new_s, ref_s, TOL)
    gfv_eval = tae.encoder_apply(tree_map(t, p["encoder"]),
                                 tree_map(t, s["encoder"]), t(pc), t(mask))
    ref_eval, _ = jae.any_encoder_apply(p["encoder"], s["encoder"],
                                        jnp.asarray(pc), jnp.asarray(mask))
    close_scaled(gfv_eval, ref_eval, TOL)
    rec_eval = tae.decoder_apply(tree_map(t, p["decoder"]),
                                 tree_map(t, s["decoder"]), gfv_eval)
    ref_rec_eval, _ = jae.any_decoder_apply(p["decoder"], s["decoder"],
                                            ref_eval)
    close_scaled(rec_eval, ref_rec_eval, TOL)


@pytest.fixture(scope="module")
def variant_small():
    return variant_model_tree(seed=11)


@pytest.mark.parametrize("gate_mode", GATE_MODES)
def test_complete_matches_jax_with_the_variants(variant_small, gate_mode):
    """The serving ``complete`` of the variant family, every output key,
    on a padded batch."""
    config, tree = variant_small
    pc, mask = small_clouds(seed=12)
    ref = jnet.complete(jax.tree.map(jnp.asarray, tree), jnp.asarray(pc),
                        jnp.asarray(mask), cfg=config.td3_config(),
                        gate_mode=gate_mode)
    out = tnet.complete(model_from_numpy(tree, device="cpu"), t(pc), t(mask),
                        cfg=port_variant_config().td3_config(),
                        gate_mode=gate_mode)
    assert set(out) == set(ref)
    for k in ref:
        close_scaled(out[k], ref[k], TOL)


def test_the_variants_do_not_fold_into_an_engine(variant_small):
    """prepare_inference_engine refuses either variant with ValueError, as
    the JAX package's does (inference.py:99-108)."""
    _, tree = variant_small
    plain = _pointnet_ae(0)
    # (the attention encoder with the MLP decoder, the PointNet encoder
    # with the adaptive decoder, both variants)
    for mixed, what in ((_with_halves(tree, plain, False, True), "attention"),
                        (_with_halves(tree, plain, True, False), "adaptive"),
                        (tree, "attention")):
        with pytest.raises(ValueError, match=what):
            jinf.prepare_inference_engine(jax.tree.map(jnp.asarray, mixed))
        with pytest.raises(ValueError, match=what):
            tinf.prepare_inference_engine(model_from_numpy(mixed,
                                                           device="cpu"))


def test_bf16_selective_cast_of_the_variants_matches_jax(variant_small):
    """_policy_cast_ae_selective on the variant tree gives every leaf JAX's
    dtype: the adaptive decoder all bf16 (it has no ``mlp`` head to keep
    f32), the attention encoder's last point-MLP layer f32. Before the
    cast took JAX's guards it raised KeyError on the adaptive decoder."""
    _, tree = variant_small
    p = tree["ae"]["params"]
    ref = jsteps._policy_cast_ae_selective(jax.tree.map(jnp.asarray, p),
                                           jnp.bfloat16)
    port = tsteps._policy_cast_ae_selective(tree_map(t, p), torch.bfloat16)
    assert (jax.tree.structure(ref)
            == jax.tree.structure(tree_map(lambda v: 0, port)))
    dtypes = [str(a.dtype).replace("torch.", "") for a in tree_leaves(port)]
    assert dtypes == [str(b.dtype) for b in jax.tree.leaves(ref)]
    assert all(v.dtype == torch.bfloat16
               for v in tree_leaves(port["decoder"]))
    assert port["encoder"]["point_mlp"][-1]["dense"]["w"].dtype == \
        torch.float32
    assert port["encoder"]["attention"]["fc1"]["w"].dtype == torch.bfloat16


def test_variant_pipeline_runs_on_the_port():
    """tests/test_variant_pipeline.py on the port: a config-selected variant
    model (decoder_dims ignored by the adaptive decoder) completes finite
    clouds, ten AE steps lower the loss, and a joint step is finite."""
    n = 256
    overrides = {"model": {"autoencoder": {
        "num_points": n, "decoder_dims": [256, 256, n * 3], **VARIANT}}}
    config = tcfg.load_config(None, overrides=overrides)
    model = tnet.init_model(torch.Generator().manual_seed(0), config)
    assert "attention" in model["ae"]["params"]["encoder"]
    assert "feature_mlp" in model["ae"]["params"]["decoder"]
    pc = torch.randn(2, n, 3, generator=torch.Generator().manual_seed(1))
    out = tnet.complete(model, pc, cfg=config.td3_config())
    assert out["hybrid_output"].shape == (2, n, 3)
    assert torch.isfinite(out["hybrid_output"]).all()

    params = tree_map(lambda v: v.requires_grad_(True),
                      model["ae"]["params"])
    state = model["ae"]["state"]
    opt, sched = tsteps.make_ae_optimizer(params,
                                          config.training.autoencoder, 10)
    batch = {"complete_pc": pc, "pad": torch.zeros(2)}
    gen = torch.Generator().manual_seed(2)
    losses = []
    for _ in range(10):
        draws = tpc.draw_training_batch(gen, 2, n)
        state, m = tsteps.ae_train_step(params, state, opt, batch, draws,
                                        scheduler=sched, augment=False)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]

    model["ae"] = {"params": params, "state": state}
    trainable = tsteps.joint_trainable(model)
    for v in tree_leaves(trainable):
        v.requires_grad_(True)
    jopt = tsteps.make_joint_optimizer(trainable, config.training.joint)
    _, jm = tsteps.joint_train_step(model, jopt, batch,
                                    tpc.draw_training_batch(gen, 2, n),
                                    cfg=config.td3_config())
    assert np.isfinite(float(jm["loss"]))
