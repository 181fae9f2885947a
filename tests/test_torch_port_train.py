"""Port parity for the parts of the autoencoder training phase: training
BatchNorm, the AE in training mode, the Chamfer gradient (K3 forward,
K4/K5 backward; the JAX side's Pallas kernels in interpret mode), the
transforms given the draws JAX made, the optimizer and its schedules, the
batch plan and the config's training block. CPU, small widths (N=256,
B=8). Whole steps and the CLI are in tests/test_torch_port_train_steps.py,
which shares the helpers here."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu import nn as jnn
from gan_rl_3d_tpu.data import dataset as jdataset
from gan_rl_3d_tpu.models import autoencoder as jae
from gan_rl_3d_tpu.ops import chamfer as jchamfer
from gan_rl_3d_tpu.ops import pointcloud as jpc
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch import nn as tnn
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.models import autoencoder as tae
from gan_rl_3d_tpu_torch.ops import _cuda
from gan_rl_3d_tpu_torch.ops import chamfer as tchamfer
from gan_rl_3d_tpu_torch.ops import pointcloud as tpc
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_modules import N_POINTS, SMALL, _randomise_norms, close, t

ROOT = Path(__file__).resolve().parent.parent
B = 8
AE = SMALL["model"]["autoencoder"]


def leaf_tensors(tree):
    """Numpy tree -> f32 leaf tensors that take a gradient."""
    return tree_map(lambda x: t(x).requires_grad_(True), tree)


def small_ae(seed=0):
    """JAX AE params and BN state (numpy) at the SMALL widths."""
    p, s = jae.autoencoder_init(jax.random.PRNGKey(seed), 3, AE["latent_dim"],
                                N_POINTS, AE["encoder_dims"],
                                AE["decoder_dims"])
    rng = np.random.RandomState(seed)
    return (_randomise_norms(jax.tree.map(np.asarray, p), rng),
            _randomise_norms(jax.tree.map(np.asarray, s), rng))


def clouds(seed, bsz=B, n=N_POINTS):
    rng = np.random.RandomState(seed)
    axes = rng.uniform(0.4, 1.0, (bsz, 1, 3))
    return (rng.randn(bsz, n, 3) * axes).astype(np.float32)


def assert_trees_close(port, ref, atol, rtol=0.0):
    port_l = tree_leaves(tree_map(lambda x: x.detach().numpy(), port))
    ref_l = jax.tree.leaves(ref)
    assert len(port_l) == len(ref_l)
    for a, b in zip(port_l, ref_l):
        close(a, b, atol, rtol)


# ---------------------------------------------------------------------------
# nn: training BatchNorm, AE in training mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["centered", "single_read_grouped"])
@pytest.mark.parametrize("shape", [(8, 64, 5), (6, 64, 5), (16, 7)])
def test_training_batchnorm_matches_jax(mode, shape):
    """(6, ...) takes the grouped mode's % 8 fallback to centered."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 1.5 + 0.4).astype(np.float32)
    c = shape[-1]
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.randn(c).astype(np.float32)}
    s = {"mean": rng.randn(c).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    with jnn.bn_stats_mode(mode):
        ref, ref_s = jnn.batchnorm_apply(p, s, x, training=True)
    y, new_s = tnn.batchnorm_train(tree_map(t, p), tree_map(t, s), t(x),
                                   mode=mode)
    close(y, ref, 1e-6)
    for k in ("mean", "var"):
        close(new_s[k], ref_s[k], 1e-6)
    with pytest.raises(ValueError, match="bn_stats"):
        tnn.batchnorm_train(tree_map(t, p), tree_map(t, s), t(x), mode="x")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["centered", "single_read_grouped"])
def test_autoencoder_training_mode_matches_jax(masked, mode):
    p, s = small_ae(seed=1)
    pc = clouds(seed=2)
    mask = (np.arange(N_POINTS)[None, :]
            < np.random.RandomState(3).randint(100, N_POINTS, (B, 1))
            ).astype(np.float32) if masked else None
    with jnn.bn_stats_mode(mode):
        (ref_rec, ref_gfv), ref_s = jae.autoencoder_apply(
            p, s, pc, mask, training=True)
    (rec, gfv), new_s = tae.autoencoder_apply(
        tree_map(t, p), tree_map(t, s), t(pc),
        None if mask is None else t(mask), training=True, bn_stats=mode)
    close(gfv, ref_gfv, 1e-5)
    close(rec, ref_rec, 1e-5)
    assert_trees_close(new_s, ref_s, 1e-5)
    # eval mode returns the state it was given and matches encoder_apply
    ts = tree_map(t, s)
    (_, gfv_eval), same = tae.autoencoder_apply(tree_map(t, p), ts, t(pc))
    assert same["encoder"]["head"][0]["bn"] is ts["encoder"]["head"][0]["bn"]
    close(gfv_eval, tae.encoder_apply(tree_map(t, p["encoder"]),
                                      ts["encoder"], t(pc)), 0.0)


def test_init_shapes_match_jax_and_draw_from_the_generator():
    p, s = small_ae()
    tp, ts = tae.autoencoder_init(torch.Generator().manual_seed(0), 3,
                                  AE["latent_dim"], N_POINTS,
                                  AE["encoder_dims"], AE["decoder_dims"])
    assert ([x.shape for x in tree_leaves(tp)]
            == [tuple(x.shape) for x in jax.tree.leaves(p)])
    assert len(tree_leaves(ts)) == len(jax.tree.leaves(s))
    again, _ = tae.autoencoder_init(torch.Generator().manual_seed(0), 3,
                                    AE["latent_dim"], N_POINTS,
                                    AE["encoder_dims"], AE["decoder_dims"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                 tree_leaves(again)))
    w = tp["encoder"]["point_mlp"][1]["dense"]["w"]  # fan_in 16: |w| <= 1/4
    assert float(w.abs().max()) <= 0.25 and float(w.abs().max()) > 0.2


# ---------------------------------------------------------------------------
# Chamfer gradient: K3 forward, K4 / K5 backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masks", ["none", "b", "both"])
def test_chamfer_gradient_matches_jax(masks):
    rng = np.random.RandomState(4)
    a = rng.rand(2, N_POINTS, 3).astype(np.float32)
    b = rng.rand(2, N_POINTS, 3).astype(np.float32)
    b[0, 5] = a[0, 7]  # a pair at distance 0: the dist > 1e-6 guard
    a_mask = b_mask = None
    if masks in ("b", "both"):
        b_mask = (rng.rand(2, N_POINTS) > 0.3).astype(np.float32)
        b_mask[0, 5] = 1.0
    if masks == "both":
        a_mask = (rng.rand(2, N_POINTS) > 0.2).astype(np.float32)
    w = rng.rand(2).astype(np.float32)

    def loss(x, y):
        return jnp.sum(w * jchamfer.chamfer_distance(
            x, y, a_mask=None if a_mask is None else jnp.asarray(a_mask),
            b_mask=None if b_mask is None else jnp.asarray(b_mask)))

    ref_ga, ref_gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a),
                                                    jnp.asarray(b))
    ta, tb = t(a).requires_grad_(True), t(b).requires_grad_(True)
    before = dict(_cuda.launch_counts)
    (t(w) * tchamfer.chamfer_distance(
        ta, tb, a_mask=None if a_mask is None else t(a_mask),
        b_mask=None if b_mask is None else t(b_mask))).sum().backward()
    assert dict(_cuda.launch_counts) == before  # CPU: the plain versions
    scale = float(np.abs(ref_ga).max())
    close(ta.grad, ref_ga, 1e-6 * scale)
    close(tb.grad, ref_gb, 1e-6 * scale)
    if b_mask is not None:
        assert float(tb.grad[torch.from_numpy(b_mask) == 0].abs().max()) == 0
    # the zero-distance pair gets no gradient through that direction
    d, idx = tchamfer.nearest_distances(t(b[:1, 5:6]), t(a[:1]))
    assert int(idx) == 7 and float(d) == pytest.approx(1e-6)


def test_grad_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.RandomState(5)
    a, b = t(rng.rand(3, 50, 3)), t(rng.rand(3, 40, 3))
    dist, idx = tchamfer.nearest_distances_plain(a, b)
    g = t(rng.rand(3, 50))
    da = tchamfer.nearest_grad_a(a, b, idx, dist, g)
    assert torch.equal(da, tchamfer.nearest_grad_a_plain(a, b, idx, dist, g))
    db = tchamfer.nearest_grad_b(idx, da, 40)
    assert db.shape == (3, 40, 3)
    # db_j is minus the sum of the da_i whose nearest neighbour is j
    ref = np.zeros((3, 40, 3), np.float32)
    np.add.at(ref, (np.arange(3)[:, None], idx.numpy()), -da.numpy())
    close(db, ref, 1e-7)
    unchosen = np.ones((3, 40), bool)
    unchosen[np.arange(3)[:, None], idx.numpy()] = False
    assert (db.numpy()[unchosen] == 0).all()


# ---------------------------------------------------------------------------
# transforms, given the draws JAX made
# ---------------------------------------------------------------------------


def jax_draws(key, bsz, n, spec, methods=tpc.HOLE_METHODS):
    """The random numbers jpc.make_training_batch(key, ...) draws, by the
    same key splits (pointcloud.py:115-299), in the port's draws layout."""
    rows = []
    for k in jax.random.split(key, bsz):
        k_hole, k_aug, k_rot = jax.random.split(k, 3)
        k_ratio, k_method, k_rand, k_center, k_normal = jax.random.split(
            k_hole, 5)
        k1, k2, k3, _k4, k5, k6 = jax.random.split(k_aug, 6)
        rows.append({
            "ratio": jax.random.uniform(k_ratio, (), jnp.float32,
                                        spec.hole_min, spec.hole_max),
            "method": jax.random.randint(k_method, (), 0, len(methods)),
            "rand_scores": jax.random.uniform(k_rand, (n,)),
            "center": jax.random.randint(k_center, (), 0, n),
            "normal": jax.random.normal(k_normal, (3,)),
            "triggers": jnp.stack([jax.random.uniform(k1),
                                   jax.random.uniform(k2),
                                   jax.random.uniform(k3)]),
            "angles": jax.random.uniform(k_rot, (3,), jnp.float32, 0.0,
                                         2.0 * jnp.pi),
            "jitter": jax.random.normal(k5, (n, 3), jnp.float32),
            "scale": jax.random.uniform(k6, (), jnp.float32, 0.8, 1.2),
        })
    return {k: torch.from_numpy(np.stack([np.asarray(r[k]) for r in rows]))
            for k in rows[0]}


SPECS = {
    "default": jpc.PreprocSpec(),
    "deep_holes": jpc.PreprocSpec(hole_min=0.6, hole_max=0.9),  # 10 fill passes
    "no_aug_no_unit": jpc.PreprocSpec(rotation=False, jitter=False,
                                      unit_sphere=False),
}


@pytest.mark.parametrize("spec_name", list(SPECS))
def test_make_training_batch_matches_jax_given_its_draws(spec_name):
    spec = SPECS[spec_name]
    pc = clouds(seed=6)
    key = jax.random.PRNGKey(11)
    ref = jpc.make_training_batch(key, jnp.asarray(pc), spec=spec)
    port_spec = tpc.PreprocSpec(**jcfg.dataclasses.asdict(spec))
    draws = jax_draws(key, B, N_POINTS, spec)
    out = tpc.apply_training_batch(t(pc), draws, spec=port_spec)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    close(out[0], ref[0], 1e-5)
    close(out[1], ref[1], 1e-5)
    if spec_name == "deep_holes":
        assert tpc.fill_passes_for(N_POINTS, spec.hole_max) > 1


@pytest.mark.parametrize("method", ["random", "sphere", "plane"])
def test_cut_holes_matches_jax_for_each_method(method):
    spec = jpc.PreprocSpec(hole_min=0.3, hole_max=0.9)
    pc = clouds(seed=7)
    key = jax.random.PRNGKey(12)
    keys = jax.random.split(key, B)
    ref_pc, ref_mask = jax.vmap(lambda k, x: jpc.cut_holes(
        jax.random.split(k, 3)[0], x, min_ratio=spec.hole_min,
        max_ratio=spec.hole_max, methods=(method,)))(keys, jnp.asarray(pc))
    draws = jax_draws(key, B, N_POINTS, spec, methods=(method,))
    out_pc, out_mask = tpc.cut_holes(t(pc), draws, min_ratio=spec.hole_min,
                                     max_ratio=spec.hole_max,
                                     methods=(method,))
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(out_pc.numpy(), np.asarray(ref_pc))


def test_draws_are_reproducible_and_in_range():
    spec = tpc.PreprocSpec(hole_min=0.1, hole_max=0.4)
    d1 = tpc.draw_training_batch(torch.Generator().manual_seed(3), B, 64,
                                 spec=spec)
    d2 = tpc.draw_training_batch(torch.Generator().manual_seed(3), B, 64,
                                 spec=spec)
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert float(d1["ratio"].min()) >= 0.1 and float(d1["ratio"].max()) < 0.4
    assert set(d1["method"].tolist()) <= {0, 1}
    assert float(d1["angles"].max()) < 2 * np.pi
    assert d1["jitter"].shape == (B, 64, 3)
    with pytest.raises(ValueError, match="hole ratios"):
        tpc.draw_training_batch(torch.Generator(), B, 64,
                                spec=tpc.PreprocSpec(hole_max=0.99))
    one = t(clouds(seed=8, bsz=1))
    pair = tpc.make_training_pair(torch.Generator().manual_seed(4), one[0])
    batch = tpc.make_training_batch(torch.Generator().manual_seed(4), one)
    assert pair[1].shape == (N_POINTS, 3) and pair[2].shape == (N_POINTS,)
    assert all(torch.equal(x, y[0]) for x, y in zip(pair, batch))


# ---------------------------------------------------------------------------
# optimizer, batch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["step", "cosine"])
def test_ae_optimizer_matches_optax(schedule):
    cfg = dict(epochs=2, lr=1e-2, weight_decay=1e-3, scheduler_step=1,
               scheduler_gamma=0.5, lr_schedule=schedule)
    spe = 3
    rng = np.random.RandomState(8)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": [rng.randn(5).astype(np.float32)]}
    opt = jsteps.make_ae_optimizer(jcfg.AETrainConfig(**cfg), spe)
    ref, state = params, opt.init(params)
    port = leaf_tensors(params)
    topt, sched = tsteps.make_ae_optimizer(port, tcfg.AETrainConfig(**cfg),
                                           spe)
    for _ in range(2 * spe):
        grads = jax.tree.map(
            lambda x: rng.randn(*x.shape).astype(np.float32), params)
        updates, state = opt.update(grads, state, ref)
        ref = optax.apply_updates(ref, updates)
        for p, g in zip(tree_leaves(port), jax.tree.leaves(grads)):
            p.grad = t(g)
        topt.step()
        sched.step()
        assert_trees_close(port, ref, 1e-6)
    assert sched.get_last_lr()[0] == pytest.approx(
        1e-2 * (0.25 if schedule == "step" else 0.0), abs=1e-12)


@pytest.mark.parametrize("shuffle,n", [(True, 13), (False, 13), (True, 3)])
def test_epoch_indices_match_jax(shuffle, n):
    """13 rows at batch 4: a short last batch; 3 rows: smaller than one."""
    ds = list(range(n))  # the plan reads only len(dataset)
    ref = jdataset.BatchLoader(ds, 4, shuffle=shuffle, seed=3)
    port = tdataset.BatchLoader(ds, 4, shuffle=shuffle, seed=3)
    assert len(port) == len(ref)
    for _ in range(2):  # two epochs: the RNG stream carries over
        (i, p), (ri, rp) = port.epoch_indices(), ref.epoch_indices()
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(p, rp)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["defaults", "shipped_yaml"])
def test_training_config_matches_jax(source):
    path = str(ROOT / "configs" / "config.yaml")
    j = jcfg.load_config(path if source == "shipped_yaml" else None)
    p = tcfg.load_config(path) if source == "shipped_yaml" else tcfg.Config()
    if source == "shipped_yaml":
        assert tcfg.flagship_config() == p
    jt = jcfg.dataclasses.asdict(j.training)
    for k, v in jcfg.dataclasses.asdict(p.training).items():
        if k == "rl_agent":
            assert v["exploration_noise"] == jt[k]["exploration_noise"]
        elif k == "autoencoder":
            # the port's PCN recipe fields (staircase, alpha) have no JAX
            # counterpart
            assert set(v) - set(jt[k]) == {"decay_steps", "lr_floor",
                                           "alpha_boundaries",
                                           "alpha_values"}
            assert {kk: v[kk] for kk in jt[k]} == jt[k], k
        else:
            assert v == jt[k], k
    for section in ("loss", "data", "evaluation", "logging"):
        jd = jcfg.dataclasses.asdict(getattr(j, section))
        for k, v in jcfg.dataclasses.asdict(getattr(p, section)).items():
            assert v == jd[k], (section, k)
    assert (jcfg.dataclasses.asdict(j.preproc_spec())
            == jcfg.dataclasses.asdict(p.preproc_spec()))
    assert p.loss.bidirectional == j.loss.bidirectional
    with pytest.raises(ValueError, match="lr_schedule"):
        tcfg.AETrainConfig(lr_schedule="linear")
    with pytest.raises(ValueError, match="precision"):
        tcfg.TrainingConfig(precision="fp8")
