"""The port's train steps on the ("data", "model") mesh over gloo ranks,
held against the port in one process and against the JAX package's
8-device mesh (tests/test_sharding.py, case for case). The ranks run in
processes spawned by tests/torch_port_dist_worker.py, which imports no
JAX; this module computes the JAX side and the single-process reference.

Bounds. Against one process: the loss within 1e-5 relative at the first
step and 1e-4 after (the data group's sums run in another order); each
network's update (new - start) against the single run's in the 2-norm
over its parameters, within 1e-2 or 4 x what the single run's own update
moves when its input moves by one part in 10^7, where that is more
(``_update_tol``: Chamfer near-ties and ReLU kinks turn rounding into
larger steps); the leaves Adam makes noise of (``worker.adam_noise``:
their true gradient is 0) within 2 lr an update; the other state leaves
within 1e-4 (or 4 x that floor) of their largest element. A run with lr 0
must fail the update check. Against JAX's mesh: the bounds of the
existing single-device port-vs-JAX tests of each step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu import nn as jnn
from gan_rl_3d_tpu.data.dataset import BatchLoader as JBatchLoader
from gan_rl_3d_tpu.models import rl_agent as jrl
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu.ops import pointcloud as jpc
from gan_rl_3d_tpu.parallel import mesh as jmesh
from gan_rl_3d_tpu.train import replay_buffer as jrb
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch import nn as tnn
from gan_rl_3d_tpu_torch.data.dataset import BatchLoader
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves
from test_torch_port_lgan import jax_keep_masks
from test_torch_port_train import small_ae
from test_torch_port_train_steps import _step_inputs

import torch_port_dist_worker as worker

N_POINTS = 256
OVERRIDES = {
    "model": {"autoencoder": {"num_points": N_POINTS,
                              "decoder_dims": [256, 256, N_POINTS * 3]}},
}
RL_OVERRIDES = {**OVERRIDES, "model": {
    **OVERRIDES["model"], "rl_agent": {"batch_size": 16, "buffer_size": 256}}}
SPEC = jpc.PreprocSpec()
B = 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The one-process references run on one thread, as every rank does:
    torch's idle threads spin, which costs the whole host where the ranks
    and other test processes share its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def jax_model(overrides):
    """net.init_model(PRNGKey(0)) at ``overrides``' config, built once
    (jitted: one compile instead of one per eager op, the same bits)."""
    config = jcfg.load_config(None, overrides=overrides)
    key = repr(overrides)
    if key not in _MODELS:
        _MODELS[key] = jax.jit(jnet.init_model, static_argnums=1)(
            jax.random.PRNGKey(0), config)
    return config, _MODELS[key]


def _draws_np(draws):
    """The port's draws (tensors, lists, None) as numpy for the pickle."""
    if isinstance(draws, dict):
        return {k: _draws_np(v) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return [_draws_np(v) for v in draws]
    return None if draws is None else np.asarray(draws)


def _opt_fields(cfg):
    return dataclasses.asdict(cfg)


def _row_draws(k, n):
    """One row's draws of jpc.make_training_batch by its key splits
    (test_torch_port_train.jax_draws, vectorised over the rows)."""
    k_hole, k_aug, k_rot = jax.random.split(k, 3)
    k_ratio, k_method, k_rand, k_center, k_normal = jax.random.split(
        k_hole, 5)
    k1, k2, k3, _k4, k5, k6 = jax.random.split(k_aug, 6)
    return {
        "ratio": jax.random.uniform(k_ratio, (), jnp.float32, SPEC.hole_min,
                                    SPEC.hole_max),
        "method": jax.random.randint(k_method, (), 0, 2),
        "rand_scores": jax.random.uniform(k_rand, (n,)),
        "center": jax.random.randint(k_center, (), 0, n),
        "normal": jax.random.normal(k_normal, (3,)),
        "triggers": jnp.stack([jax.random.uniform(k1), jax.random.uniform(k2),
                               jax.random.uniform(k3)]),
        "angles": jax.random.uniform(k_rot, (3,), jnp.float32, 0.0,
                                     2.0 * jnp.pi),
        "jitter": jax.random.normal(k5, (n, 3), jnp.float32),
        "scale": jax.random.uniform(k6, (), jnp.float32, 0.8, 1.2)}


_batch_draws = jax.jit(jax.vmap(_row_draws, in_axes=(0, None)),
                       static_argnums=1)


def fast_draws(key, bsz, n):
    """jax_draws(key, bsz, n, SPEC) as numpy, in one compiled call."""
    out = _batch_draws(jax.random.split(key, bsz), n)
    return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# inputs, as tests/test_sharding.py builds them
# ---------------------------------------------------------------------------


def ae_inputs():
    """test_sharding's AE case (init_model(PRNGKey(0)), a batch of 16
    normal clouds, three steps of fold_in(PRNGKey(1), i)), started from
    Adam moments one step old (``_warm``)."""
    config, model = jax_model(OVERRIDES)
    key = jax.random.PRNGKey(1)
    keys = [jax.random.fold_in(key, i) for i in range(3)]
    d = {"params": _np(model["ae"]["params"]),
         "state": _np(model["ae"]["state"]),
         "batch": _normal_batch(key),
         "opt": _opt_fields(config.training.autoencoder),
         "steps_per_epoch": 10,
         "draws": [fast_draws(jax.random.split(k)[0], B, N_POINTS)
                   for k in keys]}
    warm = worker.ae_steps({"ae": {**d, "batch": _normal_batch(
        jax.random.PRNGKey(2)), "draws": d["draws"][:1]}}, None)
    return {**d, "params": warm["ae"]["params"],
            "state": warm["ae"]["state"], "moments": warm["moments"]}


def _normal_batch(key):
    return {"complete_pc": np.asarray(jax.random.normal(key,
                                                        (B, N_POINTS, 3))),
            "pad": np.zeros((B,), np.float32)}


def parity_inputs(recon_loss):
    """The inputs of test_three_f32_ae_train_steps_match_jax (its AE,
    batches with a padded row on odd steps, keys and cosine schedule):
    the port-vs-JAX AE bounds were set on them."""
    p, s = small_ae(seed=9)
    batches, keys = zip(*(_step_inputs(i) for i in range(3)))
    return batches, keys, {"recon_loss": recon_loss,
        "params": p, "state": s, "batches": list(batches), "augment": True,
        "opt": {"epochs": 2, "lr_schedule": "cosine"}, "steps_per_epoch": 2,
        "draws": [fast_draws(jax.random.split(k)[0], len(b["pad"]), N_POINTS)
                  for b, k in zip(batches, keys)]}


_PARITY8 = {}


def _jax_parity8(inputs, batches, keys, bn_stats):
    """jax_parity_run on the 8-device mesh, once per (loss, statistics)."""
    at = (inputs["recon_loss"], bn_stats)
    if at not in _PARITY8:
        _PARITY8[at] = jax_parity_run(inputs, batches, keys,
                                      jmesh.make_mesh(), bn_stats)
    return _PARITY8[at]


def jax_parity_run(inputs, batches, keys, mesh, bn_stats):
    """test_three_f32_ae_train_steps_match_jax's JAX trajectory, on
    ``mesh``."""
    opt = jsteps.make_ae_optimizer(jcfg.AETrainConfig(**inputs["opt"]),
                                   inputs["steps_per_epoch"])
    tree = jmesh.shard_model_for_mesh(
        mesh, {"ae": {"params": inputs["params"], "state": inputs["state"]}})
    p, s = tree["ae"]["params"], tree["ae"]["state"]
    o = jax.device_put(opt.init(inputs["params"]), jmesh.replicated(mesh))
    losses = []
    for b, k in zip(batches, keys):
        p, s, o, m = jsteps.ae_train_step(
            p, s, o, jmesh.shard_batch(mesh, jax.tree.map(jnp.asarray, b)), k,
            optimizer=opt, spec=SPEC, bn_stats=bn_stats,
            recon_loss=inputs["recon_loss"])
        losses.append(float(m["loss"]))
    return losses, _np(p)


def joint_inputs():
    """test_joint_step_tp4x2's case (init_model(PRNGKey(0)), 16 normal
    clouds, key PRNGKey(11)); and the same step from a model and Adam
    moments one step old."""
    config, model = jax_model(OVERRIDES)
    key = jax.random.PRNGKey(11)
    batch = _normal_batch(key)
    pcfg = tcfg.load_config(None, overrides=OVERRIDES)
    d = {"tree": _np({k: model[k] for k in ("ae", "lgan", "agent")}),
         "batch": batch, "lr": config.training.joint.lr,
         "td3": pcfg.td3_config(),
         "draws": fast_draws(jax.random.split(key)[0], B, N_POINTS)}
    warm = worker.joint_step({"joint": {**d, "batch": _normal_batch(
        jax.random.PRNGKey(12))}}, None)
    tree = {**d["tree"], **warm["tree"]}
    return config, model, batch, key, d, {**d, "tree": tree,
                                          "moments": warm["moments"]}


def jax_joint_run(config, model, batch, key, mesh):
    opt = jsteps.make_joint_optimizer(config.training.joint)
    b = jax.tree.map(jnp.asarray, batch)
    m = model
    if mesh is not None:
        m = jmesh.shard_model_for_mesh(mesh, model)
        b = jmesh.shard_batch(mesh, b)
    o = opt.init({"ae": m["ae"]["params"],
                  "gen": m["lgan"]["params"]["generator"]})
    m, o, metrics = jsteps.joint_train_step(m, o, b, key, optimizer=opt,
                                            cfg=config.td3_config())
    return float(metrics["loss"]), m


def lgan_draws(key, bsz, d_steps, z_dim, dims):
    """jsteps.lgan_combined_step(key)'s draws (steps.py:458-506)."""
    k_scan, k_g = jax.random.split(key)
    d = []
    for k in jax.random.split(k_scan, d_steps):
        k_z, k_real, k_fake, k_alpha, k_gp = jax.random.split(k, 5)
        d.append({"z": jax.random.normal(k_z, (bsz, z_dim)),
                  "keep_real": jax_keep_masks(k_real, bsz, dims),
                  "keep_fake": jax_keep_masks(k_fake, bsz, dims),
                  "alpha": jax.random.uniform(k_alpha, (bsz, 1), jnp.float32),
                  "keep_gp": jax_keep_masks(k_gp, bsz, dims)})
    k_z, k_drop = jax.random.split(k_g)
    return _draws_np({"d": d, "g": {"z": jax.random.normal(k_z, (bsz, z_dim)),
                                    "keep": jax_keep_masks(k_drop, bsz,
                                                           dims)}})


def lgan_inputs(d_steps=2, n_steps=2):
    """test_lgan_combined_step_dp8's case (d_steps 2, B 16, two steps),
    and its first step from networks and Adam moments one step old."""
    config, model = jax_model(OVERRIDES)
    key = jax.random.PRNGKey(3)
    real = np.asarray(jax.random.normal(key, (d_steps, B, 128)))
    m = config.model.lgan
    keys = [jax.random.fold_in(key, i) for i in range(n_steps)]
    d = {"params": _np(model["lgan"]["params"]),
         "state": _np(model["lgan"]["state"]),
         "opt": _opt_fields(config.training.lgan),
         "real": [real] * n_steps,
         "draws": [lgan_draws(k, B, d_steps, m.z_dim, m.discriminator_dims)
                   for k in keys]}
    warm_key = jax.random.PRNGKey(4)
    warm = worker.lgan_steps({"lgan": {
        **d, "real": [np.asarray(jax.random.normal(warm_key,
                                                   (d_steps, B, 128)))],
        "draws": [lgan_draws(warm_key, B, d_steps, m.z_dim,
                             m.discriminator_dims)]}}, None)
    nets = warm["nets"]
    return config, model, real, keys, d, {
        **d, "moments": warm["moments"], "real": d["real"][:1],
        "draws": d["draws"][:1],
        "params": {k: nets[k]["params"] for k in nets},
        "state": {k: nets[k]["state"] for k in nets}}


def jax_lgan_run(config, model, real, keys, mesh, d_steps=2):
    cfg = config.training.lgan
    d_opt = jsteps.make_gan_optimizer(cfg.discriminator_lr, cfg)
    g_opt = jsteps.make_gan_optimizer(cfg.generator_lr, cfg)
    lp, ls = model["lgan"]["params"], model["lgan"]["state"]
    r = jnp.asarray(real)
    if mesh is not None:
        lp = jax.device_put(lp, jmesh.replicated(mesh))
        ls = jax.device_put(ls, jmesh.replicated(mesh))
        r = jax.device_put(r, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "data")))
    d_o, g_o = d_opt.init(lp["discriminator"]), g_opt.init(lp["generator"])
    traj = []
    for k in keys:
        lp, ls, d_o, g_o, m = jsteps.lgan_combined_step(
            lp, ls, d_o, g_o, r, k, d_opt=d_opt, g_opt=g_opt,
            lambda_gp=cfg.lambda_gp, z_dim=config.model.lgan.z_dim,
            d_steps=d_steps)
        traj.append((float(m["d_loss"]), float(m["g_loss"])))
    return traj


def rl_inputs(n_iter=3):
    config, model = jax_model(RL_OVERRIDES)
    td3 = config.td3_config()
    key = jax.random.PRNGKey(7)
    batches = [{"complete_pc": np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (B, N_POINTS, 3))),
        "pad": np.zeros((B,), np.float32)} for i in range(n_iter)]
    keys = [jax.random.fold_in(key, 100 + i) for i in range(n_iter)]
    draws = []
    for i, k in enumerate(keys):
        k_data, k_scan, k_upd = jax.random.split(k, 3)
        k_s, k_u = jax.random.split(jax.random.split(k_upd, 1)[0])
        size_after = min(B * (i + 1), 256)
        draws.append(_draws_np({
            "holes": fast_draws(k_data, B, N_POINTS),
            "ou": np.stack([np.asarray(jax.random.normal(
                kk, (B, td3.action_dim))) for kk in jax.random.split(
                    k_scan, 1)]),
            "sample": np.asarray(jax.random.randint(
                k_s, (td3.batch_size,), 0, size_after))[None],
            "noise": np.asarray(jax.random.normal(
                k_u, (td3.batch_size, td3.action_dim)))[None]}))
    pcfg = tcfg.load_config(None, overrides=RL_OVERRIDES)
    d = {"tree": _np({k: model[k] for k in ("ae", "lgan", "agent")}),
         "td3": pcfg.td3_config(), "capacity": 256, "start": B,
         "batches": batches, "draws": draws}
    warm = dict(d["tree"], agent=worker.warm_agent(d["tree"]["agent"],
                                                   d["td3"]))
    return config, model, batches, keys, d, {**d, "tree": warm}


def jax_rl_run(config, model, batches, keys, mesh):
    td3 = config.td3_config()
    buffer = jrb.buffer_init(256, td3.state_dim, td3.action_dim)
    ou = jrl.ou_init(td3, (B,))
    m = model if mesh is None else jax.device_put(model,
                                                  jmesh.replicated(mesh))
    rewards = []
    for b, k in zip(batches, keys):
        b = jax.tree.map(jnp.asarray, b)
        if mesh is not None:
            b = jmesh.shard_batch(mesh, b)
        m, buffer, ou, metrics = jsteps.rl_step(m, buffer, ou, b, k, cfg=td3,
                                                start_training_size=B)
        rewards.append(float(metrics["reward"]))
    return rewards, buffer


def epoch_inputs(order, pads, seed=5):
    config, model = jax_model(OVERRIDES)
    data = np.asarray(jax.random.normal(jax.random.PRNGKey(9),
                                        (64, N_POINTS, 3)))
    return {"params": _np(model["ae"]["params"]),
            "state": _np(model["ae"]["state"]), "data": data,
            "order": np.asarray(order, np.int64),
            "pads": np.asarray(pads, np.float32),
            "opt": _opt_fields(config.training.autoencoder), "seed": seed}


class _FakeDS:
    def __len__(self):
        return 64


def _grouped_plan():
    loader = BatchLoader(_FakeDS(), 16, shuffle=True, seed=5,
                         shard_groups=mesh_lib.DATA_SHARD_GROUPS)
    order, pads = loader.epoch_indices()
    ref_order, ref_pads = JBatchLoader(
        _FakeDS(), 16, shuffle=True, seed=5,
        shard_groups=jmesh.DATA_SHARD_GROUPS).epoch_indices()
    np.testing.assert_array_equal(order, ref_order)
    np.testing.assert_array_equal(pads, ref_pads)
    return order, pads


# ---------------------------------------------------------------------------
# the spawns: one per world size, every case of that size in it
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    batches, keys, parity = parity_inputs("chamfer")
    jcase, lcase, rcase = joint_inputs(), lgan_inputs(), rl_inputs()
    order, pads = _grouped_plan()
    ae = ae_inputs()
    return {"parity": (batches, keys), "joint": jcase[:4],
            "lgan": lcase[:4], "rl": rcase[:4],
            "inputs": {"ae": ae, "parity": parity,
                       "parity_mse": parity_inputs("mse")[2],
                       **{f"ae_{mode}": {**ae, "starts": worker.ae_starts(
                           ae, mode)} for mode in tnn.BN_STATS_MODES},
                       "joint": jcase[4], "joint_warm": jcase[5],
                       "lgan": lcase[4], "lgan_warm": lcase[5],
                       "rl": rcase[4], "rl_warm": rcase[5],
                       "epoch": epoch_inputs(np.arange(32).reshape(2, 16),
                                             np.zeros((2, 16))),
                       "grouped": epoch_inputs(order, pads)}}


def _single(inputs, name, **kw):
    return worker.JOBS[name](inputs, None, **kw)


GROUPED = {"bn_stats": "single_read_grouped"}


def _forced(world_shape, mode, **kw):
    return ("ae_forced", world_shape,
            {"bn_stats": mode, "key": f"ae_{mode}", **kw})


def _forced_jobs(shape, suffix=""):
    return [(f"ae{suffix}_{mode}", *_forced(shape, mode))
            for mode in tnn.BN_STATS_MODES]


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """Every case in one spawn of 16 gloo ranks: a case's mesh takes the
    first ranks it needs (DP-2, DP-4, DP-8, 2x4, 4x2, 16). The 16-rank
    cases run first, so that ranks 8-15 then leave."""
    jobs = [("ae16", "ae_steps", (16, 1), {}),
            ("refused16", "bn_refusal", (16, 1), {}),
            *_forced_jobs((8, 1)), *_forced_jobs((2, 4), "_tp"),
            ("parity_grouped", "ae_steps", (8, 1),
             {"key": "parity", **GROUPED}),
            ("parity_mse", "ae_steps", (8, 1), {"key": "parity_mse"}),
            ("parity_tp_grouped", "ae_steps", (2, 4),
             {"key": "parity", **GROUPED}),
            ("joint_tp", "joint_step", (4, 2), {}),
            ("joint_tp_warm", "joint_step", (4, 2), {"key": "joint_warm"}),
            ("lgan", "lgan_steps", (8, 1), {}),
            ("lgan_warm", "lgan_steps", (8, 1), {"key": "lgan_warm"}),
            ("lgan_tp_warm", "lgan_steps", (4, 2), {"key": "lgan_warm"}),
            ("rl", "rl_steps", (8, 1), {}),
            ("rl_warm", "rl_steps", (8, 1), {"key": "rl_warm"}),
            ("epoch", "resident_epoch", (8, 1), {}),
            ("replicated", "resident_epoch", (8, 1), {"key": "grouped"}),
            ("sharded", "resident_epoch", (8, 1),
             {"key": "grouped", "sharded": True})]
    for world in (2, 4):
        jobs += _forced_jobs((world, 1), f"_dp{world}")
    jobs.append(("ae_lr0", *_forced((2, 1), "centered", lr=0.0)))
    return worker.spawn(16, tmp_path_factory.mktemp("dist16"),
                        cases["inputs"], jobs)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _check_losses(losses, ref, first=1e-5, after=1e-4):
    np.testing.assert_allclose(losses[:1], ref[:1], rtol=first)
    np.testing.assert_allclose(losses, ref, rtol=after)


def _scaled(batch_like):
    """A copy with every float array moved by one part in 10^7."""
    if isinstance(batch_like, dict):
        return {k: _scaled(v) for k, v in batch_like.items()}
    if isinstance(batch_like, list):
        return [_scaled(v) for v in batch_like]
    a = np.asarray(batch_like)
    return (a * np.float32(1 + 1e-7)).astype(a.dtype) if a.dtype.kind == "f" \
        and a.any() else a


def _update_tol(ref, start, moved) -> tuple:
    """(2-norm tolerance, state tolerance) of an update check: 1e-2 in the
    2-norm (the card-vs-CPU bound of card_checks) and 1e-4 of each state
    leaf, or 4 x what the one-process update itself moves when its input
    moves by one part in 10^7 (``moved``), where that is more."""
    _, _, state, norm = worker.update_errors(moved, ref, start)
    return max(1e-2, 4 * norm), max(1e-4, 4 * state)


def _check_update(new, ref, start, moved, lr, n_updates):
    """Each network's update (new - start) against the one-process one
    from the same start: the parameters that are not Adam noise in the
    2-norm, the Adam-noise leaves within 2 lr an update, the other state
    leaves (BN variances, spectral-norm vectors) relative to their own
    largest element."""
    tol, state_tol = _update_tol(ref, start, moved)
    _, noise, state, norm = worker.update_errors(new, ref, start)
    assert norm <= tol and noise <= 2 * lr * n_updates \
        and state <= state_tol, (norm, tol, noise, state, state_tol)


def _check_fails(frozen, ref, start, moved):
    """The update check reads a run at lr 0 as wrong."""
    tol, _ = _update_tol(ref, start, moved)
    assert worker.update_errors(frozen, ref, start)[3] > tol


def _ranks_agree(results, key):
    """Every rank holds the same result (it is replicated)."""
    for r in results[1:]:
        for a, b in zip(tree_leaves(r[key]), tree_leaves(results[0][key])):
            np.testing.assert_array_equal(a, b)


def _jax_sharded_paths(tree, mesh):
    placed = jmesh.shard_model_for_mesh(mesh, tree)
    return [leaf.sharding.spec != jax.sharding.PartitionSpec()
            for leaf in jax.tree.leaves(placed)]


def _forced_single(inputs, bn_stats, **kw):
    key = f"ae_{bn_stats}"
    d = inputs[key]
    run = _single(inputs, "ae_forced", bn_stats=bn_stats, key=key, **kw)
    moved = _single({key: {**d, "batch": _scaled(d["batch"])}}, "ae_forced",
                    bn_stats=bn_stats, key=key, **kw)
    return d, run, moved


def _check_forced(port, inputs, bn_stats):
    """Each step against the one-process step from the same state."""
    d, single, moved = _forced_single(inputs, bn_stats)
    _check_losses(port["losses"], single["losses"])
    for new, ref, mv, start in zip(port["steps"], single["steps"],
                                   moved["steps"], d["starts"]):
        _check_update(new, ref, start, mv, d["opt"]["lr"], 1)


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("bn_stats", ["centered", "single_read_grouped"])
def test_ae_steps_data_parallel_match_one_process(cases, runs, world,
                                                  bn_stats):
    """Three AE steps on DP-2 / 4 / 8 in both BN modes
    (test_ae_step_dp8_matches_single_device and its single_read BN twin)
    from Adam moments one step old, each held against the one-process
    step from the same state: a whole trajectory is chaotic at this
    random init (moving the batch by one part in 10^7 moves the third
    step's loss by 9e-5-2.2e-4 relative in one process), so rounding may
    not compound."""
    ranks = runs[f"ae{'' if world == 8 else f'_dp{world}'}_{bn_stats}"]
    assert len(ranks) == world
    _ranks_agree(ranks, "steps")
    _check_forced(ranks[0], cases["inputs"], bn_stats)


def test_ae_step_check_fails_at_lr_0(cases, runs):
    """The update check reads a DP-2 run at lr 0 as wrong."""
    d, single, moved = _forced_single(cases["inputs"], "centered")
    _check_fails(runs["ae_lr0"][0]["steps"][0], single["steps"][0],
                 d["starts"][0], moved["steps"][0])


PARITY = [("single_read_grouped", "parity", "parity_grouped", 1e-4, 1e-3),
          ("centered", "parity_mse", "parity_mse", 1e-5, 5e-4)]


@pytest.mark.parametrize("bn_stats,key,tag,loss_rtol,param_atol", PARITY)
def test_ae_steps_dp8_match_jax_mesh(cases, runs, bn_stats, key, tag,
                                     loss_rtol, param_atol):
    """The port's DP-8 trajectory (one row a rank) against JAX's on its
    8-device mesh, on the inputs and at the bounds of
    test_three_f32_ae_train_steps_match_jax: Chamfer with the
    single_read_grouped statistics it runs, and the MSE loss with the
    centered ones (the Chamfer loss's neighbour picks turn the centered
    statistics' rounding into a 1e-3 change by the third step, in either
    package alone)."""
    batches, keys = cases["parity"]
    losses, params = _jax_parity8(cases["inputs"][key], batches, keys,
                                  bn_stats)
    port = runs[tag][0]
    np.testing.assert_allclose(port["losses"], losses, rtol=loss_rtol)
    for a, b in zip(tree_leaves(port["ae"]["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_allclose(a, b, atol=param_atol)


@pytest.mark.parametrize("bn_stats", tnn.BN_STATS_MODES)
def test_ae_steps_2x4_tensor_parallel(cases, runs, bn_stats):
    """test_ae_step_mesh_2x4_matches_single_device: 2 data shards and the
    decoder head column-sharded 4 ways. The port shards the leaves JAX's
    shard_model_for_mesh does; each step holds to the port in one process
    as in the DP test; and with single_read_grouped (the statistics of
    test_three_f32_ae_train_steps_match_jax) the trajectory holds to JAX's
    on its mesh (the DP-8 run, which test_sharding holds to JAX's 2x4 run)
    at the 2x4 test's loss_rtol 2e-3, params 1e-3."""
    inputs = cases["inputs"]
    d = inputs["parity"]
    parity = runs["parity_tp_grouped"]
    jm = jmesh.make_mesh(n_data=2, n_model=4)
    assert tree_leaves(parity[0]["marked"]) == _jax_sharded_paths(
        {"ae": {"params": d["params"], "state": d["state"]}}, jm)
    assert any(tree_leaves(parity[0]["marked"]))
    if bn_stats == "single_read_grouped":
        batches, keys = cases["parity"]
        losses, params = _jax_parity8(d, batches, keys, bn_stats)
        np.testing.assert_allclose(parity[0]["losses"], losses, rtol=2e-3)
        for a, b in zip(tree_leaves(parity[0]["ae"]["params"]),
                        jax.tree.leaves(params)):
            np.testing.assert_allclose(a, b, atol=1e-3)
    ranks = runs[f"ae_tp_{bn_stats}"]
    _ranks_agree(ranks, "steps")
    _check_forced(ranks[0], inputs, bn_stats)


def _joint_nets(tree):
    return {"ae": tree["ae"], "generator": {
        "params": tree["lgan"]["params"]["generator"],
        "state": tree["lgan"]["state"]["generator"]}}


def test_joint_step_4x2_tensor_parallel(cases, runs):
    """test_joint_step_tp4x2_matches_single_device: one joint step on a
    4x2 mesh, the decoder head and the generator's 512-wide layers
    column-sharded: the leaves JAX's placement shards, the loss at JAX's
    2e-4 against its 4x2 run; from a model and moments one step old, the
    loss and each network's update against one process (lr 0 fails)."""
    config, model, batch, key = cases["joint"]
    inputs = cases["inputs"]
    port = runs["joint_tp"][0]
    jm = jmesh.make_mesh(n_data=4, n_model=2)
    assert tree_leaves(port["marked"]) == _jax_sharded_paths(
        {k: model[k] for k in ("ae", "lgan")}, jm)
    assert any(tree_leaves(port["marked"]))
    loss, _ = jax_joint_run(config, model, batch, key, jm)
    np.testing.assert_allclose(port["loss"], loss, rtol=2e-4)
    warm = runs["joint_tp_warm"]
    _ranks_agree(warm, "nets")
    d = inputs["joint_warm"]
    single = _single(inputs, "joint_step", key="joint_warm")
    moved = _single({"j": {**d, "batch": _scaled(d["batch"])}},
                    "joint_step", key="j")
    frozen = _single(inputs, "joint_step", key="joint_warm", lr=0.0)
    _check_losses([warm[0]["loss"]], [single["loss"]])
    start = _joint_nets(d["tree"])
    for net in start:
        _check_update(warm[0]["nets"][net], single["nets"][net], start[net],
                      moved["nets"][net], d["lr"], 1)
        _check_fails(frozen["nets"][net], single["nets"][net], start[net],
                     moved["nets"][net])


def test_lgan_combined_steps_dp8_match_jax_mesh(cases, runs):
    """test_lgan_combined_step_dp8_matches_single_device (d_steps 2, B 16,
    two steps): the losses at JAX's 2e-4 against its 8-device run."""
    config, model, real, keys = cases["lgan"]
    traj = jax_lgan_run(config, model, real, keys, jmesh.make_mesh())
    np.testing.assert_allclose(runs["lgan"][0]["traj"], traj, rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("tag", ["lgan_warm", "lgan_tp_warm"])
def test_lgan_combined_steps_match_one_process(cases, runs, tag):
    """The first step from networks and moments one step old, on DP-8 and
    on a 4x2 mesh (the generator's and the discriminator's 512-wide layers
    column-sharded; the spectral norm iterates on the gathered weight and
    the penalty's double backward crosses the column collectives): the
    losses at JAX's 2e-4 and each network's update against one process;
    lr 0 fails."""
    inputs = cases["inputs"]
    d = inputs["lgan_warm"]
    ranks = runs[tag]
    _ranks_agree(ranks, "nets")
    single = _single(inputs, "lgan_steps", key="lgan_warm")
    moved = _single({"l": {**d, "real": _scaled(d["real"])}}, "lgan_steps",
                    key="l")
    frozen = _single(inputs, "lgan_steps", key="lgan_warm", lr_scale=0.0)
    np.testing.assert_allclose(ranks[0]["traj"], single["traj"], rtol=2e-4,
                               atol=1e-5)
    lcfg = cases["lgan"][0].training.lgan
    lrs = {"generator": lcfg.generator_lr,
           "discriminator": lcfg.discriminator_lr}
    updates = {"generator": 1, "discriminator": 2}
    for net in lrs:
        start = {"params": d["params"][net], "state": d["state"][net]}
        _check_update(ranks[0]["nets"][net], single["nets"][net], start,
                      moved["nets"][net], lrs[net], updates[net])
        _check_fails(frozen["nets"][net], single["nets"][net], start,
                     moved["nets"][net])


def test_rl_steps_dp8(cases, runs):
    """test_rl_step_dp8_matches_single_device (3 iterations of 16
    environments, a TD3 update in each): the rewards at JAX's 2e-4
    against its 8-device run, and 48 rows in the ring. From an agent
    whose Adam is warm: the ring on every rank equal to the one-process
    ring, the OU state, and each network's update; lr 0 fails."""
    config, model, batches, keys = cases["rl"]
    inputs = cases["inputs"]
    rewards, jbuf = jax_rl_run(config, model, batches, keys,
                               jmesh.make_mesh())
    np.testing.assert_allclose(runs["rl"][0]["rewards"], rewards,
                               rtol=2e-4, atol=1e-5)
    assert int(jbuf.size) == 48
    ranks = runs["rl_warm"]
    d = inputs["rl_warm"]
    single = _single(inputs, "rl_steps", key="rl_warm")
    moved = _single({"r": {**d, "batches": _scaled(d["batches"])}},
                    "rl_steps", key="r")
    frozen = _single(inputs, "rl_steps", key="rl_warm", lr_scale=0.0)
    np.testing.assert_allclose(ranks[0]["rewards"], single["rewards"],
                               rtol=2e-4)
    for r in ranks:
        assert (r["size"], r["ptr"]) == (48, 48)
        # the actions of iterations 2-3 come from the actor after TD3
        # updates whose data differ by rounding: 1e-4 of their [-1, 1]
        for k in single["ring"]:
            np.testing.assert_allclose(r["ring"][k], single["ring"][k],
                                       rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(r["ou"], single["ou"], atol=1e-6)
    _ranks_agree(ranks, "agent")
    start = d["tree"]["agent"]
    lrs = {"actor": d["td3"].actor_lr, "critic1": d["td3"].critic_lr,
           "critic2": d["td3"].critic_lr}
    for net, lr in lrs.items():
        _check_update(ranks[0]["agent"][net], single["agent"][net],
                      start[net], moved["agent"][net], lr, 3)
        _check_fails(frozen["agent"][net], single["agent"][net], start[net],
                     moved["agent"][net])


def test_resident_epoch_keeps_data_parallelism(cases, runs):
    """test_resident_epoch_preserves_data_parallelism: under DP-8 each
    rank gathers only its slots' rows of the replicated split, and the
    epoch's losses match the one-process epoch's."""
    inputs = cases["inputs"]["epoch"]
    ranks = runs["epoch"]
    data, order = inputs["data"], inputs["order"]
    for r, res in enumerate(ranks):
        for s, taken in enumerate(res["taken"]):
            np.testing.assert_array_equal(
                taken, data[order[s]][2 * r:2 * (r + 1)])
    single = _single(cases["inputs"], "resident_epoch")
    _check_losses(ranks[0]["losses"], single["losses"])
    _ranks_agree(ranks, "ae")


def test_sharded_residency_matches_replicated(cases, runs):
    """test_sharded_residency_matches_replicated: the grouped plan's rows
    of every rank lie in its block of the row-sharded split, each rank
    takes the rows replicated residency takes, and the trajectory equals
    replicated residency's to JAX's 1e-6."""
    order = cases["inputs"]["grouped"]["order"]
    per_rank, rows = order.shape[1] // 8, 64 // 8
    for r in range(8):
        own = order[:, r * per_rank:(r + 1) * per_rank]
        assert own.min() >= r * rows and own.max() < (r + 1) * rows
    rep, sh = runs["replicated"][0], runs["sharded"][0]
    np.testing.assert_allclose(sh["losses"], rep["losses"], rtol=1e-6)
    for a, b in zip(tree_leaves(sh["ae"]), tree_leaves(rep["ae"])):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for res_sh, res_rep in zip(runs["sharded"], runs["replicated"]):
        for a, b in zip(res_sh["taken"], res_rep["taken"]):
            np.testing.assert_array_equal(a, b)


def test_sharded_residency_refuses_rows_outside_the_block():
    """A plan whose rows are not this rank's raises instead of clamping."""
    mesh = mesh_lib.Mesh({"data": 8, "model": 1}, rank=1, data_rank=1)
    data = torch.zeros(8, 4, 3)
    with mesh_lib.use(mesh):
        with pytest.raises(ValueError, match="outside this rank's block"):
            tsteps._resident_batch(data, torch.tensor([8, 16]), True)


def test_bn_guard_and_16_ranks_centered(cases, runs):
    """test_bn_mesh_guard_rejects_16_data_shards and
    test_centered_fallback_trains_equivalently_on_16_devices: the port's
    guard decides as JAX's, with its message, for 1-32 shards; on 16 ranks
    (one row each) single_read_grouped's BatchNorm refuses to split its
    groups, and the centered trajectory holds to the one-process run at
    JAX's 1e-2."""
    for shards in (1, 2, 4, 6, 8, 16, 32):
        for mode in tnn.BN_STATS_MODES:
            try:
                jnn.validate_bn_stats_mesh(mode, shards)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tnn.validate_bn_stats_mesh(mode, shards)
                assert str(got.value) == str(e)
            else:
                tnn.validate_bn_stats_mesh(mode, shards)
    assert len(runs["refused16"]) == 16
    assert all(r["refused"] for r in runs["refused16"])
    single = _single(cases["inputs"], "ae_steps")
    np.testing.assert_allclose(runs["ae16"][0]["losses"], single["losses"],
                               rtol=1e-2)
    _ranks_agree(runs["ae16"], "ae")
