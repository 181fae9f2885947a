"""Port parity for phase 5 (the joint fine-tune) and phase 5.5 (the D
refresh and the gate calibration): the joint step's gradients, state and
Adam with weight decay, the joint eval step, the gate statistics and the
threshold sweep, the gate sidecars and ``_ganpath`` siblings across both
packages, the ``preserve_gan_path`` snapshot, and the whole curriculum
through the CLI (``--phase full``, ``--phase joint``). Against the JAX
package on the same numpy weights and JAX's replayed draws; CPU, small
widths (tests/test_torch_port_modules.py), N=256."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu.ops import pointcloud as jpc
from gan_rl_3d_tpu.train import RLGANNetTrainer as JaxTrainer
from gan_rl_3d_tpu.train import gate as jgate
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu.utils import checkpoint as jckpt
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch.convert import model_from_numpy
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.ops import losses as tlosses
from gan_rl_3d_tpu_torch.ops import pointcloud as tpc
from gan_rl_3d_tpu_torch.train import gate as tgate
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
from gan_rl_3d_tpu_torch.train_rl_gan_net import main as train_main
from gan_rl_3d_tpu_torch.utils import checkpoint as tckpt
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_lgan import assert_update_close, close_scaled
from test_torch_port_modules import (N_POINTS, SMALL, port_small_config,
                                     small_config, small_model_tree, t)
from test_torch_port_train import clouds, jax_draws, leaf_tensors

B = 8
JCFG = small_config().td3_config()
PCFG = port_small_config().td3_config()
SPEC = jpc.PreprocSpec()
TSPEC = tpc.PreprocSpec()
IDENTITY = optax.identity()  # one object: the jitted step keys on it
PRECISIONS = {"float32": (None, None, False),
              "bf16_selective": (torch.bfloat16, jnp.bfloat16, True)}


def batch_of(seed):
    """A batch with its last row a wrap-around pad."""
    pad = np.zeros(B, np.float32)
    pad[-1] = 1.0
    return {"complete_pc": clouds(seed=seed), "pad": pad}


def port_model(tree):
    """The port's training model from a numpy tree: ae and lgan leaves
    that take a gradient, the actor for z."""
    model = model_from_numpy(tree, device="cpu")
    for k in ("ae", "lgan"):
        model[k] = {"params": leaf_tensors(tree[k]["params"]),
                    "state": tree_map(t, tree[k]["state"])}
    return model


def jax_trainable(tree, freeze):
    out = {"ae": tree["ae"]["params"]}
    if not freeze:
        out["gen"] = tree["lgan"]["params"]["generator"]
    return out


def run_jax_step(tree, optimizer, opt_state, batch, key, precision,
                 **kw):
    _, jdtype, selective = PRECISIONS[precision]
    return jsteps.joint_train_step(
        jax.tree.map(jnp.asarray, tree), opt_state,
        jax.tree.map(jnp.asarray, batch), key, optimizer=optimizer, cfg=JCFG,
        compute_dtype=jdtype, spec=SPEC, selective=selective, **kw)


def run_port_step(model, optimizer, batch, key, precision, **kw):
    """The port's step on JAX's draws of the same key."""
    dtype, _, selective = PRECISIONS[precision]
    k_data, _ = jax.random.split(key)
    return tsteps.joint_train_step(
        model, optimizer, tree_map(t, batch),
        jax_draws(k_data, B, N_POINTS, SPEC), cfg=PCFG, compute_dtype=dtype,
        spec=TSPEC, selective=selective, **kw)


# ---------------------------------------------------------------------------
# the joint step: gradients and state
# ---------------------------------------------------------------------------


def _port_grads(tree, batch, key, precision, **kw):
    """The port's gradients of one joint step (read from ``.grad``: an SGD
    with lr 0 leaves the parameters as they were), its metrics and new
    model."""
    model = port_model(tree)
    trainable = tsteps.joint_trainable(model, kw["freeze_generator"])
    opt = torch.optim.SGD(tree_leaves(trainable), lr=0.0)
    new, m = run_port_step(model, opt, batch, key, precision, **kw)
    return [v.grad.numpy().copy() for v in tree_leaves(trainable)], m, new


@functools.lru_cache(maxsize=None)
def _jax_grads_cached(seed, batch_seed, key_seed, precision, kw_items):
    _, tree = small_model_tree(seed=seed)
    return _jax_grads(tree, batch_of(batch_seed), jax.random.PRNGKey(key_seed),
                      precision, **dict(kw_items))


def _jax_grads(tree, batch, key, precision, **kw):
    """jax.grad of the JAX step's loss, read through the step itself: with
    optax.identity() it returns params + grads. Also its new model and
    metrics."""
    jm, _, jmet = run_jax_step(tree, IDENTITY, optax.EmptyState(), batch,
                               key, precision, **kw)
    freeze = kw["freeze_generator"]
    return ([np.asarray(a) - b for a, b in zip(
        jax.tree.leaves(jax_trainable(jm, freeze)),
        jax.tree.leaves(jax_trainable(tree, freeze)))], jm, jmet)


def _grad_err(grads, ref):
    """The largest error over all leaves, relative to the largest element."""
    assert len(grads) == len(ref)
    scale = max(float(np.abs(r).max()) for r in ref)
    return max(float(np.abs(g - r).max()) for g, r in zip(grads, ref)) / scale


# f32 gradients, port against JAX, relative to the largest element. Not
# 1e-4: at this random init the generator's outputs spread over the batch
# by under 0.05 a feature, and the decoder's training BatchNorm divides by
# that spread, so last-bit differences of the encoder reach the decoded
# cloud 10x or more enlarged (fed JAX's clean GFV, the port's decoder
# matches to 1e-6: test_joint_forward_pieces_match_jax_and_show_the_
# conditioning), and the Chamfer gradients, which follow each point's
# nearest neighbour, with it. The four f32 cases below read 3.1e-4 to
# 1.1e-2; a wrong loss weight reads 0.1 or more
# (test_joint_gradient_check_catches_a_wrong_loss).
GRAD_TOL_F32 = 2e-2
GRAD_TOL_BF16 = 0.25  # the AE step's Chamfer bound
JOINT_CASES = [(w, freeze, precision)
               for precision in PRECISIONS for freeze in (False, True)
               for w in (0.0, 1.0)]
STEP_KW = dict(bn_stats="single_read_grouped")


@pytest.mark.parametrize("w_ae_recon,freeze,precision", JOINT_CASES)
def test_joint_train_step_gradients_match_jax(w_ae_recon, freeze, precision):
    """One joint step from the same weights, batch and draws: the loss and
    its parts (f32: 1e-5 relative), the gradient of every trainable leaf
    (GRAD_TOL_F32 / GRAD_TOL_BF16 of the largest element), the new BN state
    of the encoder, decoder and generator. bf16_selective rounds the same
    operands in another order: loss and state 2e-2 relative."""
    _, tree = small_model_tree(seed=3)
    batch, key = batch_of(4), jax.random.PRNGKey(5)
    kw = dict(STEP_KW, w_ae_recon=w_ae_recon, freeze_generator=freeze)
    ref, jm, jmet = _jax_grads_cached(3, 4, 5, precision,
                                      tuple(sorted(kw.items())))
    grads, m, new = _port_grads(tree, batch, key, precision, **kw)
    err = _grad_err(grads, ref)
    if precision == "float32":
        for k in ("loss", "chamfer", "gfv"):
            np.testing.assert_allclose(float(m[k]), float(jmet[k]),
                                       rtol=1e-5)
        assert err <= GRAD_TOL_F32, err
        state_tol = 1e-5
    else:
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=2e-2)
        assert err <= GRAD_TOL_BF16, err
        state_tol = 2e-2
    for part in ("ae", "lgan"):
        for a, b in zip(tree_leaves(new[part]["state"]),
                        jax.tree.leaves(jm[part]["state"])):
            close_scaled(a, np.asarray(b, np.float32), state_tol)
    if freeze:  # no gradient reaches G; its state comes back bit for bit
        assert all(v.grad is None for v in tree_leaves(
            new["lgan"]["params"]["generator"]))
        for a, b, c in zip(tree_leaves(new["lgan"]["state"]["generator"]),
                           jax.tree.leaves(tree["lgan"]["state"]["generator"]),
                           jax.tree.leaves(jm["lgan"]["state"]["generator"])):
            assert torch.equal(a, t(b)) and np.array_equal(b, c)


def test_joint_forward_pieces_match_jax_and_show_the_conditioning():
    """The joint step's forward piece by piece on JAX's transforms (f32,
    the grouped BN statistics): the noisy GFV, z and the clean GFV agree
    with JAX's to 2e-5 scaled, and the port's training-mode decoder fed
    JAX's clean GFV agrees with JAX's decoded cloud to 1e-6 scaled. Fed
    its own clean GFV instead it differs by 10x that or more: G's outputs
    spread over the batch by under 0.05 a feature at this init, and the
    decoder's training BatchNorm divides by that spread (GRAD_TOL_F32)."""
    from gan_rl_3d_tpu import nn as jnn
    from gan_rl_3d_tpu.models import autoencoder as jae
    from gan_rl_3d_tpu.models import latent_gan as jlg
    from gan_rl_3d_tpu.models import rl_agent as jrl
    from gan_rl_3d_tpu_torch.models import autoencoder as tae
    from gan_rl_3d_tpu_torch.models import latent_gan as tlg
    from gan_rl_3d_tpu_torch.models import rl_agent as trl

    _, tree = small_model_tree(seed=3)
    k_data, _ = jax.random.split(jax.random.PRNGKey(5))
    batch = batch_of(4)
    _, incomplete, mask = jpc.make_training_batch(
        k_data, jnp.asarray(batch["complete_pc"]), do_augment=True, spec=SPEC)
    ae_p, ae_s = tree["ae"]["params"], tree["ae"]["state"]
    gen = (tree["lgan"]["params"]["generator"],
           tree["lgan"]["state"]["generator"])
    actor = tree["agent"]["actor"]
    with jnn.bn_stats_mode("single_read_grouped"):
        ref_noisy, _ = jae.any_encoder_apply(
            ae_p["encoder"], ae_s["encoder"], incomplete, mask, training=True)
        ref_z, _ = jrl.actor_apply(actor["params"], actor["state"], ref_noisy,
                                   cfg=JCFG)
        ref_clean, _ = jlg.generator_apply(*gen, ref_z, training=False)
        ref_pc, _ = jae.any_decoder_apply(ae_p["decoder"], ae_s["decoder"],
                                          ref_clean, training=True)
    model = port_model(tree)
    p_ae, s_ae = model["ae"]["params"], model["ae"]["state"]
    kw = dict(training=True, bn_stats="single_read_grouped")
    with torch.no_grad():
        noisy, _ = tae.any_encoder_apply(p_ae["encoder"], s_ae["encoder"],
                                         t(incomplete), t(mask), **kw)
        z, _ = trl.actor_apply(*(model["agent"]["actor"][k]
                                 for k in ("params", "state")), noisy,
                               cfg=PCFG)
        clean, _ = tlg.generator_apply(*(model["lgan"][k]["generator"]
                                         for k in ("params", "state")), z)
        own_pc, _ = tae.any_decoder_apply(p_ae["decoder"], s_ae["decoder"],
                                          clean, **kw)
        fed_pc, _ = tae.any_decoder_apply(p_ae["decoder"], s_ae["decoder"],
                                          t(ref_clean), **kw)
    for port, ref in ((noisy, ref_noisy), (z, ref_z), (clean, ref_clean)):
        close_scaled(port, ref, 2e-5)
    close_scaled(fed_pc, ref_pc, 1e-6)
    scale = float(np.abs(np.asarray(ref_pc)).max())
    own = float(np.abs(own_pc.numpy() - np.asarray(ref_pc)).max()) / scale
    fed = float(np.abs(fed_pc.numpy() - np.asarray(ref_pc)).max()) / scale
    assert own >= 10 * fed, (own, fed)
    assert float(np.asarray(ref_clean).std(0).min()) < 0.05


@pytest.mark.parametrize("wrong", ["gfv_weight", "w_ae_recon"])
def test_joint_gradient_check_catches_a_wrong_loss(wrong, monkeypatch):
    """The f32 gradient comparison fails a step whose MSE term weighs 0.2
    instead of 0.1, or whose AE-path term weighs 0.5 instead of 1."""
    _, tree = small_model_tree(seed=3)
    batch, key = batch_of(4), jax.random.PRNGKey(5)
    kw = dict(STEP_KW, w_ae_recon=1.0, freeze_generator=False)
    ref, _, _ = _jax_grads_cached(3, 4, 5, "float32",
                                  tuple(sorted(kw.items())))
    if wrong == "gfv_weight":
        gfv_loss = tlosses.gfv_loss
        monkeypatch.setattr(tsteps.losses_ops, "gfv_loss",
                            lambda a, b: 2.0 * gfv_loss(a, b))
    else:
        kw["w_ae_recon"] = 0.5
    grads, _, _ = _port_grads(tree, batch, key, "float32", **kw)
    assert _grad_err(grads, ref) > 5 * GRAD_TOL_F32



# ---------------------------------------------------------------------------
# the trainer's joint optimizer
# ---------------------------------------------------------------------------


# lr and a weight decay large enough that the decay moves the updates
# (the recipe's 1e-5 would not, so dropping it could not fail the check)
ADAM = dict(lr=1e-3, weight_decay=5e-2)
JOINT_OPT = jsteps.make_joint_optimizer(jcfg.JointTrainConfig(**ADAM))


def _optimizer_updates(freeze, kind="adam", n_steps=3):
    """The trainer's joint optimizer on the joint step's trainable tree
    (``joint_trainable``), fed the same gradients as optax's
    add_decayed_weights -> scale_by_adam -> lr for n_steps. Fed equal
    gradients the two Adams agree to rounding; fed the step's own
    gradients they would also carry the step's conditioning (see
    GRAD_TOL_F32), which Adam's per-element normalisation turns into
    lr-sized steps. The port's side can take another optimizer, to show
    what the check catches: "adamw" (decoupled decay), "lr0", "wd0"."""
    _, tree = small_model_tree(seed=6)
    start = jax_trainable(tree, freeze)
    model = port_model(tree)
    port = tsteps.joint_trainable(model, freeze)
    cfg = tcfg.JointTrainConfig(**ADAM)
    if kind == "adamw":
        opt = torch.optim.AdamW(tree_leaves(port), lr=cfg.lr,
                                weight_decay=cfg.weight_decay)
    else:
        cfg = dataclasses.replace(cfg, **{"lr0": dict(lr=0.0),
                                          "wd0": dict(weight_decay=0.0)
                                          }.get(kind, {}))
        opt = tsteps.make_joint_optimizer(port, cfg)
    ref, state = start, JOINT_OPT.init(start)
    rng = np.random.RandomState(12)
    for _ in range(n_steps):
        grads = jax.tree.map(lambda x: (rng.randn(*x.shape) * 1e-2).astype(
            np.float32), start)
        updates, state = JOINT_OPT.update(grads, state, ref)
        ref = optax.apply_updates(ref, updates)
        for p, g in zip(tree_leaves(port), jax.tree.leaves(grads)):
            p.grad = t(g)
        opt.step()
    return port, ref, start


def _assert_joint_updates(port, ref, start):
    """Each network's update (new - start) within 1e-3 of the largest
    element of JAX's update (assert_update_close); fed equal gradients the
    Adam-noise leaves are held as tightly, 1e-7 absolute."""
    assert set(port) == set(ref)
    for k in port:
        assert_update_close(port[k], ref[k], start[k], 1e-3, 1e-7)


@pytest.mark.parametrize("freeze", [False, True])
def test_joint_optimizer_matches_optax(freeze):
    """torch's Adam(weight_decay) against optax's add_decayed_weights ->
    scale_by_adam -> lr, over the trainable tree: ae and G, or ae alone
    with the generator frozen."""
    port, ref, start = _optimizer_updates(freeze)
    assert set(port) == ({"ae"} if freeze else {"ae", "gen"})
    _assert_joint_updates(port, ref, start)


@pytest.mark.parametrize("kind", ["adamw", "lr0", "wd0"])
def test_joint_optimizer_check_catches_a_wrong_optimizer(kind):
    """The same comparison fails with decoupled decay (AdamW), lr 0 or no
    weight decay on the port's side."""
    with pytest.raises(AssertionError):
        _assert_joint_updates(*_optimizer_updates(False, kind))


# ---------------------------------------------------------------------------
# the joint eval step and the gate statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate_mode,gate_bias",
                         [("discriminator", 0.05), ("union", 0.0)])
def test_joint_eval_step_matches_jax(gate_mode, gate_bias):
    """Validation through the hybrid gate on JAX's holes, with a serving
    GAN-branch snapshot in the model."""
    _, tree = small_model_tree(seed=7, gan_path=True)
    batch, key = batch_of(8), jax.random.PRNGKey(9)
    ref = jsteps.joint_eval_step(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch),
        key, cfg=JCFG, spec=SPEC, gate_mode=gate_mode, gate_bias=gate_bias)
    out = tsteps.joint_eval_step(
        model_from_numpy(tree, device="cpu"), tree_map(t, batch),
        jax_draws(key, B, N_POINTS, SPEC), cfg=PCFG, spec=TSPEC,
        gate_mode=gate_mode, gate_bias=gate_bias)
    close_scaled(out["loss"], ref["loss"], 1e-5)


def test_gate_statistics_match_jax():
    """gate_stats_step on one batch, then gate_statistics over two batches
    with a padded row each (dropped), batch i's holes from fold_in(key, i)
    on both sides: both paths' Chamfer distances and the D margins."""
    _, tree = small_model_tree(seed=10, gan_path=True)
    jtree = jax.tree.map(jnp.asarray, tree)
    model = model_from_numpy(tree, device="cpu")
    batches = [batch_of(30), batch_of(31)]
    key = jax.random.PRNGKey(2)
    ref = jgate.gate_stats_step(jtree, jax.tree.map(jnp.asarray, batches[0]),
                                key, cfg=JCFG, spec=SPEC)
    out = tgate.gate_stats_step(model, tree_map(t, batches[0]),
                                jax_draws(key, B, N_POINTS, SPEC), cfg=PCFG,
                                spec=TSPEC)
    for k in tgate.STAT_KEYS:
        assert out[k].shape == (B,)
        close_scaled(out[k], ref[k], 1e-5)
    assert torch.equal(out["pad"], t(batches[0]["pad"]))
    ref = jgate.gate_statistics(jtree, batches,
                                lambda b: jax.tree.map(jnp.asarray, b), key,
                                cfg=JCFG, spec=SPEC)
    out = tgate.gate_statistics(
        model, batches, lambda i, bsz, n: jax_draws(
            jax.random.fold_in(key, i), bsz, n, SPEC),
        cfg=PCFG, device=torch.device("cpu"), spec=TSPEC)
    for k in tgate.STAT_KEYS:
        assert out[k].shape == (2 * (B - 1),)
        close_scaled(out[k], ref[k], 1e-5)


# ---------------------------------------------------------------------------
# the threshold sweep and the sidecars
# ---------------------------------------------------------------------------


def _gate_stats(kind):
    rng = np.random.RandomState(11)
    n = 600 if kind == "large" else 40
    cd_rl = rng.uniform(0.01, 0.05, n)
    cd_ae = rng.uniform(0.01, 0.05, n)
    margin = rng.randn(n)
    if kind == "tied":  # repeated margins and equal distances
        margin = rng.randint(-3, 4, n) * 0.5
        cd_ae[::3] = cd_rl[::3]
    elif kind == "rl_everywhere":
        cd_rl = cd_ae * 0.5
    elif kind == "ae_everywhere":
        cd_ae = cd_rl * 0.5
    return {"cd_rl": cd_rl.astype(np.float32),
            "cd_ae": cd_ae.astype(np.float32),
            "margin": margin.astype(np.float32)}


@pytest.mark.parametrize("kind", ["random", "tied", "rl_everywhere",
                                  "ae_everywhere", "large"])
def test_calibrate_gate_equals_jax(kind):
    """The same float64 sweep: every key of the report equal (==); the
    degenerate splits report gate_mode rl / ae; 600 samples take the
    256-candidate quantile branch."""
    stats = _gate_stats(kind)
    report = tgate.calibrate_gate(stats)
    assert report == jgate.calibrate_gate(stats)
    assert report["val_chamfer_calibrated"] <= min(
        report["val_chamfer_raw_gate"], report["val_chamfer_rl"],
        report["val_chamfer_ae"])
    expect = {"rl_everywhere": "rl", "ae_everywhere": "ae"}.get(kind)
    if expect is not None:
        assert (report["gate_mode"], report["gate_bias"]) == (expect, 0.0)


def test_calibrate_gate_refuses_empty_stats():
    empty = {k: np.zeros(0, np.float32) for k in tgate.STAT_KEYS}
    for lib in (tgate, jgate):
        with pytest.raises(ValueError, match="no validation samples"):
            lib.calibrate_gate(empty)


@pytest.mark.parametrize("writer,reader", [(jgate, tgate), (tgate, jgate)],
                         ids=["jax_writes", "port_writes"])
def test_gate_sidecars_cross_both_ways(tmp_path, writer, reader):
    """One package writes a scoped sidecar; the other reads it (in scope:
    the calibrated gate; out of scope: the defaults), descopes it, and the
    file empties out and goes."""
    report = dict(tgate.calibrate_gate(_gate_stats("random")),
                  gate_mode="discriminator", gate_bias=0.125,
                  checkpoints=["joint_calibrated", "final"])
    writer.save_gate_calibration(str(tmp_path), report)
    assert json.loads((tmp_path / tgate.GATE_FILE).read_text()) == report
    defaults = dict(default_mode="ae", default_bias=0.5)
    for name in ("final", "joint_calibrated"):
        assert reader.load_gate_calibration(
            str(tmp_path), checkpoint=name, **defaults) == (
                "discriminator", 0.125)
    assert reader.load_gate_calibration(
        str(tmp_path), checkpoint="joint_best", **defaults) == ("ae", 0.5)
    reader.descope_gate_calibration(str(tmp_path), "final")
    assert writer.load_gate_calibration(
        str(tmp_path), checkpoint="final", **defaults) == ("ae", 0.5)
    assert json.loads((tmp_path / tgate.GATE_FILE).read_text())[
        "checkpoints"] == ["joint_calibrated"]
    writer.descope_gate_calibration(str(tmp_path), "joint_calibrated")
    assert not (tmp_path / tgate.GATE_FILE).exists()


# ---------------------------------------------------------------------------
# the trainer: checkpoints, the snapshot, the D refresh, the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    data = tmp_path_factory.mktemp("joint_data")
    tdataset.setup_dataset(str(data), synthetic=True, samples_per_category=2,
                           num_points=N_POINTS)
    return data


def tiny_config(root, data, **joint):
    """The tiny config of the phase 1-4 CLI test
    (tests/test_torch_port_rl.py), with a joint block, written as YAML
    under ``root``; logs and results stay there too."""
    rl_model = {**SMALL["model"]["rl_agent"], "buffer_size": 32,
                "batch_size": B}
    cfg = {"model": {**SMALL["model"], "rl_agent": rl_model},
           "training": {
               "precision": "float32", "batch_size": 8,
               "checkpoint_dir": str(root / "ckpt"),
               "log_dir": str(root / "logs"),
               "results_dir": str(root / "results"),
               "autoencoder": {"epochs": 1},
               "lgan": {"epochs": 2, "batch_size": 4, "d_steps": 2},
               "rl_agent": {"episodes": 24, "envs_per_step": 4,
                            "updates_per_step": 2,
                            "start_training_steps": 8, "actor_warmup": 1,
                            "actor_lr_ramp": 2},
               "joint": {"epochs": 2, "w_ae_recon": 1.0, **joint}},
           "data": {"data_dir": str(data)}}
    path = root / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("stale", ["directory", "file"])
def test_save_removes_a_stale_ganpath_sibling(tmp_path, data_dir, stale):
    """A ``final_ganpath`` left by an earlier run (an orbax directory of the
    JAX package, or a pickle) goes when the port saves ``final`` without a
    snapshot; the checkpoint then loads without ``gan_path``. (The port
    used to remove a file only, and loading raised on the directory.)"""
    trainer = RLGANNetTrainer(str(tiny_config(tmp_path, data_dir)),
                              device="cpu")
    sibling = trainer.checkpoint_dir / "final_ganpath"
    if stale == "directory":
        (sibling / "d").mkdir(parents=True)
        (sibling / "_METADATA").write_text("{}")
    else:
        sibling.write_bytes(b"stale")
    trainer.save_checkpoint("final", 0, "joint")
    assert not sibling.exists()
    model, meta = tckpt.load_model_checkpoint(str(trainer.checkpoint_dir),
                                              "final")
    assert "gan_path" not in model and int(meta["phase_idx"]) == 3


def test_overwriting_a_checkpoint_descopes_an_old_sidecar(tmp_path,
                                                          data_dir):
    """A sidecar of an earlier run scoped to joint_calibrated and final: a
    run that saves final without calibrating takes final out of its scope
    (the old bias was measured against another D); a run that calibrated
    leaves it."""
    trainer = RLGANNetTrainer(str(tiny_config(tmp_path, data_dir)),
                              device="cpu")
    ckpt = str(trainer.checkpoint_dir)
    tgate.save_gate_calibration(ckpt, {
        "gate_mode": "rl", "gate_bias": 0.0,
        "checkpoints": ["joint_calibrated", "final"]})
    trainer.save_checkpoint("joint_best", 0, "joint")
    trainer.save_checkpoint("final", 0, "joint")
    assert tgate.load_gate_calibration(ckpt, checkpoint="final") == (
        "discriminator", 0.0)
    assert tgate.load_gate_calibration(
        ckpt, checkpoint="joint_calibrated") == ("rl", 0.0)
    trainer._gate_calibrated = True
    trainer.save_checkpoint("joint_calibrated", 0, "joint")
    assert tgate.load_gate_calibration(
        ckpt, checkpoint="joint_calibrated") == ("rl", 0.0)


def test_preserve_gan_path_snapshot_and_the_refresh_fakes(tmp_path, data_dir,
                                                          monkeypatch):
    """joint.preserve_gan_path: the snapshot is G and the decoder as they
    were before the joint phase (copies, which Adam leaves alone, while the
    live ones move); ``joint_best_ganpath`` is a pickle the JAX package
    reads, and JAX's ``complete`` on it equals the port's; the D refresh
    draws its fakes from the snapshot's G and keeps the live G."""
    trainer = RLGANNetTrainer(
        str(tiny_config(tmp_path, data_dir, preserve_gan_path=True,
                        refresh_d_steps=3)), device="cpu")
    snap = lambda tree: [v.detach().clone()  # noqa: E731
                         for v in tree_leaves(tree)]
    gen0 = snap(trainer.model["lgan"]["params"]["generator"])
    dec0 = snap(trainer.model["ae"]["params"]["decoder"])
    trainer.joint_training(1)
    gp = trainer.model["gan_path"]
    for before, now, live in (
            (gen0, gp["generator"]["params"],
             trainer.model["lgan"]["params"]["generator"]),
            (dec0, gp["decoder"]["params"],
             trainer.model["ae"]["params"]["decoder"])):
        assert all(torch.equal(a, b) for a, b in zip(before,
                                                     tree_leaves(now)))
        assert not all(torch.equal(a, b.detach()) for a, b in zip(
            before, tree_leaves(live)))
    ckpt = trainer.checkpoint_dir
    jtree = jckpt.load_checkpoint(str(ckpt / "joint_best"), use_orbax=False)
    jtree["model"]["gan_path"] = jckpt.load_checkpoint(
        str(ckpt / "joint_best_ganpath"), use_orbax=False)
    for a, b in zip(jax.tree.leaves(jtree["model"]["gan_path"]),
                    tree_leaves(gp)):
        np.testing.assert_array_equal(a, b.numpy())
    pc = clouds(seed=40, bsz=3)
    ref = jnet.complete(jtree["model"], pc, cfg=JCFG)
    out = tnet.complete(trainer.model, t(pc), cfg=trainer.td3)
    for k in ref:
        close_scaled(out[k], ref[k], 1e-5)

    seen = {}
    refresh = tsteps.lgan_d_refresh

    def spy(params, state, *args, **kw):
        seen["generator"] = params["generator"]
        return refresh(params, state, *args, **kw)

    monkeypatch.setattr(tsteps, "lgan_d_refresh", spy)
    live = trainer.model["lgan"]
    g_live = snap({"p": live["params"]["generator"],
                   "s": live["state"]["generator"]})
    d_before = snap(live["params"]["discriminator"])
    trainer.refresh_discriminator()
    assert seen["generator"] is gp["generator"]["params"]
    live = trainer.model["lgan"]
    assert all(torch.equal(a, b.detach()) for a, b in zip(
        g_live, tree_leaves({"p": live["params"]["generator"],
                             "s": live["state"]["generator"]})))
    assert not all(torch.equal(a, b.detach()) for a, b in zip(
        d_before, tree_leaves(live["params"]["discriminator"])))
    assert len(trainer.refresh_d_losses) == 3


def test_cli_runs_the_curriculum_and_the_checkpoints_cross(tmp_path,
                                                           data_dir):
    """``--phase full`` from scratch on the CPU writes every phase's
    checkpoints, ``joint_best``, ``joint_calibrated``, ``final`` and the
    sidecar, scoped to the last two; the JAX trainer restores ``final``
    and, with the sidecar's gate, completes as the port does. ``--phase
    full --resume rl_agent_final`` skips phases 1-3 and restarts at phase
    4, the phase that checkpoint records (the JAX trainer's rule,
    trainer.py:697-718); ``--resume joint_best`` skips phases 1-4;
    ``--phase joint`` reruns phases 5 and 5.5 alone."""
    path = tiny_config(tmp_path, data_dir, refresh_d_steps=3,
                       calibrate_gate=True)
    base = ["--config", str(path), "--device", "cpu"]
    assert train_main(base) is None
    ckpt = tmp_path / "ckpt"
    names = ("autoencoder_best", "lgan_best", "lgan_final", "rl_agent_best",
             "rl_agent_final", "joint_best", "joint_calibrated", "final")
    for name in names:
        assert (ckpt / name).is_file(), name
    report = json.loads((ckpt / tgate.GATE_FILE).read_text())
    assert report["checkpoints"] == ["joint_calibrated", "final"]
    assert report["val_chamfer_calibrated"] <= min(
        report["val_chamfer_raw_gate"], report["val_chamfer_rl"],
        report["val_chamfer_ae"])
    assert report["n_samples"] == 8

    jtrainer = JaxTrainer(jcfg.load_config(str(path)), use_orbax=False)
    assert jtrainer.load_checkpoint("final")[1] == "joint"
    trainer = RLGANNetTrainer(str(path), device="cpu")
    assert trainer.load_checkpoint("final")[1] == "joint"
    gate = {"gate_mode": report["gate_mode"], "gate_bias": report["gate_bias"]}
    assert jgate.load_gate_calibration(str(ckpt), checkpoint="final") == \
        tgate.load_gate_calibration(str(ckpt), checkpoint="final") == (
            gate["gate_mode"], gate["gate_bias"])
    pc = clouds(seed=41, bsz=3)
    ref = jnet.complete(jtrainer.model, pc, cfg=jtrainer.td3, **gate)
    out = tnet.complete(trainer.model, t(pc), cfg=trainer.td3, **gate)
    for k in ref:
        close_scaled(out[k], ref[k], 1e-5)
    jtrainer.close()

    old = 10 ** 18  # 2001 in ns: a file this old was not rewritten

    def rewritten(argv):
        for n in names:
            os.utime(ckpt / n, ns=(old, old))
        out = train_main([*base, *argv])
        return out, {n for n in names if os.stat(ckpt / n).st_mtime_ns != old}

    _, written = rewritten(["--resume", "rl_agent_final"])
    assert written == set(names[3:])  # phase 4 on: rl_agent_*, joint_*, final
    _, written = rewritten(["--resume", "joint_best"])
    assert written == {"joint_best", "joint_calibrated", "final"}
    best, written = rewritten(["--phase", "joint", "--resume", "final"])
    assert np.isfinite(best)
    assert written == {"joint_best", "joint_calibrated"}
