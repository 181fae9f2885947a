"""Port parity for training the attention-encoder / adaptive-decoder
family: the AE step in f32 (Adam updates) and bf16_selective (gradients),
the joint step's f32 gradients, and the family's checkpoints across the
packages (a JAX-written pickle and orbax checkpoint loaded and resumed
mid-phase by the port; a port-written one resumed by the JAX trainer).
CPU, small widths, N=256, B=8; the JAX steps run their Pallas kernels in
interpret mode."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu import nn as jnn
from gan_rl_3d_tpu.models import autoencoder as jae
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu.ops import pointcloud as jpc
from gan_rl_3d_tpu.train import RLGANNetTrainer as JaxTrainer
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch.convert import load_chain
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.models import autoencoder as tae
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.ops import pointcloud as tpc
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
from gan_rl_3d_tpu_torch.utils import checkpoint as tckpt
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from test_torch_port_joint import (GRAD_TOL_BF16, GRAD_TOL_F32, STEP_KW,
                                   _grad_err, _jax_grads, _port_grads,
                                   batch_of)
from test_torch_port_lgan import close_scaled
from test_torch_port_modules import N_POINTS, t
from test_torch_port_resume import _assert_adam_loaded
from test_torch_port_train import B, clouds, jax_draws, leaf_tensors
from test_torch_port_variants import (SMALL_VARIANT, variant_model_tree,
                                      varied_clouds)

AE_CFG = dict(epochs=2, lr_schedule="cosine")
STEPS_PER_EPOCH = 2  # 16 train clouds at batch 8


def _variant_ae(seed):
    _, tree = variant_model_tree(seed=seed)
    return tree["ae"]["params"], tree["ae"]["state"]


def _ae_inputs(i):
    """Step i's batch (varied clouds, a wrap-around pad on odd steps) and
    key."""
    pad = np.zeros(B, np.float32)
    pad[-1] = float(i % 2)
    return ({"complete_pc": varied_clouds(seed=40 + i)[0], "pad": pad},
            jax.random.PRNGKey(50 + i))


def _run_ae_steps(precision, n_steps, recon_loss="chamfer"):
    """n_steps of ae_train_step in both packages from the same variant
    weights, batches and draws: (port losses, JAX losses, start params,
    port params, JAX params, port state, JAX state)."""
    p, s = _variant_ae(seed=13)
    jopt = jsteps.make_ae_optimizer(jcfg.AETrainConfig(**AE_CFG),
                                    STEPS_PER_EPOCH)
    jparams, jstate, jopt_state = p, s, jopt.init(p)
    tparams, tstate = leaf_tensors(p), tree_map(t, s)
    topt, sched = tsteps.make_ae_optimizer(
        tparams, tcfg.AETrainConfig(**AE_CFG), STEPS_PER_EPOCH)
    dtype, selective = tsteps.compute_dtype_of(precision)
    jdtype = jnp.bfloat16 if dtype is not None else None
    losses, ref_losses = [], []
    for i in range(n_steps):
        batch, key = _ae_inputs(i)
        jparams, jstate, jopt_state, m = jsteps.ae_train_step(
            jparams, jstate, jopt_state, jax.tree.map(jnp.asarray, batch),
            key, optimizer=jopt, compute_dtype=jdtype,
            spec=jpc.PreprocSpec(), selective=selective,
            bn_stats="single_read_grouped", recon_loss=recon_loss)
        ref_losses.append(float(m["loss"]))
        k_data, _ = jax.random.split(key)
        tstate, tm = tsteps.ae_train_step(
            tparams, tstate, topt, tree_map(t, batch),
            jax_draws(k_data, B, N_POINTS, jpc.PreprocSpec()),
            scheduler=sched, compute_dtype=dtype, spec=tpc.PreprocSpec(),
            selective=selective, bn_stats="single_read_grouped",
            recon_loss=recon_loss)
        losses.append(float(tm["loss"]))
    return losses, ref_losses, p, tparams, jparams, tstate, jstate


def _jax_variant_grads(recon_loss, precision="float32"):
    """jax.grad of the JAX variant step's loss, read through the step with
    optax.identity() (new params = params + grads), as a tree."""
    p, s = _variant_ae(seed=13)
    batch, key = _ae_inputs(0)
    dtype, selective = tsteps.compute_dtype_of(precision)
    new_p, _, _, _ = jsteps.ae_train_step(
        p, s, optax.EmptyState(), jax.tree.map(jnp.asarray, batch), key,
        optimizer=optax.identity(),
        compute_dtype=None if dtype is None else jnp.bfloat16,
        spec=jpc.PreprocSpec(), selective=selective,
        bn_stats="single_read_grouped", recon_loss=recon_loss)
    return jax.tree.map(lambda a, b: np.asarray(a) - b, new_p, p)


def assert_first_adam_step_close(port, ref, start, grads, tol, lr):
    """One Adam step from fresh moments moves each element by lr times
    g / (|g| + eps): lr times the sign of its gradient. Each element whose
    JAX gradient is at least 1e-4 of the network's largest must move as
    JAX's did within ``tol`` of JAX's largest update; the elements below
    (a near-zero gradient, where a last-bit difference flips the sign: the
    biases ahead of a training BN and the weights of inputs nearly
    constant over the batch) within 2 lr."""
    g_leaves = jax.tree.leaves(grads)
    g_max = max(float(np.abs(g).max()) for g in g_leaves)
    moved = max(float(np.abs(np.asarray(r, np.float64) - s0).max())
                for r, s0 in zip(jax.tree.leaves(ref), jax.tree.leaves(start)))
    for a, r, g in zip(tree_leaves(port), jax.tree.leaves(ref), g_leaves,
                       strict=True):
        err = np.abs(a.detach().numpy().astype(np.float64) - r)
        big = np.abs(g) >= 1e-4 * g_max
        assert err[big].max(initial=0.0) <= tol * moved
        assert err[~big].max(initial=0.0) <= 2 * lr


@pytest.mark.parametrize("recon_loss", ["chamfer", "mse"])
def test_variant_f32_ae_train_step_matches_jax(recon_loss):
    """One f32 AE step of the variant family from fresh Adam moments: the
    loss (1e-5 relative), each network's update within 1e-3 of the
    largest element of JAX's update (assert_first_adam_step_close; the
    largest error reads 1.9e-4 of it), the new BN state within 1e-5
    scaled. A step with twice the lr fails the update check."""
    losses, ref_losses, start, tp, jp, ts, js = _run_ae_steps("float32", 1,
                                                              recon_loss)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    grads = _jax_variant_grads(recon_loss)
    for half in ("encoder", "decoder"):
        assert_first_adam_step_close(tp[half], jp[half], start[half],
                                     grads[half], 1e-3, 1e-3)
    for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
        close_scaled(a, b, 1e-5)
    twice = tree_unflatten(tp["decoder"], [
        2 * v.detach() - t(s0) for v, s0 in zip(
            tree_leaves(tp["decoder"]), jax.tree.leaves(start["decoder"]))])
    with pytest.raises(AssertionError):
        assert_first_adam_step_close(twice, jp["decoder"],
                                     start["decoder"], grads["decoder"],
                                     1e-3, 1e-3)


def test_variant_bf16_selective_forward_pieces_match_jax():
    """JAX's bf16_selective cast of the variant family, piece by piece, in
    training mode: the attention encoder's GFV within 2e-2 of JAX's
    largest element (the repo's bf16 bound, card_checks.TOL_BF16), not
    equal: its pool sums f32 products in another order than XLA, the
    bf16 head rounds those last bits either way, and its training BN
    scales the bf16 ulps (15% of the elements differ, by 1.9e-2 of the
    largest at most). The adaptive decoder, all bf16,
    fed JAX's GFV gives JAX's cloud bit for bit in eval mode and within
    2e-2 of its largest element in training mode (its BN statistics sum
    in another order: 2.9% of the elements differ, by 5.1e-3 at most)."""
    p, s = _variant_ae(seed=13)
    pc, mask = varied_clouds(seed=40)
    jp = jsteps._policy_cast_ae_selective(jax.tree.map(jnp.asarray, p),
                                          jnp.bfloat16)
    tp = tsteps._policy_cast_ae_selective(tree_map(t, p), torch.bfloat16)
    with jnn.bn_stats_mode("single_read_grouped"):
        ref, _ = jae.any_encoder_apply(
            jp["encoder"], s["encoder"],
            jnp.asarray(pc).astype(jnp.bfloat16), jnp.asarray(mask),
            training=True)
    gfv, _ = tae.any_encoder_apply(
        tp["encoder"], tree_map(t, s["encoder"]), t(pc).to(torch.bfloat16),
        t(mask), training=True, bn_stats="single_read_grouped")
    assert gfv.dtype == torch.bfloat16
    ref32 = np.array(ref.astype(jnp.float32))
    err = np.abs(gfv.float().numpy() - ref32).max() / np.abs(ref32).max()
    assert 0 < err <= 2e-2, err
    for training in (False, True):
        with jnn.bn_stats_mode("single_read_grouped"):
            ref_pc, _ = jae.any_decoder_apply(jp["decoder"], s["decoder"],
                                              ref, training=training)
        out, _ = tae.any_decoder_apply(
            tp["decoder"], tree_map(t, s["decoder"]),
            torch.from_numpy(ref32).to(torch.bfloat16), training=training,
            bn_stats="single_read_grouped")
        assert out.dtype == torch.bfloat16
        ref_pc = np.asarray(ref_pc.astype(jnp.float32))
        err = np.abs(out.float().numpy() - ref_pc).max()
        assert err <= (2e-2 * np.abs(ref_pc).max() if training else 0.0), err


def _bf16_bound(recon_loss, port_err, control):
    """The MSE loss is held to the AE step's bf16_selective bound. With the
    Chamfer loss the attention pool's bf16 GFV differences (above)
    reach the all-bf16 decoder's cloud through its training BatchNorms
    (up to 0.1 in a coordinate at B=8), and each point's gradient turns
    with its nearest neighbour: the port reads 0.35 of the largest
    element (the joint step 0.41), JAX against itself under a 1 + 1e-7
    input scale 0.004-0.014; held below the f32 control, JAX's f32
    gradients against its own bf16_selective ones (0.54)."""
    if recon_loss == "mse":
        assert port_err <= GRAD_TOL_BF16, port_err
    else:
        assert port_err < control, (port_err, control)


@pytest.mark.parametrize("recon_loss", ["chamfer", "mse"])
def test_variant_bf16_selective_ae_step_matches_jax(recon_loss):
    """bf16_selective on the variant family, JAX's cast (the adaptive
    decoder all bf16, the attention encoder's last point-MLP layer f32):
    the loss within 2e-2 relative, the step's gradients against jax.grad
    of JAX's step as _bf16_bound says."""
    losses, ref_losses, _, tp, *_ = _run_ae_steps("bf16_selective", 1,
                                                  recon_loss)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2)
    grads = [v.grad.numpy() for v in tree_leaves(tp)]
    ref = jax.tree.leaves(_jax_variant_grads(recon_loss, "bf16_selective"))
    control = _grad_err(jax.tree.leaves(_jax_variant_grads(recon_loss)), ref)
    _bf16_bound(recon_loss, _grad_err(grads, ref), control)


@pytest.mark.parametrize("precision", ["float32", "bf16_selective"])
@pytest.mark.parametrize("w_ae_recon", [0.0, 1.0])
def test_variant_joint_step_gradients_match_jax(precision, w_ae_recon):
    """One joint step on the variant family (with w_ae_recon 1 one
    (2B, .) adaptive-decoder pass, whose refinement BN sees 2B * N rows):
    f32, the gradient of every trainable leaf within GRAD_TOL_F32 of the
    largest element and the loss within 1e-5 relative; bf16_selective,
    the loss within 2e-2 and the gradients as _bf16_bound holds the
    Chamfer loss."""
    _, tree = variant_model_tree(seed=15)
    batch = batch_of(16)
    batch["complete_pc"] = varied_clouds(seed=16)[0]
    key = jax.random.PRNGKey(17)
    kw = dict(STEP_KW, w_ae_recon=w_ae_recon, freeze_generator=False)
    ref, _, jmet = _jax_grads(tree, batch, key, precision, **kw)
    grads, m, _ = _port_grads(tree, batch, key, precision, **kw)
    err = _grad_err(grads, ref)
    if precision == "float32":
        assert err <= GRAD_TOL_F32, err
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    else:
        control = _grad_err(_jax_grads(tree, batch, key, "float32", **kw)[0],
                            ref)
        _bf16_bound("chamfer", err, control)
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=2e-2)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    data = tmp_path_factory.mktemp("variant_data")
    tdataset.setup_dataset(str(data), synthetic=True, samples_per_category=2,
                           num_points=N_POINTS)
    return data


def tiny_variant(root, data, ae_epochs):
    """A config both packages read: the variant family at SMALL widths,
    batch 8, a checkpoint with its train state every epoch."""
    return {"model": SMALL_VARIANT["model"],
            "training": {"precision": "float32", "batch_size": 8,
                         "checkpoint_dir": str(root / "ckpt"),
                         "log_dir": str(root / "logs"),
                         "results_dir": str(root / "res"),
                         "autoencoder": {"epochs": ae_epochs}},
            "logging": {"save_model_frequency": 1, "use_tensorboard": False},
            "data": {"data_dir": str(data)}}


def _port(root, data, ae_epochs):
    path = root / f"tiny_{ae_epochs}.json"
    path.write_text(json.dumps(tiny_variant(root, data, ae_epochs)))
    return RLGANNetTrainer(str(path), device="cpu")


def _jax(root, data, ae_epochs, use_orbax):
    return JaxTrainer(jcfg.load_config(
        None, overrides=tiny_variant(root, data, ae_epochs)),
        use_orbax=use_orbax)


def _assert_same_ae(port_ae, jax_ae):
    for part in ("params", "state"):
        port_l = tree_leaves(port_ae[part])
        ref_l = jax.tree.leaves(jax_ae[part])
        assert len(port_l) == len(ref_l)
        for a, b in zip(port_l, ref_l):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


@pytest.mark.parametrize("use_orbax", [False, True])
def test_port_resumes_a_jax_variant_checkpoint(tmp_path, data_dir, use_orbax,
                                               capsys):
    """The JAX trainer trains the variant family's phase 1 for one epoch
    (a pickle, or orbax directories); the port loads
    ``autoencoder_epoch_1`` bit for bit, restores its train state (JAX's
    Adam moments and count) and trains only the epoch left."""
    jt = _jax(tmp_path, data_dir, 1, use_orbax)
    jt.train_autoencoder()
    jax_ae = jax.tree.map(np.asarray, jt.model["ae"])
    jt.close()
    trainer = _port(tmp_path, data_dir, 2)
    assert trainer.load_checkpoint("autoencoder_epoch_1") == (0,
                                                              "autoencoder")
    _assert_same_ae(trainer.model["ae"], jax_ae)
    trainer.train_autoencoder()
    out = capsys.readouterr().out
    assert "restored autoencoder train state" in out
    assert len(trainer.train_losses) == STEPS_PER_EPOCH
    assert np.isfinite(trainer.train_losses).all()
    assert (tmp_path / "ckpt" / "autoencoder_epoch_2").is_file()
    trainer.close()


def test_jax_resumes_a_port_variant_checkpoint(tmp_path, data_dir, capsys):
    """The reverse: the port trains one epoch of the variant family and
    writes ``autoencoder_epoch_1`` with its train state; the JAX trainer
    loads it bit for bit, reads the same Adam moments along the variant's
    parameter paths as the port's own reader, and trains the epoch left
    from them."""
    trainer = _port(tmp_path, data_dir, 1)
    trainer.train_autoencoder()
    trainer.close()
    jt = _jax(tmp_path, data_dir, 2, use_orbax=False)
    jt.load_checkpoint("autoencoder_epoch_1")
    _assert_same_ae(trainer.model["ae"], jt.model["ae"])
    params = trainer.model["ae"]["params"]
    port_opt, _ = tsteps.make_ae_optimizer(
        params, trainer.config.training.autoencoder, STEPS_PER_EPOCH)
    load_chain(port_opt, params, tckpt.load_checkpoint(
        str(tmp_path / "ckpt" / "autoencoder_epoch_1_trainstate"))
        ["opt_state"])
    opt = jsteps.make_ae_optimizer(jt.config.training.autoencoder,
                                   STEPS_PER_EPOCH)
    rst = jt._restore_train_state(
        "autoencoder", {"opt_state": opt.init(jt.model["ae"]["params"]),
                        "best_val": np.float32(0), "epoch": np.int32(0)})
    assert int(rst["epoch"]) == 0
    _assert_adam_loaded(port_opt, params, rst["opt_state"][1])
    jt.load_checkpoint("autoencoder_epoch_1")  # arms the resume again
    capsys.readouterr()
    assert np.isfinite(jt.train_autoencoder())
    assert "restored autoencoder train state" in capsys.readouterr().out
    assert (tmp_path / "ckpt" / "autoencoder_epoch_2").exists()
    jt.close()


def test_jax_serves_a_port_trained_variant_model(tmp_path, data_dir):
    """A variant model the port trained and saved loads in the JAX
    trainer, whose ``complete`` matches the port's on every output."""
    trainer = _port(tmp_path, data_dir, 1)
    trainer.train_autoencoder()
    trainer.save_checkpoint("variant_final", 0, "joint")
    jt = _jax(tmp_path, data_dir, 1, use_orbax=False)
    jt.load_checkpoint("variant_final")
    pc = clouds(seed=18, bsz=3)
    ref = jnet.complete(jt.model, jnp.asarray(pc), cfg=jt.td3)
    out = tnet.complete(trainer.model, t(pc), cfg=trainer.td3)
    for k in ref:
        close_scaled(out[k], ref[k], 1e-5)
    trainer.close()
    jt.close()
