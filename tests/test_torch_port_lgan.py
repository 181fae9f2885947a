"""Port parity for phases 2 and 3: GFV extraction, dropout and spectral
norm in training, the latent GAN's training mode, the WGAN-GP penalty with
its double backward, and whole D, G and combined LGAN steps, against the
JAX package on the same numpy weights and JAX's replayed draws. CPU, small
widths. The RL phase is in tests/test_torch_port_rl.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu import nn as jnn
from gan_rl_3d_tpu.models import latent_gan as jlg
from gan_rl_3d_tpu.ops import losses as jlosses
from gan_rl_3d_tpu.ops import pointcloud as jpc
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch import nn as tnn
from gan_rl_3d_tpu_torch.models import latent_gan as tlg
from gan_rl_3d_tpu_torch.ops import losses as tlosses
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_modules import (N_POINTS, _randomise_norms, close,
                                     small_config, small_model_tree, t)
from test_torch_port_train import clouds, jax_draws, leaf_tensors

LGAN = small_config().model.lgan
D_DIMS = LGAN.discriminator_dims
BSZ = 6


def close_scaled(port, ref, tol):
    """max |port - ref| <= tol * max(1, max |ref|)."""
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"{err} > {tol} * {scale}"


def assert_trees_scaled(port, ref, tol):
    port_l = tree_leaves(port)
    ref_l = jax.tree.leaves(ref)
    assert len(port_l) == len(ref_l)
    for a, b in zip(port_l, ref_l):
        close_scaled(a, b, tol)


def assert_update_close(port, ref, start, tol, noise_tol):
    """A network's parameters after Adam updates against JAX's, both from
    ``start``: each leaf's update (new - start) within ``tol`` of the
    largest element of JAX's update of that network, so that a port whose
    Adam did nothing, or took the wrong lr or betas, fails. The leaves
    Adam makes noise of (chip_smoke.adam_noise: their true gradient is 0,
    so last-bit gradients become steps of up to lr either way) are held to
    ``noise_tol`` absolute instead. Where JAX left the network as it was,
    the port must have too."""
    leaves = list(zip(chip_smoke._named_leaves(port), jax.tree.leaves(ref),
                      jax.tree.leaves(start)))
    assert len(leaves) == len(tree_leaves(port)) == len(jax.tree.leaves(ref))
    moved = max(float(np.abs(np.asarray(r, np.float64) - s).max())
                for _, r, s in leaves)
    for (path, p), r, s in leaves:
        err = float(np.abs(np.asarray(p.detach(), np.float64)
                           - np.asarray(r, np.float64)).max())
        if chip_smoke.adam_noise(path, port):
            assert err <= noise_tol, (path, err, noise_tol)
        else:
            assert err <= tol * moved, (path, err, tol, moved)


def small_lgan(seed=3):
    """JAX LGAN params and state (numpy) at the SMALL widths."""
    p, s = jlg.lgan_init(jax.random.PRNGKey(seed), LGAN.z_dim, LGAN.latent_dim,
                         LGAN.generator_dims, D_DIMS)
    rng = np.random.RandomState(seed)
    return (_randomise_norms(jax.tree.map(np.asarray, p), rng),
            _randomise_norms(jax.tree.map(np.asarray, s), rng))


def real_gfvs(seed, shape):
    return np.tanh(np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def jax_keep_masks(key, bsz, dims=D_DIMS, rate=0.3):
    """The keep masks discriminator_apply(..., dropout_key=key) draws
    (latent_gan.py:108-128): one key per layer, hidden layers only."""
    keys = jax.random.split(key, len(dims))
    return [torch.from_numpy(np.array(jax.random.bernoulli(
        keys[i], 1.0 - rate, (bsz, d)))) for i, d in enumerate(dims[:-1])
            ] + [None]


def jax_d_draws(key, bsz, z_dim=LGAN.z_dim):
    """The draws of jsteps.lgan_d_step(key) (steps.py:383-384)."""
    k_z, k_real, k_fake, k_alpha, k_gp = jax.random.split(key, 5)
    return {"z": t(jax.random.normal(k_z, (bsz, z_dim))),
            "keep_real": jax_keep_masks(k_real, bsz),
            "keep_fake": jax_keep_masks(k_fake, bsz),
            "alpha": t(jax.random.uniform(k_alpha, (bsz, 1), jnp.float32)),
            "keep_gp": jax_keep_masks(k_gp, bsz)}


def jax_g_draws(key, bsz, z_dim=LGAN.z_dim):
    k_z, k_drop = jax.random.split(key)
    return {"z": t(jax.random.normal(k_z, (bsz, z_dim))),
            "keep": jax_keep_masks(k_drop, bsz)}


def jax_combined_draws(key, bsz, d_steps):
    k_scan, k_g = jax.random.split(key)
    return {"d": [jax_d_draws(k, bsz)
                  for k in jax.random.split(k_scan, d_steps)],
            "g": jax_g_draws(k_g, bsz)}


# ---------------------------------------------------------------------------
# nn: dropout, spectral norm in training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("rate", [0.3, 0.0])
def test_dropout_matches_jax(training, rate):
    key = jax.random.PRNGKey(2)
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    ref = jnn.dropout(key, x, rate, training=training)
    mask = (torch.from_numpy(np.array(jax.random.bernoulli(
        key, 1.0 - rate, x.shape))) if training else None)
    out = tnn.dropout(t(x), mask, rate)
    close(out, ref, 0.0)
    if training and rate:
        assert 0 < int((out == 0).sum()) < x.size


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("n_iter", [1, 3])
def test_spectral_norm_apply_matches_jax(training, n_iter):
    rng = np.random.RandomState(1)
    w = rng.randn(12, 7).astype(np.float32)
    sn = jax.tree.map(np.asarray,
                      jnn.spectral_norm_init(jax.random.PRNGKey(4), (12, 7)))
    ref, ref_s = jnn.spectral_norm_apply(w, sn, training=training,
                                         n_iter=n_iter)
    tw = t(w).requires_grad_(True)
    out, new_s = tnn.spectral_norm_apply(tw, tree_map(t, sn),
                                         training=training, n_iter=n_iter)
    # without a power iteration sigma is that of random u, v: w / sigma
    # reaches ~50, and f32 rounding is relative
    close_scaled(out, ref, 1e-6)
    for k in ("u", "v"):
        close(new_s[k], ref_s[k], 1e-6)
        assert not new_s[k].requires_grad
    # sigma stays a function of w: the gradient w.r.t. w matches
    g = rng.randn(12, 7).astype(np.float32)
    ref_g = jax.grad(lambda w_: jnp.sum(jnn.spectral_norm_apply(
        w_, sn, training=training, n_iter=n_iter)[0] * g))(w)
    (out * t(g)).sum().backward()
    close_scaled(tw.grad, ref_g, 1e-5)


# ---------------------------------------------------------------------------
# the latent GAN in training
# ---------------------------------------------------------------------------


def test_latent_gan_training_mode_matches_jax():
    p, s = small_lgan()
    z = np.random.RandomState(5).randn(BSZ, LGAN.z_dim).astype(np.float32)
    ref, ref_s = jlg.generator_apply(p["generator"], s["generator"], z,
                                     training=True)
    out, new_s = tlg.generator_apply(tree_map(t, p["generator"]),
                                     tree_map(t, s["generator"]), t(z),
                                     training=True)
    close(out, ref, 1e-5)
    assert_trees_scaled(new_s, ref_s, 1e-6)
    gfv = real_gfvs(6, (BSZ, LGAN.latent_dim))
    key = jax.random.PRNGKey(8)
    ref, ref_s = jlg.discriminator_apply(p["discriminator"], s["discriminator"],
                                         gfv, training=True, dropout_key=key)
    out, new_s = tlg.discriminator_apply(
        tree_map(t, p["discriminator"]), tree_map(t, s["discriminator"]),
        t(gfv), training=True, keep_masks=jax_keep_masks(key, BSZ))
    close_scaled(out, ref, 1e-5)
    assert_trees_scaled(new_s, ref_s, 1e-6)
    # the port's own masks: booleans of the hidden widths, None last
    masks = tlg.draw_dropout_masks(torch.Generator().manual_seed(0), BSZ,
                                   D_DIMS)
    assert [m.shape for m in masks[:-1]] == [(BSZ, d) for d in D_DIMS[:-1]]
    assert masks[-1] is None and masks[0].dtype == torch.bool


def test_gradient_penalty_and_its_weight_gradient_match_jax():
    """The penalty and its gradient w.r.t. D's weights: the double
    backward through spectral norm, LayerNorm, LeakyReLU and dropout."""
    p, s = small_lgan(seed=4)
    d_p, d_s = p["discriminator"], s["discriminator"]
    real = real_gfvs(7, (BSZ, LGAN.latent_dim))
    fake = real_gfvs(8, (BSZ, LGAN.latent_dim))
    k_alpha, k_drop = jax.random.split(jax.random.PRNGKey(9))

    def jax_gp(params):
        return jlosses.gradient_penalty(
            lambda x: jlg.discriminator_apply(params, d_s, x, training=True,
                                              dropout_key=k_drop)[0],
            k_alpha, real, fake, lambda_gp=10.0)

    ref, ref_g = jax.value_and_grad(jax_gp)(d_p)
    tp = leaf_tensors(d_p)
    ts = tree_map(t, d_s)
    masks = jax_keep_masks(k_drop, BSZ)
    gp = tlosses.gradient_penalty(
        lambda x: tlg.discriminator_apply(tp, ts, x, training=True,
                                          keep_masks=masks)[0],
        t(jax.random.uniform(k_alpha, (BSZ, 1), jnp.float32)), t(real),
        t(fake), lambda_gp=10.0)
    close_scaled(gp.detach(), ref, 1e-5)
    # the last layer's bias leaves the input gradient alone: no gradient
    grads = torch.autograd.grad(gp, tree_leaves(tp), allow_unused=True)
    for g, r in zip(grads, jax.tree.leaves(ref_g)):
        close_scaled(torch.zeros(r.shape) if g is None else g, r, 1e-5)


def test_gan_losses_match_jax():
    rng = np.random.RandomState(10)
    real, fake = rng.randn(7, 1).astype(np.float32), rng.randn(7, 1).astype(
        np.float32)
    for kind in ("wgan-gp", "lsgan", "bce"):
        close(tlosses.discriminator_loss(t(real), t(fake), kind),
              jlosses.discriminator_loss(real, fake, kind), 1e-6)
        close(tlosses.generator_loss(t(fake), kind),
              jlosses.generator_loss(fake, kind), 1e-6)
    a, b = real_gfvs(11, (5, 9)), real_gfvs(12, (5, 9))
    close(tlosses.gfv_loss(t(a), t(b)), jlosses.gfv_loss(a, b), 1e-7)


# ---------------------------------------------------------------------------
# whole LGAN steps
# ---------------------------------------------------------------------------


ADAM_LR = 1e-4


def _optimizers(p, kind, lr=ADAM_LR, betas=(0.5, 0.9)):
    """The JAX and the port's G and D optimizers of one kind, both sides
    from one leaf order. "sgd" (lr 0.05) holds the steps' arithmetic to
    1e-5: a parameter moves by lr times its gradient. "adam" is the
    trainer's (make_gan_optimizer, betas 0.5 / 0.9, lr 1e-4); ``lr`` and
    ``betas`` change the port's side alone, to show what the test
    catches."""
    tp = leaf_tensors(p)
    if kind == "sgd":
        return (optax.sgd(0.05), tp,
                torch.optim.SGD(tree_leaves(tp["generator"]), lr=0.05),
                torch.optim.SGD(tree_leaves(tp["discriminator"]), lr=0.05))
    tc = tcfg.LGANTrainConfig(beta1=betas[0], beta2=betas[1])
    return (jsteps.make_gan_optimizer(
        ADAM_LR, jcfg.LGANTrainConfig(beta1=0.5, beta2=0.9)), tp,
            tsteps.make_gan_optimizer(tp["generator"], lr, tc),
            tsteps.make_gan_optimizer(tp["discriminator"], lr, tc))


def test_lgan_d_and_generator_steps_match_jax():
    p, s = small_lgan(seed=5)
    jopt, tp, g_opt, d_opt = _optimizers(p, "sgd")
    ts = tree_map(t, s)
    real = real_gfvs(13, (BSZ, LGAN.latent_dim))
    key = jax.random.PRNGKey(14)
    jp, js, _, m = jsteps.lgan_d_step(
        p, s, jopt.init(p["discriminator"]), real, key, d_opt=jopt,
        lambda_gp=10.0, z_dim=LGAN.z_dim)
    ts, tm = tsteps.lgan_d_step(tp, ts, d_opt, t(real),
                                jax_d_draws(key, BSZ), lambda_gp=10.0)
    for k in ("d_loss", "wasserstein", "gp"):
        close_scaled(tm[k], m[k], 1e-5)
    assert_trees_scaled(tp, jp, 1e-5)
    assert_trees_scaled(ts, js, 1e-5)
    key = jax.random.PRNGKey(15)
    jp, js, _, m = jsteps.lgan_generator_step(
        jp, js, jopt.init(p["generator"]), key, g_opt=jopt, batch_size=BSZ,
        z_dim=LGAN.z_dim)
    ts, tm = tsteps.lgan_generator_step(tp, ts, g_opt, jax_g_draws(key, BSZ))
    close_scaled(tm["g_loss"], m["g_loss"], 1e-5)
    assert_trees_scaled(tp, jp, 1e-5)
    assert_trees_scaled(ts, js, 1e-5)


def _combined_steps(d_steps, kind, n_steps=2, **adam):
    p, s = small_lgan(seed=6)
    jopt, tp, g_opt, d_opt = _optimizers(p, kind, **adam)
    jp, js = p, s
    j_d, j_g = jopt.init(p["discriminator"]), jopt.init(p["generator"])
    ts = tree_map(t, s)
    losses = []
    for i in range(n_steps):
        real = real_gfvs(20 + i, (d_steps, BSZ, LGAN.latent_dim))
        key = jax.random.PRNGKey(30 + i)
        jp, js, j_d, j_g, m = jsteps.lgan_combined_step(
            jp, js, j_d, j_g, real, key, d_opt=jopt, g_opt=jopt,
            lambda_gp=10.0, z_dim=LGAN.z_dim, d_steps=d_steps)
        ts, tm = tsteps.lgan_combined_step(
            tp, ts, d_opt, g_opt, t(real),
            jax_combined_draws(key, BSZ, d_steps), lambda_gp=10.0)
        losses.append(([tm[k] for k in ("d_loss", "g_loss")],
                       [m[k] for k in ("d_loss", "g_loss")]))
    return losses, tp, jp, ts, js


@pytest.mark.parametrize("d_steps", [1, 3])
def test_lgan_combined_step_matches_jax(d_steps):
    """Two combined steps (d_steps D updates, then a G update, each)."""
    losses, tp, jp, ts, js = _combined_steps(d_steps, "sgd")
    for port, ref in losses:
        for a, b in zip(port, ref):
            close_scaled(a, b, 1e-5)
    assert_trees_scaled(tp, jp, 1e-5)
    assert_trees_scaled(ts, js, 1e-5)


def _assert_adam_steps_match(losses, tp, jp, ts, js):
    """Two combined steps with Adam: D takes 6 updates, G 2. The losses
    and the spectral-norm vectors and BN variances within 1e-5 scaled;
    each network's update within 1e-3 of its largest element
    (assert_update_close); the Adam-noise leaves, the biases ahead of G's
    training BatchNorms and the running means that take them in, within
    2 lr an update. Measured: 1.5e-8 in an update whose largest element
    is 2e-4, 2.5e-4 in such a bias."""
    for port, ref in losses:
        for a, b in zip(port, ref):
            close_scaled(a, b, 1e-5)
    start_p, start_s = small_lgan(seed=6)
    for net, updates in (("generator", 2), ("discriminator", 6)):
        noise_tol = 2 * ADAM_LR * updates
        assert_update_close(tp[net], jp[net], start_p[net], 1e-3, noise_tol)
        for (path, p), r in zip(chip_smoke._named_leaves(ts[net]),
                                jax.tree.leaves(js[net])):
            if chip_smoke.adam_noise(path, ts[net]):
                close(p, r, noise_tol)
            else:
                close_scaled(p, r, 1e-5)


def test_lgan_combined_step_with_the_trainers_adam_matches_jax():
    """The trainer's optimizer: torch's Adam against optax.adam. Adam
    divides each gradient element by its own RMS, so an element whose true
    gradient is 0 turns last-bit differences into steps of up to lr either
    way: see _assert_adam_steps_match for the tolerances (the steps' own
    arithmetic is held to 1e-5 with SGD above)."""
    _assert_adam_steps_match(*_combined_steps(3, "adam"))


@pytest.mark.parametrize("adam", [dict(lr=0.0), dict(lr=2 * ADAM_LR),
                                  dict(betas=(0.9, 0.999))])
def test_lgan_adam_check_catches_a_wrong_optimizer(adam):
    """The same comparison fails when the port's Adam takes lr 0, twice
    the lr, or optax's default betas instead of the recipe's."""
    with pytest.raises(AssertionError):
        _assert_adam_steps_match(*_combined_steps(3, "adam", **adam))


def test_lgan_d_refresh_matches_jax():
    p, s = small_lgan(seed=7)
    jopt, tp, _, d_opt = _optimizers(p, "sgd")
    real = real_gfvs(40, (2, BSZ, LGAN.latent_dim))
    key = jax.random.PRNGKey(41)
    jp, js, _, m = jsteps.lgan_d_refresh(
        p, s, jopt.init(p["discriminator"]), real, key, d_opt=jopt,
        lambda_gp=10.0, z_dim=LGAN.z_dim)
    ts, tm = tsteps.lgan_d_refresh(
        tp, tree_map(t, s), d_opt, t(real),
        [jax_d_draws(k, BSZ) for k in jax.random.split(key, 2)],
        lambda_gp=10.0)
    close_scaled(tm["d_losses"], m["d_losses"], 1e-5)
    assert_trees_scaled(tp, jp, 1e-5)
    assert_trees_scaled(ts, js, 1e-5)


def test_port_lgan_draws_drive_a_finite_step():
    """The port's own draws (a generator's stream) have the shapes the
    step needs, and two steps from one seed agree bit for bit."""
    p, s = small_lgan(seed=8)
    results = []
    for _ in range(2):
        _, tp, g_opt, d_opt = _optimizers(p, "adam")
        gen = torch.Generator().manual_seed(3)
        draws = tsteps.draw_lgan_combined(gen, BSZ, LGAN.z_dim, D_DIMS, 2)
        _, m = tsteps.lgan_combined_step(
            tp, tree_map(t, s), d_opt, g_opt,
            t(real_gfvs(50, (2, BSZ, LGAN.latent_dim))), draws)
        results.append((float(m["d_loss"]), float(m["g_loss"]),
                        tree_leaves(tp)))
    (d0, g0, p0), (d1, g1, p1) = results
    assert np.isfinite([d0, g0]).all() and (d0, g0) == (d1, g1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# ---------------------------------------------------------------------------
# phase 2: GFV extraction
# ---------------------------------------------------------------------------


def test_gfv_extract_step_matches_jax():
    _, tree = small_model_tree(seed=2)
    ae_p, ae_s = tree["ae"]["params"], tree["ae"]["state"]
    pc = clouds(seed=3, bsz=4)
    key = jax.random.PRNGKey(4)
    spec = jpc.PreprocSpec()
    ref_clean, ref_noisy = jsteps.gfv_extract_step(
        ae_p, ae_s, {"complete_pc": jnp.asarray(pc)}, key, spec=spec)
    clean, noisy = tsteps.gfv_extract_step(
        tree_map(t, ae_p), tree_map(t, ae_s), {"complete_pc": t(pc)},
        jax_draws(key, 4, N_POINTS, spec))
    close_scaled(clean, ref_clean, 1e-5)
    close_scaled(noisy, ref_noisy, 1e-5)
    assert not np.allclose(clean.numpy(), noisy.numpy())
