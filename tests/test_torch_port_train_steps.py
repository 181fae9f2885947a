"""Port parity for whole autoencoder train steps (f32 and bf16_selective),
from the same weights, batches and draws as the JAX package. CPU, small
widths; the shared helpers are in tests/test_torch_port_train.py."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.ops import pointcloud as jpc
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch.ops import pointcloud as tpc
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_modules import N_POINTS, t
from test_torch_port_train import (B, assert_trees_close, clouds, jax_draws,
                                   leaf_tensors, small_ae)


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


def _step_inputs(i):
    """Step i's batch (a wrap-around padded row on odd steps) and key."""
    pad = np.zeros(B, np.float32)
    pad[-1] = float(i % 2)
    return ({"complete_pc": clouds(seed=20 + i), "pad": pad},
            jax.random.PRNGKey(30 + i))


def _run_steps(precision, n_steps, bn_stats="single_read_grouped",
               recon_loss="chamfer"):
    """n_steps of ae_train_step in both packages from the same weights,
    batches and draws; returns (port losses, JAX losses, port params, JAX
    params, port state, JAX state). The port's params keep the gradients
    of the last step in ``.grad``."""
    p, s = small_ae(seed=9)
    cfg = dict(epochs=2, lr_schedule="cosine")
    spe = 2
    jopt = jsteps.make_ae_optimizer(jcfg.AETrainConfig(**cfg), spe)
    jparams, jstate, jopt_state = p, s, jopt.init(p)
    tparams, tstate = leaf_tensors(p), tree_map(t, s)
    topt, sched = tsteps.make_ae_optimizer(tparams, tcfg.AETrainConfig(**cfg),
                                           spe)
    dtype, selective = tsteps.compute_dtype_of(precision)
    jdtype = jnp.bfloat16 if dtype is not None else None
    spec = jpc.PreprocSpec()
    tspec = tpc.PreprocSpec()
    losses, ref_losses = [], []
    for i in range(n_steps):
        batch, key = _step_inputs(i)
        jparams, jstate, jopt_state, m = jsteps.ae_train_step(
            jparams, jstate, jopt_state, jax.tree.map(jnp.asarray, batch), key,
            optimizer=jopt, compute_dtype=jdtype, spec=spec,
            selective=selective, bn_stats=bn_stats, recon_loss=recon_loss)
        ref_losses.append(float(m["loss"]))
        k_data, _ = jax.random.split(key)
        tstate, tm = tsteps.ae_train_step(
            tparams, tstate, topt, tree_map(t, batch),
            jax_draws(k_data, B, N_POINTS, spec), scheduler=sched,
            compute_dtype=dtype, spec=tspec, selective=selective,
            bn_stats=bn_stats, recon_loss=recon_loss)
        losses.append(float(tm["loss"]))
    return losses, ref_losses, tparams, jparams, tstate, jstate


@pytest.mark.parametrize("recon_loss,loss_rtol,param_atol",
                         [("chamfer", 1e-4, 1e-3), ("mse", 1e-5, 5e-4)])
def test_three_f32_ae_train_steps_match_jax(recon_loss, loss_rtol,
                                            param_atol):
    """Three f32 steps from the same weights, batches and draws. The
    tolerances are set by two effects, not by the port's arithmetic
    (one step's gradients agree within 6e-6 of their largest element on
    identical inputs with a linear loss):
    * Adam divides each gradient element by its own RMS, so elements near
      0 (the biases ahead of a training BN have a true gradient of 0) turn
      last-bit differences into parameter differences of up to ~lr / 10:
      measured 1e-4 to 2e-4 after 3 steps with the MSE loss;
    * the Chamfer loss picks nearest neighbours, and at this random init
      the closest competing pair is 6e-6 apart in squared distance, so a
      last-bit difference of the reconstruction can flip one point's
      neighbour: measured loss 1.8e-5 relative and params 5.4e-4."""
    losses, ref_losses, tp, jp, ts, js = _run_steps("float32", 3,
                                                    recon_loss=recon_loss)
    np.testing.assert_allclose(losses, ref_losses, rtol=loss_rtol)
    assert_trees_close(tp, jp, param_atol)
    assert_trees_close(ts, js, 1e-4)


def _jax_step_grads(compute_dtype, selective, recon_loss):
    """jax.grad of the loss of the JAX package's first step, read through
    the step itself: with optax.identity() as the optimizer it returns
    params + grads (the subtraction rounds at 6e-8 of |params| <= 1)."""
    p, s = small_ae(seed=9)
    batch, key = _step_inputs(0)
    new_p, _, _, _ = jsteps.ae_train_step(
        p, s, optax.EmptyState(), jax.tree.map(jnp.asarray, batch), key,
        optimizer=optax.identity(), compute_dtype=compute_dtype,
        spec=jpc.PreprocSpec(), selective=selective,
        bn_stats="single_read_grouped", recon_loss=recon_loss)
    return [np.asarray(a) - b for a, b in zip(jax.tree.leaves(new_p),
                                              jax.tree.leaves(p))]


def _grad_errors(port_params, ref):
    """The port's ``.grad`` against ``ref``: (the largest error over all
    leaves relative to the largest element, the largest error relative to
    its leaf's largest element over the leaves whose largest element is at
    least 1e-2 of that). The second leaves out the biases ahead of a
    training BN, whose true gradient is near 0."""
    grads = [v.grad.numpy() for v in tree_leaves(port_params)]
    assert len(grads) == len(ref)
    scale = max(np.abs(r).max() for r in ref)
    errs = [(np.abs(g - r).max(), np.abs(r).max()) for g, r in zip(grads, ref)]
    return (max(e for e, _ in errs) / scale,
            max(e / m for e, m in errs if m >= 1e-2 * scale))


def test_bf16_selective_ae_train_step_matches_jax():
    """bf16_selective with the Chamfer loss, the main path's recipe. Both
    packages round the same operands to bf16 but sum in another order, so
    the loss and the new BN state are held to 2e-2 relative. The step's
    gradients are held against jax.grad of the JAX step's loss to 0.25 of
    the largest element: each point's Chamfer gradient is g times a unit
    vector towards its neighbour, and for a near neighbour that vector
    turns with the bf16 rounding of the reconstruction (measured 0.125;
    5.7e-4 on a batch where the two forwards round alike; the same
    reading between bf16_selective and f32 gradients, as a control, is
    0.62). A gradient scaled by 0.8 reads 0.29. The MSE test below holds
    the bf16 backward itself tighter."""
    losses, ref_losses, tp, jp, ts, js = _run_steps("bf16_selective", 1)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2)
    for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 2e-2 * np.abs(b).max()
    overall, _ = _grad_errors(tp, _jax_step_grads(jnp.bfloat16, True,
                                                  "chamfer"))
    assert overall <= 0.25, overall


def test_bf16_selective_ae_step_gradients_match_jax_with_mse():
    """The bf16 backward without the Chamfer loss's turning directions:
    the MSE loss. Gradients against jax.grad of the JAX step's loss, to
    3e-2 of the largest element and 1e-1 of each leaf's (measured 8.7e-3
    and 2.5e-2; the bf16_selective vs f32 control reads 0.40 and 0.94,
    and a gradient scaled by 0.8 reads 0.20 and 0.21)."""
    losses, ref_losses, tp, *_ = _run_steps("bf16_selective", 1,
                                            recon_loss="mse")
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2)
    overall, per_leaf = _grad_errors(tp, _jax_step_grads(jnp.bfloat16, True,
                                                         "mse"))
    assert overall <= 3e-2 and per_leaf <= 1e-1, (overall, per_leaf)
