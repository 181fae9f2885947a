"""One step after a mid-phase resume, port against JAX, on the CPU: each
phase's train state, written by the JAX trainer as an orbax directory,
restored by both trainers, then one step of the phase on each side from
the same weights, restored state, batch and draws (the ``jax_draws``
helpers), held to the existing step tolerances of
tests/test_torch_port_train_steps.py, test_torch_port_lgan.py,
test_torch_port_rl.py and test_torch_port_joint.py."""

import jax
import jax.numpy as jnp
import numpy as np

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu.utils import checkpoint as jckpt
from gan_rl_3d_tpu_torch.convert import (agent_from_numpy, buffer_from_numpy,
                                         model_from_numpy)
from gan_rl_3d_tpu_torch.train import replay_buffer as trb
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_lgan import (assert_update_close, close_scaled,
                                  jax_combined_draws)
from test_torch_port_modules import N_POINTS, t
from test_torch_port_resume import (  # noqa: F401 (fixtures)
    ENVS, data_dir, jax_states, port_optimizers, port_trainer, tiny)
from test_torch_port_rl import (JCFG, PCFG, _assert_agent_after_updates,
                                jax_rl_draws, model_tree)
from test_torch_port_train import B, assert_trees_close, clouds, jax_draws


def restored_pair(root, data, phase):
    """(JAX config, JAX model tree as orbax restores it, port trainer with
    the checkpoint loaded, the port's restored train state)."""
    cfg = jcfg.load_config(None, overrides=tiny(root, data))
    tree = jckpt.load_checkpoint(str(root / "ckpt" / f"{phase}_resume"))
    trainer = port_trainer(root, data)
    trainer.load_checkpoint(f"{phase}_resume")
    return cfg, tree["model"], trainer, trainer._restore_train_state(phase)


def test_ae_step_after_resume_matches_jax(jax_states, data_dir):
    """The chain's Adam moments and schedule count both restored: the
    f32 step's loss within 1e-4, parameters 1e-3, BN state 1e-4
    (test_three_f32_ae_train_steps_match_jax's Chamfer tolerances)."""
    root, restored = jax_states
    cfg, tree, trainer, rst = restored_pair(root, data_dir, "autoencoder")
    t_cfg = cfg.training
    jopt = jsteps.make_ae_optimizer(t_cfg.autoencoder,
                                    len(trainer.train_loader))
    opts = port_optimizers(trainer, "autoencoder", rst)
    topt, params = opts["opt"]
    batch = {"complete_pc": clouds(seed=40), "pad": np.zeros(B, np.float32)}
    key = jax.random.PRNGKey(41)
    start = jax.tree.map(np.array, tree["ae"]["params"])
    jp, js, _, m = jsteps.ae_train_step(
        jax.tree.map(jnp.array, start), tree["ae"]["state"],
        restored["autoencoder"]["opt_state"],
        jax.tree.map(jnp.asarray, batch), key, optimizer=jopt,
        spec=cfg.preproc_spec(), bn_stats=t_cfg.bn_stats)
    k_data, _ = jax.random.split(key)
    ts, tm = tsteps.ae_train_step(
        params, trainer.model["ae"]["state"], topt, tree_map(t, batch),
        jax_draws(k_data, B, N_POINTS, trainer.preproc),
        scheduler=opts["sched"], spec=trainer.preproc,
        bn_stats=trainer.bn_stats)
    np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                               rtol=1e-4)
    assert_trees_close(params, jp, 1e-3)
    assert_trees_close(ts, js, 1e-4)
    assert max(float(np.abs(np.asarray(a) - b).max())
               for a, b in zip(jax.tree.leaves(jp),
                               jax.tree.leaves(start))) > 1e-3


def test_lgan_step_after_resume_matches_jax(jax_states, data_dir):
    """Both Adams restored; one combined step (a D update, a G update):
    losses 1e-5, each network's update 1e-3 of its largest element, the
    Adam-noise leaves 2 lr (_assert_adam_steps_match's tolerances)."""
    root, restored = jax_states
    cfg, tree, trainer, rst = restored_pair(root, data_dir, "lgan")
    lc = cfg.training.lgan
    g_opt = jsteps.make_gan_optimizer(lc.generator_lr, lc)
    d_opt = jsteps.make_gan_optimizer(lc.discriminator_lr, lc)
    opts = port_optimizers(trainer, "lgan", rst)
    params = trainer.model["lgan"]["params"]
    for v in tree_leaves(params):
        v.requires_grad_(True)
    real = np.tanh(np.random.RandomState(42).randn(1, 8, 32)).astype(
        np.float32)
    key = jax.random.PRNGKey(43)
    ref = restored["lgan"]
    jp, js, _, _, m = jsteps.lgan_combined_step(
        tree["lgan"]["params"], tree["lgan"]["state"], ref["d_opt_state"],
        ref["g_opt_state"], real, key, d_opt=d_opt, g_opt=g_opt,
        lambda_gp=lc.lambda_gp, z_dim=cfg.model.lgan.z_dim, d_steps=1)
    _, tm = tsteps.lgan_combined_step(
        params, trainer.model["lgan"]["state"], opts["d_opt_state"][0],
        opts["g_opt_state"][0], t(real), jax_combined_draws(key, 8, 1),
        lambda_gp=lc.lambda_gp)
    for k in ("d_loss", "g_loss"):
        close_scaled(tm[k], m[k], 1e-5)
    for net in ("generator", "discriminator"):
        assert_update_close(params[net], jp[net],
                            tree["lgan"]["params"][net], 1e-3,
                            2 * lc.generator_lr)


def test_rl_step_after_resume_matches_jax(jax_states, data_dir):
    """The restored replay ring and OU state, then one rl_step (8 envs, 2
    TD3 updates from the restored rows): rewards 1e-5, OU 1e-6, the ring,
    and the agent (_assert_agent_after_updates) as
    test_rl_step_matches_jax holds them. The agent's own Adam rides in the
    model checkpoint, not in the train state."""
    root, restored = jax_states
    cfg, _, trainer, rst = restored_pair(root, data_dir, "rl_agent")
    ref = restored["rl_agent"]
    # the networks of test_rl_step_matches_jax (norms randomised, so no
    # gradient element sits at rounding level, where a fresh Adam's first
    # step, lr x sign(gradient), would flip)
    tree = model_tree(seed=15)
    buf = buffer_from_numpy(rst["buffer"], trb.ReplayBuffer(32, 32, 4))
    pc = clouds(seed=44, bsz=ENVS)
    pad = np.zeros(ENVS, np.float32)
    key = jax.random.PRNGKey(45)
    kw = dict(w_chamfer=100.0, w_gfv=10.0, w_discriminator=0.01,
              start_training_size=8, steps_per_episode=1, updates_per_step=2)
    jmodel, jbuf, jou, jm = jsteps.rl_step(
        jax.tree.map(jnp.array, tree), ref["buffer"], ref["ou"],
        {"complete_pc": jnp.asarray(pc), "pad": jnp.asarray(pad)}, key,
        cfg=JCFG, spec=cfg.preproc_spec(), **kw)
    model = {**model_from_numpy(tree, device="cpu"),
             "agent": agent_from_numpy(tree["agent"], PCFG, device="cpu")}
    draws = jax_rl_draws(key, ENVS, trainer.preproc,
                         size_after=min(int(ref["buffer"].size) + ENVS, 32),
                         steps_per_episode=1, updates_per_step=2)
    model, buf, ou, m = tsteps.rl_step(
        model, buf, t(np.asarray(rst["ou"])),
        {"complete_pc": t(pc), "pad": t(pad)}, draws, cfg=PCFG,
        spec=trainer.preproc, **kw)
    close_scaled(m["reward"], jm["reward"], 1e-5)
    close_scaled(ou, jou, 1e-6)
    assert (buf.size, buf.ptr) == (int(jbuf.size), int(jbuf.ptr))
    for name in trb.FIELDS:
        close_scaled(getattr(buf, name), getattr(jbuf, name), 1e-5)
    _assert_agent_after_updates(model["agent"], jmodel["agent"],
                                tree["agent"], 2)


def test_joint_step_after_resume_matches_jax(jax_states, data_dir):
    """The chain's Adam moments restored, one f32 joint step: loss 1e-5
    relative, each network's update within 1e-3 of its largest element
    (_assert_joint_updates), the Adam-noise leaves 2 lr."""
    root, restored = jax_states
    cfg, tree, trainer, rst = restored_pair(root, data_dir, "joint")
    jc = cfg.training.joint
    opts = port_optimizers(trainer, "joint", rst)
    topt, trainable = opts["opt"]
    batch = {"complete_pc": clouds(seed=46), "pad": np.zeros(B, np.float32)}
    key = jax.random.PRNGKey(47)
    jmodel, _, jm = jsteps.joint_train_step(
        jax.tree.map(jnp.asarray, tree), restored["joint"]["opt_state"],
        jax.tree.map(jnp.asarray, batch), key,
        optimizer=jsteps.make_joint_optimizer(jc), cfg=JCFG,
        spec=cfg.preproc_spec(), bn_stats=cfg.training.bn_stats,
        w_ae_recon=jc.w_ae_recon)
    k_data, _ = jax.random.split(key)
    model = trainer.model
    for v in tree_leaves(trainable):
        v.requires_grad_(True)
    _, m = tsteps.joint_train_step(
        model, topt, tree_map(t, batch),
        jax_draws(k_data, B, N_POINTS, trainer.preproc), cfg=PCFG,
        spec=trainer.preproc, bn_stats=trainer.bn_stats,
        w_ae_recon=jc.w_ae_recon)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    ref = {"ae": jmodel["ae"]["params"],
           "gen": jmodel["lgan"]["params"]["generator"]}
    start = {"ae": tree["ae"]["params"],
             "gen": tree["lgan"]["params"]["generator"]}
    for k in ("ae", "gen"):
        assert_update_close(trainable[k], ref[k], start[k], 1e-3, 2 * jc.lr)
