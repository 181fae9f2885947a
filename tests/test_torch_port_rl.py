"""Port parity for phase 4: the critic, the TD3 update over consecutive
updates (skip, update and ramp), the replay ring, the reward, whole RL
steps and the greedy eval, the agent's numpy bridge with its Adam moments,
and the slice end to end through the CLI (phases 1-4 on the CPU, JAX
reading the port's RL checkpoint and the port reading JAX's). Against the
JAX package on the same numpy weights and JAX's replayed draws; CPU, small
widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import card_checks
from gan_rl_3d_tpu.models import rl_agent as jrl
from gan_rl_3d_tpu.models import rl_gan_net as jnet
from gan_rl_3d_tpu.ops import losses as jlosses
from gan_rl_3d_tpu.ops import pointcloud as jpc
from gan_rl_3d_tpu.train import replay_buffer as jrb
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu.utils import checkpoint as jckpt
from gan_rl_3d_tpu_torch.convert import (agent_from_numpy, agent_to_numpy,
                                         model_from_numpy)
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.models import rl_agent as trl
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.ops import losses as tlosses
from gan_rl_3d_tpu_torch.train import replay_buffer as trb
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
from gan_rl_3d_tpu_torch.train_rl_gan_net import main as train_main
from gan_rl_3d_tpu_torch.utils import checkpoint as tckpt
from gan_rl_3d_tpu_torch.utils.tree import tree_map
from test_torch_port_lgan import (assert_trees_scaled, assert_update_close,
                                  close_scaled)
from test_torch_port_modules import (N_POINTS, SMALL, _randomise_norms,
                                     port_small_config, small_config,
                                     small_model_tree, t)
from test_torch_port_train import clouds, jax_draws, leaf_tensors

BATCH = 8
# 4 updates: 1 skips the actor (warmup), 2 updates it at ramp 1/2, 3 skips
# (delay), 4 updates at ramp 1
SCHEDULE = dict(batch_size=BATCH, policy_delay=2, actor_warmup=1,
                actor_lr_ramp=2)
JCFG = small_config().td3_config()._replace(**SCHEDULE)
PCFG = port_small_config().td3_config()._replace(**SCHEDULE)
A, S_DIM = JCFG.action_dim, JCFG.state_dim
TARGETS = tuple(n + "_target" for n in trl.NETWORKS)
UPDATE_TOL = 1e-3


def model_tree(seed=0):
    """The JAX model (numpy leaves) with randomised norms in every
    network, targets equal to their networks."""
    _, tree = small_model_tree(seed=seed)
    agent = tree["agent"]
    rng = np.random.RandomState(seed + 50)
    for name in ("critic1", "critic2"):
        agent[name] = _randomise_norms(agent[name], rng)
    for name in trl.NETWORKS:
        agent[name + "_target"] = jax.tree.map(np.copy, agent[name])
    return tree


def transitions(seed, n=BATCH):
    rng = np.random.RandomState(seed)
    return trl.TransitionBatch(
        states=rng.randn(n, S_DIM).astype(np.float32),
        actions=np.tanh(rng.randn(n, A)).astype(np.float32),
        rewards=rng.randn(n, 1).astype(np.float32),
        next_states=rng.randn(n, S_DIM).astype(np.float32),
        dones=(rng.rand(n, 1) > 0.5).astype(np.float32))


def as_jax(batch):
    return jrl.TransitionBatch(*map(jnp.asarray, batch))


def as_port(batch):
    return trl.TransitionBatch(*map(t, batch))


def assert_agents_close(port_agent, jagent, tol):
    """Every network and target (params and BN state), the Adam moments
    and counts, the step."""
    port = agent_to_numpy(port_agent)
    for name in trl.NETWORKS + TARGETS:
        assert_trees_scaled(port[name], jagent[name], tol)
    for name in trl.NETWORKS:
        ref = jagent["opt"][name][0]
        assert int(port["opt"][name]["count"]) == int(ref.count)
        for k in ("mu", "nu"):
            assert_trees_scaled(port["opt"][name][k], getattr(ref, k), tol)
    assert int(port["step"]) == int(jagent["step"])


agent_update_jit = jax.jit(jrl.agent_update, static_argnums=3)


# ---------------------------------------------------------------------------
# networks and the TD3 update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training", [True, False])
def test_critic_and_actor_match_jax(training):
    agent = model_tree(seed=1)["agent"]
    b = transitions(2)
    c = agent["critic1"]
    ref, ref_s = jrl.critic_apply(c["params"], c["state"], b.states,
                                  b.actions, training=training)
    q, new_s = trl.critic_apply(tree_map(t, c["params"]),
                                tree_map(t, c["state"]), t(b.states),
                                t(b.actions), training=training)
    close_scaled(q.detach(), ref, 1e-5)
    assert_trees_scaled(new_s, ref_s, 1e-6)
    a = agent["actor"]
    ref, ref_s = jrl.actor_apply(a["params"], a["state"], b.states, cfg=JCFG,
                                 training=training)
    act, new_s = trl.actor_apply(tree_map(t, a["params"]),
                                 tree_map(t, a["state"]), t(b.states),
                                 cfg=PCFG, training=training)
    close_scaled(act.detach(), ref, 1e-6)
    assert_trees_scaled(new_s, ref_s, 1e-6)


def test_td3_config_and_critic_widths_match_jax():
    assert tuple(PCFG) == tuple(JCFG)
    assert trl.TD3Config()._fields == jrl.TD3Config._fields
    assert tuple(trl.TD3Config()) == tuple(jrl.TD3Config())
    for hidden in ((400, 432, 300, 300), (40, 50, 60)):
        assert trl._critic_widths(hidden) == jrl._critic_widths(hidden)
    with pytest.raises(ValueError, match="3 or 4"):
        trl._critic_widths((1, 2))
    cfg = JCFG._replace(actor_lr_ramp=1500, actor_warmup=2000)
    for step in (1, 2000, 2001, 2100, 5000, 10000):
        assert trl._actor_ramp_factor(step, cfg) == pytest.approx(
            float(jrl._actor_ramp_factor(jnp.int32(step), cfg)), rel=1e-6)


def test_agent_update_matches_jax_over_four_updates():
    """Update 1 skips the actor (warmup), 2 runs it at ramp 1/2, 3 skips it
    (delay), 4 runs it at ramp 1; the targets blend only when it runs.
    See _assert_agent_after_updates for the tolerances."""
    tree = model_tree(seed=3)
    jagent = jax.tree.map(jnp.asarray, tree["agent"])
    agent = agent_from_numpy(tree["agent"], PCFG, device="cpu")
    for i in range(4):
        b = transitions(10 + i)
        key = jax.random.PRNGKey(20 + i)
        jagent, jm = agent_update_jit(jagent, as_jax(b), key, JCFG)
        _, m = trl.agent_update(agent, as_port(b),
                                t(jax.random.normal(key, (BATCH, A))), PCFG)
        for k in ("critic_loss", "actor_loss"):
            close_scaled(m[k], jm[k], 1e-4)
        assert (float(m["actor_loss"]) == 0.0) == (i in (0, 2))
    _assert_agent_after_updates(agent, jagent, tree["agent"], 4)


def _assert_agent_after_updates(agent, jagent, start, n_updates,
                                tol=1e-4):
    """The agent after ``n_updates`` TD3 updates from the numpy agent
    ``start`` against JAX's: every network, target and Adam moment within
    ``tol`` scaled, and each online network's update (new - start) within
    UPDATE_TOL of the largest element of JAX's (assert_update_close), so
    that a port whose Adam did nothing or took the wrong lr fails. Adam
    divides each gradient element by its own RMS, and the biases ahead of
    a training BatchNorm have a true gradient of 0 (the BN subtracts them
    again), so their last-bit gradients become steps of up to lr either
    way: in the online networks and their moments such a bias, and the BN
    running mean that takes it in (card_checks.adam_noise), are held to 2
    lr a TD3 update (critic lr 1e-3, the larger). Measured after 4
    updates: 5.4e-3 in such a bias, 1.6e-3 in a running mean, at most
    4.3e-5 elsewhere; the updates within 2.4e-4 of JAX's largest element
    (the actor's; a step with lr 0 reads 1)."""
    lr_tol = 2 * JCFG.critic_lr * n_updates
    port = agent_to_numpy(agent)
    ref = {name: jagent[name] for name in trl.NETWORKS + TARGETS}
    ref["opt"] = {name: {"mu": jagent["opt"][name][0].mu,
                         "nu": jagent["opt"][name][0].nu}
                  for name in trl.NETWORKS}
    port_cmp = {name: port[name] for name in trl.NETWORKS + TARGETS}
    port_cmp["opt"] = {name: {"mu": port["opt"][name]["mu"],
                              "nu": port["opt"][name]["nu"]}
                       for name in trl.NETWORKS}
    leaves = list(zip(card_checks.named_leaves(port_cmp),
                      jax.tree.leaves(ref)))
    assert len(leaves) == len(jax.tree.leaves(port_cmp))
    for (path, p), r in leaves:
        # path: (network, ...) or ("opt", network, "mu" / "nu", ...)
        root, rest = ((port_cmp["opt"][path[1]][path[2]], path[3:])
                      if path[0] == "opt" else (port_cmp[path[0]], path[1:]))
        loose = path[0] not in TARGETS and card_checks.adam_noise(rest, root)
        close_scaled(p, r, lr_tol if loose else tol)
    for name in trl.NETWORKS:
        assert_update_close(leaf_tensors(port[name]["params"]),
                            jagent[name]["params"], start[name]["params"],
                            UPDATE_TOL, lr_tol)
        assert int(port["opt"][name]["count"]) == int(
            jagent["opt"][name][0].count)
    assert int(port["step"]) == int(jagent["step"])


def test_port_agent_draws_give_the_same_update_twice():
    tree = model_tree(seed=4)
    runs = []
    for _ in range(2):
        agent = trl.agent_init(torch.Generator().manual_seed(0), PCFG)
        gen = torch.Generator().manual_seed(1)
        for i in range(2):
            trl.agent_update(agent, as_port(transitions(30 + i)),
                             torch.randn((BATCH, A), generator=gen), PCFG)
        runs.append(agent_to_numpy(agent))
    for a, b in zip(jax.tree.leaves(runs[0]), jax.tree.leaves(runs[1])):
        np.testing.assert_array_equal(a, b)
    # the port's init has the JAX tree's structure and shapes
    ref = jax.tree.map(np.shape, tree["agent"])
    mine = jax.tree.map(np.shape, runs[0])
    for name in trl.NETWORKS + TARGETS:
        assert mine[name] == ref[name]


# ---------------------------------------------------------------------------
# the agent's numpy bridge
# ---------------------------------------------------------------------------


def test_agent_numpy_round_trip_keeps_every_bit():
    agent = agent_from_numpy(model_tree(seed=5)["agent"], PCFG, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for i in range(2):
        trl.agent_update(agent, as_port(transitions(40 + i)),
                         torch.randn((BATCH, A), generator=gen), PCFG)
    tree = agent_to_numpy(agent)
    again = agent_from_numpy(tree, PCFG, device="cpu")
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(agent_to_numpy(again))):
        np.testing.assert_array_equal(a, b)
    # and one more update from either gives the same bits
    b = as_port(transitions(42))
    noise = torch.randn((BATCH, A), generator=gen)
    for x in (agent, again):
        trl.agent_update(x, b, noise, PCFG)
    for a, b in zip(jax.tree.leaves(agent_to_numpy(agent)),
                    jax.tree.leaves(agent_to_numpy(again))):
        np.testing.assert_array_equal(a, b)


def test_jax_agent_after_three_updates_carries_into_the_port(tmp_path):
    """A JAX agent three updates in, written as a JAX full-model pickle
    (optax states, read through the stand-ins), then one more update on
    both sides: the moments crossed."""
    tree = model_tree(seed=6)
    jagent = jax.tree.map(jnp.asarray, tree["agent"])
    for i in range(3):
        jagent, _ = agent_update_jit(jagent, as_jax(transitions(50 + i)),
                                     jax.random.PRNGKey(60 + i), JCFG)
    jckpt.save_checkpoint(str(tmp_path / "jax_agent"),
                          {"model": {**tree, "agent": jagent}},
                          use_orbax=False)
    loaded = tckpt.load_checkpoint(str(tmp_path / "jax_agent"))["model"]
    assert type(loaded["agent"]["opt"]["actor"][0]).__name__ == \
        "ScaleByAdamState"
    agent = agent_from_numpy(loaded["agent"], PCFG, device="cpu")
    assert agent["step"] == 3
    assert_agents_close(agent, jagent, 0.0)
    start = jax.tree.map(np.asarray, jagent)
    b, key = transitions(53), jax.random.PRNGKey(63)
    jagent, jm = agent_update_jit(jagent, as_jax(b), key, JCFG)
    _, m = trl.agent_update(agent, as_port(b),
                            t(jax.random.normal(key, (BATCH, A))), PCFG)
    for k in ("critic_loss", "actor_loss"):
        close_scaled(m[k], jm[k], 1e-4)
    _assert_agent_after_updates(agent, jagent, start, 1)


# ---------------------------------------------------------------------------
# replay ring, reward, forward
# ---------------------------------------------------------------------------


def test_replay_ring_matches_jax():
    """As tests/test_train_steps.py::test_replay_buffer_ring_semantics,
    with the contents and a sample by JAX's indices."""
    rng = np.random.RandomState(7)
    jbuf = jrb.buffer_init(10, 4, 1)
    buf = trb.ReplayBuffer(10, 4, 1)
    for i, expect in enumerate(((6, 6), (10, 2))):  # the second wraps
        b = trl.TransitionBatch(*(rng.randn(6, w).astype(np.float32)
                                  for w in (4, 1, 1, 4, 1)))
        jbuf = jrb.buffer_add_batch(jbuf, as_jax(b))
        buf.add_batch(as_port(b))
        assert (buf.size, buf.ptr) == expect == (int(jbuf.size),
                                                 int(jbuf.ptr))
    for name in trb.FIELDS:
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      np.asarray(getattr(jbuf, name)))
    key = jax.random.PRNGKey(8)
    ref = jrb.buffer_sample(jbuf, key, 32)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (32,), 0, 10)))
    sample = buf.sample(idx)
    for a, b in zip(sample, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's draws cover the valid rows after the push
    drawn = tsteps.draw_rl_step(torch.Generator().manual_seed(0), 1, 16,
                                cfg=PCFG, buffer_size=buf.size,
                                updates_per_step=100)["sample"]
    assert int(drawn.min()) == 0 and int(drawn.max()) == 9


def test_completion_rewards_match_jax():
    rng = np.random.RandomState(9)
    pred, target = clouds(seed=10, bsz=3), clouds(seed=11, bsz=3)
    pg, tg = rng.randn(3, 32).astype(np.float32), rng.randn(3, 32).astype(
        np.float32)
    d = rng.randn(3, 1).astype(np.float32)
    for fn_t, fn_j in ((tlosses.completion_reward_batched,
                        jlosses.completion_reward_batched),
                       (tlosses.completion_reward,
                        jlosses.completion_reward)):
        close_scaled(fn_t(t(pred), t(target), t(pg), t(tg), t(d),
                          w_chamfer=50.0, w_gfv=5.0, w_discriminator=0.1),
                     fn_j(pred, target, pg, tg, d, w_chamfer=50.0, w_gfv=5.0,
                          w_discriminator=0.1), 1e-5)


@pytest.mark.parametrize("phase,mode", [("lgan", "train"),
                                        ("autoencoder", "train"),
                                        ("rl_agent", "inference")])
def test_forward_matches_jax(phase, mode):
    tree = model_tree(seed=12)
    pc = clouds(seed=13, bsz=3)
    key = jax.random.PRNGKey(14)
    z_dim = small_config().model.lgan.z_dim
    ref = jnet.forward(tree, pc, phase=phase, mode=mode, cfg=JCFG, key=key,
                       z_dim=z_dim)
    out = tnet.forward(model_from_numpy(tree, device="cpu"), t(pc),
                       phase=phase, mode=mode, cfg=PCFG,
                       z=t(jax.random.normal(key, (3, z_dim))))
    assert set(out) == set(ref)
    for k in ref:
        close_scaled(out[k], ref[k], 1e-5)


# ---------------------------------------------------------------------------
# whole RL steps and the greedy eval
# ---------------------------------------------------------------------------


def jax_rl_draws(key, bsz, spec, *, size_after, steps_per_episode,
                 updates_per_step):
    """The draws of jsteps.rl_step(key) (steps.py:583-639)."""
    k_data, k_scan, k_upd = jax.random.split(key, 3)
    samples, noises = [], []
    for k in jax.random.split(k_upd, updates_per_step):
        k_s, k_u = jax.random.split(k)
        samples.append(np.array(jax.random.randint(
            k_s, (BATCH,), 0, max(size_after, 1))))
        noises.append(np.array(jax.random.normal(k_u, (BATCH, A))))
    return {"holes": jax_draws(k_data, bsz, N_POINTS, spec),
            "ou": torch.stack([t(jax.random.normal(k, (bsz, A)))
                               for k in jax.random.split(
                                   k_scan, steps_per_episode)]),
            "sample": torch.from_numpy(np.stack(samples)),
            "noise": t(np.stack(noises))}


@pytest.mark.parametrize("steps_per_episode,prefill", [(2, 24), (1, 2)])
def test_rl_step_matches_jax(steps_per_episode, prefill):
    """(2, 24): 8 transitions wrap the 32-row ring and 2 TD3 updates run;
    (1, 2): the buffer stays below start_training_size and no update
    runs. Rewards, buffer, OU state and agent."""
    tree = model_tree(seed=15)
    bsz, spec = 4, jpc.PreprocSpec()
    pc = clouds(seed=16, bsz=bsz)
    pad = np.array([0, 0, 0, 1], np.float32)
    jbuf = jrb.buffer_init(32, S_DIM, A)
    buf = trb.ReplayBuffer(32, S_DIM, A)
    if prefill:
        pre = transitions(17, prefill)
        jbuf = jrb.buffer_add_batch(jbuf, as_jax(pre))
        buf.add_batch(as_port(pre))
    ou = np.random.RandomState(18).randn(bsz, A).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(19)
    kw = dict(w_chamfer=100.0, w_gfv=10.0, w_discriminator=0.01,
              start_training_size=8, steps_per_episode=steps_per_episode,
              updates_per_step=2)
    jmodel, jbuf, jou, jm = jsteps.rl_step(
        jax.tree.map(jnp.asarray, tree), jbuf, jnp.asarray(ou),
        {"complete_pc": jnp.asarray(pc), "pad": jnp.asarray(pad)}, key,
        cfg=JCFG, spec=spec, **kw)
    model = {**model_from_numpy(tree, device="cpu"),
             "agent": agent_from_numpy(tree["agent"], PCFG, device="cpu")}
    draws = jax_rl_draws(key, bsz, spec,
                         size_after=min(prefill + bsz * steps_per_episode,
                                        32),
                         steps_per_episode=steps_per_episode,
                         updates_per_step=2)
    model, buf, new_ou, m = tsteps.rl_step(
        model, buf, t(ou), {"complete_pc": t(pc), "pad": t(pad)}, draws,
        cfg=PCFG, **kw)
    # rewards are O(10): their f32 rounding is relative
    close_scaled(m["reward"], jm["reward"], 1e-5)
    for k in ("critic_loss", "actor_loss"):
        close_scaled(m[k], jm[k], 1e-4)
    close_scaled(new_ou, jou, 1e-6)
    assert (buf.size, buf.ptr) == (int(jbuf.size), int(jbuf.ptr))
    for name in trb.FIELDS:
        close_scaled(getattr(buf, name), getattr(jbuf, name), 1e-5)
    _assert_agent_after_updates(model["agent"], jmodel["agent"],
                                tree["agent"], 2)
    assert model["agent"]["step"] == (2 if prefill == 24 else 0)


def test_rl_eval_reward_matches_jax():
    tree = model_tree(seed=20)
    pc = clouds(seed=21, bsz=3)
    pad = np.array([0, 0, 1], np.float32)
    key, spec = jax.random.PRNGKey(22), jpc.PreprocSpec()
    ref = jsteps.rl_eval_reward(
        jax.tree.map(jnp.asarray, tree),
        {"complete_pc": jnp.asarray(pc), "pad": jnp.asarray(pad)}, key,
        cfg=JCFG, spec=spec)
    out = tsteps.rl_eval_reward(
        model_from_numpy(tree, device="cpu"),
        {"complete_pc": t(pc), "pad": t(pad)},
        jax_draws(key, 3, N_POINTS, spec), cfg=PCFG)
    for k in ("reward", "chamfer"):
        close_scaled(out[k], ref[k], 1e-5)


# ---------------------------------------------------------------------------
# the slice end to end through the CLI
# ---------------------------------------------------------------------------


def test_cli_trains_phases_one_to_four_and_the_checkpoints_cross(tmp_path):
    """--phase autoencoder, then lgan --resume autoencoder_best, then
    rl_agent --resume lgan_best, on the CPU. JAX reads rl_agent_final and
    its ``complete`` matches the port's; the port's trainer reads a
    JAX-written full-model pickle and keeps its critics and moments."""
    data = tmp_path / "data"
    tdataset.setup_dataset(str(data), synthetic=True, samples_per_category=2,
                           num_points=N_POINTS)
    ckpt = tmp_path / "ckpt"
    rl_model = {**SMALL["model"]["rl_agent"], "buffer_size": 32,
                "batch_size": BATCH}
    cfg = {"model": {**SMALL["model"], "rl_agent": rl_model},
           "training": {
               "precision": "float32", "batch_size": 8,
               "checkpoint_dir": str(ckpt),
               "autoencoder": {"epochs": 1},
               "lgan": {"epochs": 2, "batch_size": 4, "d_steps": 2},
               "rl_agent": {"episodes": 24, "envs_per_step": 4,
                            "updates_per_step": 2,
                            "start_training_steps": 8, "actor_warmup": 1,
                            "actor_lr_ramp": 2}},
           "data": {"data_dir": str(data)}}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    base = ["--config", str(path), "--device", "cpu"]
    train_main([*base, "--phase", "autoencoder"])
    assert np.isfinite(train_main([*base, "--phase", "lgan", "--resume",
                                   "autoencoder_best"]))
    assert (ckpt / "gfv" / "gfvs_train.npz").exists()
    for name in ("lgan_best", "lgan_final"):
        assert (ckpt / name).exists()
    assert np.isfinite(train_main([*base, "--phase", "rl_agent", "--resume",
                                   "lgan_best"]))
    for name in ("rl_agent_best", "rl_agent_final"):
        assert (ckpt / name).exists()

    # JAX reads the port's RL checkpoint and completes as the port does
    tree = jckpt.load_checkpoint(str(ckpt / "rl_agent_final"),
                                 use_orbax=False)
    assert int(tree["meta"]["phase_idx"]) == 2
    agent = tree["model"]["agent"]
    assert int(agent["step"]) == 10
    assert int(agent["opt"]["critic1"][0].count) == 10
    pc = clouds(seed=23, bsz=3)
    jcfg_td3 = small_config().td3_config()
    ref = jnet.complete(tree["model"], pc, cfg=jcfg_td3)
    trainer = RLGANNetTrainer(str(path), device="cpu")
    trainer.load_checkpoint("rl_agent_final")
    out = tnet.complete(trainer.model, t(pc), cfg=trainer.td3)
    for k in ref:
        close_scaled(out[k], ref[k], 1e-5)
    loaded = agent_to_numpy(trainer.model["agent"])
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(agent)):
        np.testing.assert_array_equal(a, b)

    # the port reads a JAX-written full-model pickle: critics and moments
    jtree = model_tree(seed=24)
    jagent = jax.tree.map(jnp.asarray, jtree["agent"])
    for i in range(2):
        jagent, _ = agent_update_jit(jagent, as_jax(transitions(70 + i)),
                                     jax.random.PRNGKey(80 + i),
                                     jcfg_td3._replace(batch_size=BATCH))
    jckpt.save_checkpoint(
        str(ckpt / "jax_model"),
        {"model": {**jtree, "agent": jagent},
         "meta": {"epoch": np.int32(5), "phase_idx": np.int32(2)}},
        use_orbax=False)
    assert trainer.load_checkpoint("jax_model") == (5, "rl_agent")
    assert_agents_close(trainer.model["agent"], jagent, 0.0)
