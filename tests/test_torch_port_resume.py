"""Mid-phase resume in the port, on the CPU at a tiny config: the
``_trainstate`` siblings of the periodic checkpoints (tests/test_resume.py's
four checks, on the port), and their crossing between the packages: the
port resumes a JAX-written orbax train state with the moments, counts,
best-so-far and start epoch JAX restores from it, and the JAX trainer
restores a port-written pickle as optax's own states (each of the four
phases). Also the stale-sibling rule of the port's save and the unknown
config keys, against the JAX package."""

import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gan_rl_3d_tpu import config as jcfg
from gan_rl_3d_tpu.train import RLGANNetTrainer as JaxTrainer
from gan_rl_3d_tpu.train import replay_buffer as jrb
from gan_rl_3d_tpu.train import steps as jsteps
from gan_rl_3d_tpu.utils import checkpoint as jckpt
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch.convert import buffer_from_numpy, load_adam, load_chain
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.train import replay_buffer as trb
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
from gan_rl_3d_tpu_torch.utils import checkpoint as tckpt
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves
from test_torch_port_modules import N_POINTS, SMALL

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("autoencoder", "lgan", "rl_agent", "joint")
ENVS = 8
STEPS_PER_EPOCH = 2  # 16 train clouds at batch 8
RESTORED_COUNT = 3   # the Adam and schedule counts of a JAX-written state


def tiny(root: Path, data: Path) -> dict:
    """A config both packages read: SMALL widths, N=256, batch 8, every
    phase a few steps, a checkpoint with its train state every epoch."""
    return {
        "model": {**SMALL["model"],
                  "rl_agent": {**SMALL["model"]["rl_agent"],
                               "buffer_size": 32, "batch_size": 8}},
        "training": {
            "precision": "float32", "batch_size": 8,
            "checkpoint_dir": str(root / "ckpt"),
            "log_dir": str(root / "logs"), "results_dir": str(root / "res"),
            "autoencoder": {"epochs": 3, "lr_schedule": "cosine"},
            "lgan": {"epochs": 2, "batch_size": 8, "d_steps": 1},
            "rl_agent": {"episodes": 3 * ENVS, "envs_per_step": ENVS,
                         "updates_per_step": 2, "start_training_steps": 8,
                         "actor_warmup": 1, "actor_lr_ramp": 2},
            "joint": {"epochs": 2}},
        "logging": {"save_model_frequency": 1, "use_tensorboard": False},
        "data": {"data_dir": str(data)}}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    data = tmp_path_factory.mktemp("resume_data")
    tdataset.setup_dataset(str(data), synthetic=True, samples_per_category=2,
                           num_points=N_POINTS)
    return data


def port_trainer(root: Path, data: Path) -> RLGANNetTrainer:
    path = root / "tiny.json"
    if not path.exists():
        root.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(tiny(root, data)))
    return RLGANNetTrainer(str(path), device="cpu")


def jax_trainer(root: Path, data: Path, use_orbax: bool) -> JaxTrainer:
    return JaxTrainer(jcfg.load_config(None, overrides=tiny(root, data)),
                      use_orbax=use_orbax)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, data_dir):
    """The whole curriculum trained by the port, a checkpoint and train
    state every epoch or iteration: autoencoder_epoch_1-3, lgan_epoch_1-2,
    rl_agent_episode_8/16/24, joint_epoch_1-2."""
    root = tmp_path_factory.mktemp("port_run")
    trainer = port_trainer(root, data_dir)
    trainer.train_autoencoder(3)
    trainer.generate_gfvs()
    trainer.train_latent_gan(2)
    trainer.train_rl_agent(3 * ENVS)
    trainer.joint_training(2)
    return root, trainer


# ---------------------------------------------------------------------------
# tests/test_resume.py's checks, on the port
# ---------------------------------------------------------------------------


def test_port_ae_resume_continues_the_trajectory(port_run, data_dir):
    root, trained = port_run
    assert (root / "ckpt" / "autoencoder_epoch_2_trainstate").is_file()
    resumed = port_trainer(root, data_dir)
    resumed.load_checkpoint("autoencoder_epoch_2")
    resumed.train_autoencoder(3)
    # only the remaining epoch (index 2) ran, at the trained level
    assert len(resumed.train_losses) == STEPS_PER_EPOCH
    first_epoch = np.mean(trained.train_losses[:STEPS_PER_EPOCH])
    assert np.isfinite(resumed.train_losses).all()
    assert np.mean(resumed.train_losses) < first_epoch * 1.05


def test_port_rl_buffer_roundtrips_through_the_trainstate(port_run):
    root, trained = port_run
    paths = sorted((root / "ckpt").glob("rl_agent_episode_*_trainstate"))
    assert [p.name for p in paths] == [
        f"rl_agent_episode_{e}_trainstate" for e in (16, 24, 8)]
    state = tckpt.load_checkpoint(str(paths[1]))  # episode 24, the last
    buf = buffer_from_numpy(state["buffer"], trb.ReplayBuffer(32, 32, 4))
    assert buf.size == 24 and buf.ptr == 24 and int(state["it"]) == 2
    assert bool((buf.states[:buf.size] != 0).any())
    assert bool(buf.rewards[:buf.size].isfinite().all())
    for name in trb.FIELDS:
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      getattr(state["buffer"], name))


def test_port_resumed_rl_phase_runs_the_remaining_iterations_only(
        port_run, data_dir):
    root, _ = port_run
    trainer = port_trainer(root, data_dir)
    trainer.load_checkpoint("rl_agent_episode_16")  # it 1 of 3
    trainer.train_rl_agent(3 * ENVS)
    assert len(trainer.rl_history) == 1
    assert trainer.rl_evals[0][0] == 2 * ENVS  # the eval before it 2


def test_port_later_phase_does_not_consume_a_foreign_train_state(port_run,
                                                                 data_dir):
    root, _ = port_run
    trainer = port_trainer(root, data_dir)
    trainer.load_checkpoint("autoencoder_epoch_2")
    assert trainer._restore_train_state("lgan") is None
    assert trainer._resume is not None  # still there for its own phase
    assert trainer._restore_train_state("autoencoder") is not None
    assert trainer._resume is None


# ---------------------------------------------------------------------------
# the save's siblings (a stale train state does not outlive its checkpoint)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stale", ["directory", "file"])
def test_save_replaces_or_removes_a_stale_trainstate_sibling(tmp_path,
                                                             data_dir, stale):
    """A ``<name>_trainstate`` of an earlier run, an orbax directory of the
    JAX package or a pickle, goes when the port saves ``name`` without a
    train state, and is replaced when it saves one. (The port used to
    leave it, and a resume from ``name`` would restore it.)"""
    trainer = port_trainer(tmp_path, data_dir)
    sibling = trainer.checkpoint_dir / "autoencoder_epoch_1_trainstate"
    stale_tree = {"opt_state": np.zeros(3, np.float32),
                  "best_val": np.float32(9.0), "epoch": np.int32(5)}
    jckpt.save_checkpoint(str(sibling), stale_tree,
                          use_orbax=stale == "directory")
    assert sibling.is_dir() == (stale == "directory")
    trainer.save_checkpoint("autoencoder_epoch_1", 0, "autoencoder")
    assert not sibling.exists()
    trainer.load_checkpoint("autoencoder_epoch_1")
    assert trainer._restore_train_state("autoencoder") is None

    jckpt.save_checkpoint(str(sibling), stale_tree,
                          use_orbax=stale == "directory")
    trainer.save_checkpoint("autoencoder_epoch_1", 0, "autoencoder",
                            train_state={"best_val": np.float32(1.0),
                                         "epoch": np.int32(0)})
    assert sibling.is_file()
    assert float(tckpt.load_checkpoint(str(sibling))["best_val"]) == 1.0


def test_port_saves_over_the_orbax_directories_of_a_resumed_jax_run(
        tmp_path, data_dir):
    """The port resumes a JAX run in that run's own checkpoint_dir and then
    saves names the run already wrote as orbax directories (here
    ``autoencoder_best`` and ``autoencoder_epoch_2`` with its train state):
    each directory is replaced by the port's pickle."""
    jt = jax_trainer(tmp_path, data_dir, use_orbax=True)
    state = jax_train_state(jt, "autoencoder")
    jt.save_checkpoint("autoencoder_best", 0, "autoencoder")
    # best_val inf, so the port's epoch saves autoencoder_best
    jt.save_checkpoint("autoencoder_epoch_1", 0, "autoencoder",
                       train_state={**state, "best_val": np.float32(np.inf)})
    jt.save_checkpoint("autoencoder_epoch_2", 1, "autoencoder",
                       train_state={**state, "epoch": np.int32(1)})
    jt.close()
    ckpt = tmp_path / "ckpt"
    names = ("autoencoder_best", "autoencoder_epoch_2",
             "autoencoder_epoch_2_trainstate")
    assert all((ckpt / n / "_METADATA").exists() for n in names)
    trainer = port_trainer(tmp_path, data_dir)
    trainer.load_checkpoint("autoencoder_epoch_1")
    trainer.train_autoencoder(2)  # epoch index 1 alone
    assert len(trainer.train_losses) == STEPS_PER_EPOCH
    assert all((ckpt / n).is_file() for n in names)
    for name in names[:2]:
        _, meta = tckpt.load_model_checkpoint(str(ckpt), name)
        assert int(meta["epoch"]) == 1
    assert int(tckpt.load_checkpoint(str(ckpt / names[2]))["epoch"]) == 1


# ---------------------------------------------------------------------------
# unknown config keys
# ---------------------------------------------------------------------------


def _warned(caplog) -> list:
    return sorted(r.getMessage() for r in caplog.records
                  if "ignoring unknown key" in r.getMessage())


def test_unknown_config_keys_warn_as_in_jax(tmp_path, caplog):
    """tests/test_config.py:52-62 on both packages: the same paths warn;
    the shipped config warns in neither."""
    raw = {"model": {"bogus_key": 1, "autoencoder": {"latent_dim": 64}},
           "training": {"batch_sz": 3, "batch_size": 16},
           "paths": {"data": "x"}}
    (tmp_path / "bad.json").write_text(json.dumps(raw))
    with caplog.at_level(logging.WARNING):
        p = tcfg.load_config(str(tmp_path / "bad.json"))
    port_warnings = _warned(caplog)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        j = jcfg.load_config(None, overrides=raw)
    assert port_warnings == _warned(caplog) == [
        "config: ignoring unknown key model.bogus_key",
        "config: ignoring unknown key training.batch_sz"]
    assert p.training.batch_size == j.training.batch_size == 16
    assert p.model.autoencoder.latent_dim == 64
    caplog.clear()
    shipped = str(ROOT / "configs" / "config.yaml")
    with caplog.at_level(logging.WARNING):
        p = tcfg.load_config(shipped)
        jcfg.load_config(shipped)
    assert _warned(caplog) == []
    assert p == tcfg.flagship_config()


# ---------------------------------------------------------------------------
# JAX-written orbax train states, resumed by the port
# ---------------------------------------------------------------------------


def _moments(state, rng):
    """optax's ScaleByAdamState with RESTORED_COUNT and random moments."""
    return state._replace(
        count=jnp.int32(RESTORED_COUNT),
        mu=jax.tree.map(lambda x: jnp.asarray(
            rng.randn(*x.shape).astype(np.float32) * 1e-2), state.mu),
        nu=jax.tree.map(lambda x: jnp.asarray(
            rng.rand(*x.shape).astype(np.float32) * 1e-4 + 1e-6), state.nu))


def _chain(state, rng):
    """An add_decayed_weights -> scale_by_adam -> schedule chain state."""
    empty, adam, schedule = state
    return (empty, _moments(adam, rng),
            schedule._replace(count=jnp.int32(RESTORED_COUNT)))


def jax_train_state(jtrainer, phase: str, seed: int = 0) -> dict:
    """A train state of ``phase`` in the JAX trainer's own trees, with
    moments, counts and best-so-far no fresh state has."""
    rng = np.random.RandomState(seed)
    t = jtrainer.config.training
    model = jtrainer.model
    if phase == "autoencoder":
        opt = jsteps.make_ae_optimizer(t.autoencoder,
                                       len(jtrainer.train_loader))
        return {"opt_state": _chain(opt.init(model["ae"]["params"]), rng),
                "best_val": np.float32(0.125), "epoch": np.int32(0)}
    if phase == "lgan":
        def adam(net, lr):
            opt = jsteps.make_gan_optimizer(lr, t.lgan)
            first, *rest = opt.init(model["lgan"]["params"][net])
            return (_moments(first, rng), *rest)
        return {"g_opt_state": adam("generator", t.lgan.generator_lr),
                "d_opt_state": adam("discriminator", t.lgan.discriminator_lr),
                "best_g": np.float32(-0.5), "epoch": np.int32(0)}
    if phase == "rl_agent":
        m = jtrainer.config.model.rl_agent
        buf = jrb.buffer_init(m.buffer_size, m.state_dim, m.action_dim)
        buf = buf._replace(
            **{k: jnp.asarray(rng.randn(*getattr(buf, k).shape)
                              .astype(np.float32))
               for k in ("states", "rewards", "next_states")},
            actions=jnp.asarray(np.tanh(rng.randn(*buf.actions.shape))
                                .astype(np.float32)),
            dones=jnp.asarray((rng.rand(m.buffer_size, 1) > 0.8)
                              .astype(np.float32)),
            ptr=jnp.int32(20), size=jnp.int32(20))
        return {"buffer": buf, "ou": jnp.asarray(
                    rng.randn(ENVS, m.action_dim).astype(np.float32) * 0.1),
                "best_avg": np.float32(-1.5), "it": np.int32(0)}
    opt = jsteps.make_joint_optimizer(t.joint)
    trainable = {"ae": model["ae"]["params"],
                 "gen": model["lgan"]["params"]["generator"]}
    return {"opt_state": _chain(opt.init(trainable), rng),
            "best_val": np.float32(0.25), "epoch": np.int32(0)}


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory, data_dir):
    """Each phase's checkpoint ``<phase>_resume`` and its train state,
    written by the JAX trainer as orbax directories, and what the JAX
    trainer restores from them."""
    root = tmp_path_factory.mktemp("jax_states")
    jt = jax_trainer(root, data_dir, use_orbax=True)
    written, restored = {}, {}
    for phase in PHASES:
        state = jax_train_state(jt, phase)
        jt.save_checkpoint(f"{phase}_resume", 0, phase, train_state=state)
        written[phase] = state
    for phase in PHASES:
        jt.load_checkpoint(f"{phase}_resume")
        restored[phase] = jt._restore_train_state(phase, written[phase])
    jt.close()
    return root, restored


def _assert_adam_loaded(opt, params, ref):
    """A torch Adam over tree_leaves(params) holds optax state ``ref``."""
    leaves = tree_leaves(params)
    for p, mu, nu in zip(leaves, jax.tree.leaves(ref.mu),
                         jax.tree.leaves(ref.nu), strict=True):
        s = opt.state[p]
        assert float(s["step"]) == int(ref.count)
        np.testing.assert_array_equal(s["exp_avg"].numpy(), np.asarray(mu))
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(),
                                      np.asarray(nu))


def port_optimizers(trainer, phase: str, rst: dict) -> dict:
    """The phase's optimizers (and schedule) as the port's trainer makes
    them, loaded from the restored train state ``rst``."""
    t = trainer.config.training
    if phase == "autoencoder":
        params = trainer.model["ae"]["params"]
        opt, sched = tsteps.make_ae_optimizer(params, t.autoencoder,
                                              len(trainer.train_loader))
        load_chain(opt, params, rst["opt_state"], sched)
        return {"opt": (opt, params), "sched": sched}
    if phase == "lgan":
        out = {}
        for net, key, lr in (("generator", "g_opt_state", t.lgan.generator_lr),
                             ("discriminator", "d_opt_state",
                              t.lgan.discriminator_lr)):
            params = trainer.model["lgan"]["params"][net]
            opt = tsteps.make_gan_optimizer(params, lr, t.lgan)
            load_adam(opt, params, rst[key])
            out[key] = (opt, params)
        return out
    trainable = tsteps.joint_trainable(trainer.model)
    opt = tsteps.make_joint_optimizer(trainable, t.joint)
    load_chain(opt, trainable, rst["opt_state"])
    return {"opt": (opt, trainable)}


@pytest.mark.parametrize("phase", PHASES)
def test_port_resumes_a_jax_orbax_trainstate(jax_states, data_dir, phase):
    root, restored = jax_states
    ref = restored[phase]
    assert (root / "ckpt" / f"{phase}_resume_trainstate" / "_METADATA"
            ).exists()
    trainer = port_trainer(root, data_dir)
    trainer.load_checkpoint(f"{phase}_resume")
    rst = trainer._restore_train_state(phase)
    if phase == "rl_agent":
        buf = buffer_from_numpy(rst["buffer"], trb.ReplayBuffer(32, 32, 4))
        for name in trb.FIELDS:
            np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                          np.asarray(getattr(ref["buffer"],
                                                             name)))
        assert (buf.ptr, buf.size) == (int(ref["buffer"].ptr),
                                       int(ref["buffer"].size))
        np.testing.assert_array_equal(rst["ou"], np.asarray(ref["ou"]))
        keys = ("best_avg", "it")
    else:
        opts = port_optimizers(trainer, phase, rst)
        if phase == "lgan":
            for key in ("g_opt_state", "d_opt_state"):
                _assert_adam_loaded(*opts[key], ref[key][0])
            keys = ("best_g", "epoch")
        else:
            _assert_adam_loaded(*opts["opt"], ref["opt_state"][1])
            keys = ("best_val", "epoch")
            if phase == "autoencoder":
                assert opts["sched"].last_epoch == int(
                    ref["opt_state"][2].count) == RESTORED_COUNT
    for k in keys:
        assert rst[k] == ref[k]

    # the phase continues at the next epoch (iteration) with that state
    resumed = port_trainer(root, data_dir)
    resumed.load_checkpoint(f"{phase}_resume")
    run = {"autoencoder": lambda: resumed.train_autoencoder(2),
           "lgan": lambda: resumed.train_latent_gan(2),
           "rl_agent": lambda: resumed.train_rl_agent(2 * ENVS),
           "joint": lambda: resumed.joint_training(2)}[phase]
    run()
    ran = {"autoencoder": len(resumed.train_losses) // STEPS_PER_EPOCH,
           "lgan": len(resumed.lgan_losses),
           "rl_agent": len(resumed.rl_history),
           "joint": len(resumed.joint_losses)}[phase]
    assert ran == 1


# ---------------------------------------------------------------------------
# port-written pickle train states, restored by the JAX trainer
# ---------------------------------------------------------------------------

PORT_NAMES = {"autoencoder": "autoencoder_epoch_1", "lgan": "lgan_epoch_1",
              "rl_agent": f"rl_agent_episode_{ENVS}",
              "joint": "joint_epoch_1"}
OPTAX_TYPES = {"opt_state": (optax.EmptyState, optax.ScaleByAdamState,
                             optax.ScaleByScheduleState),
               "g_opt_state": (optax.ScaleByAdamState, optax.EmptyState),
               "d_opt_state": (optax.ScaleByAdamState, optax.EmptyState)}


def test_each_stand_in_unpickles_in_jax_as_its_class(tmp_path):
    """The port's pickler writes each stand-in under its JAX name: the JAX
    package's reader returns optax's classes and its ReplayBuffer with the
    port's leaves, and the port reads its stand-ins back."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"empty": tckpt.EmptyState(),
            "adam": tckpt.ScaleByAdamState(np.int32(2), {"w": a},
                                           {"w": a * 2}),
            "sched": tckpt.ScaleByScheduleState(np.int32(5)),
            "buffer": tckpt.ReplayBufferState(a, a + 1, a[:, :1], a + 2,
                                              a[:, :1] * 0, np.int32(1),
                                              np.int32(2))}
    path = tmp_path / "stand_ins"
    tckpt.save_checkpoint(str(path), tree)
    jax_tree = jckpt.load_checkpoint(str(path), use_orbax=False)
    port_tree = tckpt.load_checkpoint(str(path))
    expected = {"empty": optax.EmptyState, "adam": optax.ScaleByAdamState,
                "sched": optax.ScaleByScheduleState,
                "buffer": jrb.ReplayBuffer}
    for key, cls in expected.items():
        assert type(jax_tree[key]) is cls
        assert type(port_tree[key]) is type(tree[key])
        assert jax_tree[key]._fields == tree[key]._fields
    ref = tree_leaves(tree)
    for got in (jax.tree.leaves(jax_tree), tree_leaves(port_tree)):
        assert len(got) == len(ref)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(g), r)


@pytest.mark.parametrize("phase", PHASES)
def test_jax_restores_a_port_pickle_trainstate(port_run, data_dir, phase):
    """The JAX trainer (use_orbax=False) restores the port's pickle as
    optax's own states and its ReplayBuffer, leaf for leaf what the port
    wrote; the counts are the updates the port made."""
    root, _ = port_run
    name = PORT_NAMES[phase]
    jt = jax_trainer(root, data_dir, use_orbax=False)
    jt.load_checkpoint(name)
    ref = jt._restore_train_state(phase, jax_train_state(jt, phase))
    jt.close()
    port = tckpt.load_checkpoint(str(root / "ckpt" / f"{name}_trainstate"))
    assert set(ref) == set(port)
    for key, types in OPTAX_TYPES.items():
        if key in ref:
            assert tuple(type(s) for s in ref[key]) == types
            adam = next(s for s in ref[key]
                        if isinstance(s, optax.ScaleByAdamState))
            assert int(adam.count) == STEPS_PER_EPOCH
    if phase == "rl_agent":
        assert type(ref["buffer"]) is jrb.ReplayBuffer
        assert int(ref["it"]) == 0 and int(ref["buffer"].size) == ENVS
    if phase == "autoencoder":
        assert int(ref["opt_state"][2].count) == STEPS_PER_EPOCH
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        np.testing.assert_array_equal(np.asarray(r), p)
