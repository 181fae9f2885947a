"""The ranks of the port's multi-process tests (tests/test_torch_port_parallel*).

``spawn`` starts ``world`` processes with torch.multiprocessing over gloo
and a ``file://`` store under the test's temporary directory. The ranks
fork from a fork server, a fresh interpreter that imports this module
and not the test's: the test modules import JAX (so does
tests/conftest.py), and this module imports only torch, numpy and the
port, so the ranks never load JAX. The parent
writes the inputs (numpy trees, the JAX side's draws) to ``inputs.pkl``;
each rank runs the named jobs on its mesh and writes what it got to
``<job>.<rank>.pkl``, which ``spawn`` returns. A job is a plain function
of (inputs, mesh), so the parent runs the same function with ``mesh=None``
for the single-process reference.
"""

from __future__ import annotations

import os
import pickle
import socket
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gan_rl_3d_tpu_torch import nn as tnn
from gan_rl_3d_tpu_torch.config import (AETrainConfig, JointTrainConfig,
                                        LGANTrainConfig)
from gan_rl_3d_tpu_torch.convert import agent_from_numpy, model_from_numpy
from gan_rl_3d_tpu_torch.models import inference
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.parallel import collectives
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
from gan_rl_3d_tpu_torch.train import replay_buffer as trb
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _main(rank: int, world: int, tmp: str, jobs: list) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        with open(Path(tmp) / "inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
        # a job's mesh takes the first ranks of the world, and jobs of one
        # shape share it; every rank creates every mesh's groups first, so
        # a rank leaves once its own jobs are done instead of waiting
        meshes = {}
        for _, _, shape, _ in jobs:
            if shape not in meshes:
                meshes[shape] = mesh_lib.make_mesh(
                    *shape, ranks=range(shape[0] * shape[1]))
        for tag, name, shape, kw in jobs:
            mesh = meshes[shape]
            if mesh is None:
                continue
            out = JOBS[name](inputs, mesh, **kw)
            with open(Path(tmp) / f"{tag}.{rank}.pkl", "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _start(fn, args: tuple, world: int) -> None:
    """Run ``fn(rank, *args)`` on ``world`` processes forked from a fork
    server that imported this module once (a fresh interpreter: torch and
    the port, no JAX), so a rank costs a fork instead of importing torch
    anew; join them, raising if one fails. The server also imports
    torch._dynamo, which a process's first optimizer step would import
    (about 3 s of CPU a rank)."""
    mp.get_context("forkserver").set_forkserver_preload(
        [__name__, "gan_rl_3d_tpu_torch.train_rl_gan_net", "torch._dynamo"])
    mp.start_processes(fn, args=args, nprocs=world, join=True,
                       start_method="forkserver")


def spawn(world: int, tmp: Path, inputs: dict, jobs: list) -> dict:
    """Run ``jobs`` [(tag, job name, (n_data, n_model), kwargs)] on
    ``world`` gloo ranks, each on a mesh of the first n_data x n_model
    ranks (the others wait); returns {tag: [each mesh rank's result]}."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    _start(_main, (world, str(tmp), jobs), world)
    out = {}
    for tag, _, shape, _ in jobs:
        ranks = []
        for r in range(shape[0] * shape[1]):
            with open(tmp / f"{tag}.{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out[tag] = ranks
    return out


def _cli_main(rank: int, world: int, port: int, argv: list) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    from gan_rl_3d_tpu_torch.train_rl_gan_net import main
    main(argv)


def spawn_cli(world: int, argv: list) -> None:
    """``python -m gan_rl_3d_tpu_torch.train_rl_gan_net ARGV`` on ``world``
    ranks, as torchrun starts it (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR / MASTER_PORT)."""
    _start(_cli_main, (world, free_port(), argv), world)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def params_of(tree):
    """Numpy tree -> f32 leaves that take a gradient."""
    return tree_map(lambda x: t(x).requires_grad_(True), tree)


def as_numpy(tree):
    return tree_map(lambda x: x.detach().numpy().copy()
                    if isinstance(x, torch.Tensor) else x, tree)


def tensors(tree):
    """Numpy draws -> tensors (keep masks stay boolean, indices integer)."""
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True))
                    if isinstance(x, np.ndarray) else x, tree)


def moments(opt: torch.optim.Adam, params) -> dict:
    """Adam's moments and step count as numpy trees of ``params``'s
    layout (one process)."""
    leaves = tree_leaves(params)
    from gan_rl_3d_tpu_torch.utils.tree import tree_unflatten

    def tree_of(key):
        return tree_unflatten(params, [opt.state[p][key].numpy().copy()
                                       for p in leaves])
    return {"exp_avg": tree_of("exp_avg"),
            "exp_avg_sq": tree_of("exp_avg_sq"),
            "step": float(opt.state[leaves[0]]["step"])}


def load_moments(opt: torch.optim.Adam, params, m: dict, mesh) -> None:
    """Start ``opt`` from moments ``moments`` returned (each rank takes its
    columns of a column-sharded leaf)."""
    def local(p, x):
        x = torch.from_numpy(np.array(x, copy=True))
        if mesh_lib.is_model_sharded(p):
            x = mesh_lib.column_block(mesh, x).contiguous()
        return x

    for p, a, v in zip(tree_leaves(params), tree_leaves(m["exp_avg"]),
                       tree_leaves(m["exp_avg_sq"])):
        opt.state[p] = {"step": torch.tensor(m["step"]),
                        "exp_avg": local(p, a), "exp_avg_sq": local(p, v)}


def _training_model(tree: dict) -> dict:
    """The port's model from a JAX-layout numpy tree: ae and lgan leaves
    that take a gradient, the whole agent."""
    model = model_from_numpy(tree, device="cpu")
    for k in ("ae", "lgan"):
        model[k] = {"params": params_of(tree[k]["params"]),
                    "state": tree_map(t, tree[k]["state"])}
    return model


# ---------------------------------------------------------------------------
# jobs: each returns numpy results, the same on every rank unless noted
# ---------------------------------------------------------------------------


def ae_steps(inp, mesh, *, bn_stats="centered", lr=None, key="ae"):
    """``len(draws)`` ae_train_steps from the inputs' AE (augment off, as
    tests/test_sharding.py runs them); the params and state after them
    (column-sharded leaves gathered whole)."""
    d = inp[key]
    tree = mesh_lib.shard_model_for_mesh(
        mesh, {"ae": {"params": params_of(d["params"]),
                      "state": tree_map(t, d["state"])}})
    params, state = tree["ae"]["params"], tree["ae"]["state"]
    cfg = AETrainConfig(**{**d["opt"], **({} if lr is None else {"lr": lr})})
    opt, sched = tsteps.make_ae_optimizer(params, cfg, d["steps_per_epoch"])
    if d.get("moments") is not None:
        load_moments(opt, params, d["moments"], mesh)
    losses = []
    for i, draws in enumerate(d["draws"]):
        state, m = tsteps.ae_train_step(
            params, state, opt, mesh_lib.shard_batch(mesh, _batch_of(d, i)),
            tensors(draws), scheduler=sched, augment=d.get("augment", False),
            recon_loss=d.get("recon_loss", "chamfer"), bn_stats=bn_stats,
            mesh=mesh)
        losses.append(float(m["loss"]))
    full = mesh_lib.gather_model(mesh, {"params": params, "state": state})
    return {"losses": losses, "ae": as_numpy(full),
            "marked": tree_map(mesh_lib.is_model_sharded, tree),
            "moments": moments(opt, params) if mesh is None else None}


def ae_starts(d: dict, bn_stats: str) -> list:
    """The one-process trajectory of ``d``'s steps: the params, state and
    Adam moments before each step."""
    starts = []
    for i in range(len(d["draws"])):
        starts.append({"params": d["params"], "state": d["state"],
                       "moments": d.get("moments")})
        out = ae_steps({"d": {**d, "draws": d["draws"][i:i + 1],
                              "batch": _batch_of(d, i)}}, None,
                       bn_stats=bn_stats, key="d")
        d = {**d, "params": out["ae"]["params"], "state": out["ae"]["state"],
             "moments": out["moments"]}
    return starts


def _batch_of(d, i):
    return d["batches"][i] if "batches" in d else d["batch"]


def ae_forced(inp, mesh, *, bn_stats="centered", lr=None, key="ae"):
    """Each of ``d``'s steps from the one-process state before it
    (``d["starts"]``, from ``ae_starts``): a chaotic trajectory's
    rounding does not compound, so every step is held on its own."""
    d = inp[key]
    out = {"losses": [], "steps": []}
    for i, start in enumerate(d["starts"]):
        one = ae_steps({"d": {**d, **start, "draws": d["draws"][i:i + 1],
                              "batch": _batch_of(d, i)}}, mesh,
                       bn_stats=bn_stats, lr=lr, key="d")
        out["losses"] += one["losses"]
        out["steps"].append(one["ae"])
        out["marked"] = one["marked"]
    return out


def joint_step(inp, mesh, *, lr=None, bn_stats="centered", key="joint"):
    """One joint_train_step from the inputs' model (the 4x2 case shards
    the decoder head and the generator's 512-wide layers)."""
    d = inp[key]
    model = mesh_lib.shard_model_for_mesh(mesh, _training_model(d["tree"]))
    trainable = tsteps.joint_trainable(model)
    cfg = JointTrainConfig(**{"lr": d["lr"] if lr is None else lr})
    opt = tsteps.make_joint_optimizer(trainable, cfg)
    if "moments" in d:
        load_moments(opt, trainable, d["moments"], mesh)
    model, m = tsteps.joint_train_step(
        model, opt, mesh_lib.shard_batch(mesh, d["batch"]),
        tensors(d["draws"]), cfg=d["td3"], bn_stats=bn_stats, mesh=mesh)
    full = mesh_lib.gather_model(
        mesh, {"ae": model["ae"], "generator": {
            "params": model["lgan"]["params"]["generator"],
            "state": model["lgan"]["state"]["generator"]}})
    return {"loss": float(m["loss"]), "nets": as_numpy(full),
            "marked": tree_map(mesh_lib.is_model_sharded,
                               {k: model[k] for k in ("ae", "lgan")}),
            "tree": (as_numpy({k: model[k] for k in ("ae", "lgan")})
                     if mesh is None else None),
            "moments": moments(opt, trainable) if mesh is None else None}


def lgan_steps(inp, mesh, *, lr_scale=1.0, key="lgan"):
    """Combined LGAN steps (d_steps D updates and one G update each), the
    real batches sharded along axis 1."""
    d = inp[key]
    tree = mesh_lib.shard_model_for_mesh(
        mesh, {"lgan": {"params": params_of(d["params"]),
                        "state": tree_map(t, d["state"])}})
    params, state = tree["lgan"]["params"], tree["lgan"]["state"]
    cfg = LGANTrainConfig(**d["opt"])
    d_opt = tsteps.make_gan_optimizer(params["discriminator"],
                                      cfg.discriminator_lr * lr_scale, cfg)
    g_opt = tsteps.make_gan_optimizer(params["generator"],
                                      cfg.generator_lr * lr_scale, cfg)
    opts = {"discriminator": d_opt, "generator": g_opt}
    for k, m in d.get("moments", {}).items():
        load_moments(opts[k], params[k], m, mesh)
    traj = []
    for real, draws in zip(d["real"], d["draws"]):
        state, m = tsteps.lgan_combined_step(
            params, state, d_opt, g_opt,
            t(mesh_lib.local_rows(mesh, real, axis=1)), tensors(draws),
            lambda_gp=cfg.lambda_gp, mesh=mesh)
        traj.append((float(m["d_loss"]), float(m["g_loss"])))
    nets = mesh_lib.gather_model(
        mesh, {k: {"params": params[k], "state": state[k]}
               for k in ("generator", "discriminator")})
    return {"traj": traj, "nets": as_numpy(nets),
            "moments": ({k: moments(o, params[k]) for k, o in opts.items()}
                        if mesh is None else None)}


def rl_steps(inp, mesh, *, lr_scale=1.0, key="rl"):
    """rl_steps over a sharded batch of environments from an empty ring;
    the ring (its rows and size) on every rank and the agent. ``lr_scale``
    scales the TD3 config's lrs, which every actor update reads anew."""
    d = inp[key]
    td3 = d["td3"]._replace(actor_lr=d["td3"].actor_lr * lr_scale,
                            critic_lr=d["td3"].critic_lr * lr_scale)
    model = model_from_numpy(d["tree"], device="cpu")
    model["agent"] = agent_from_numpy(d["tree"]["agent"], td3, device="cpu")
    buffer = trb.ReplayBuffer(d["capacity"], td3.state_dim, td3.action_dim)
    ou = rl.ou_init(td3, (len(d["batches"][0]["pad"]),))
    rewards = []
    for batch, draws in zip(d["batches"], d["draws"]):
        model, buffer, ou, m = tsteps.rl_step(
            model, buffer, ou, mesh_lib.shard_batch(mesh, batch),
            tensors(draws), cfg=td3, start_training_size=d["start"],
            mesh=mesh)
        rewards.append(float(m["reward"]))
    agent = {k: as_numpy(model["agent"][k]) for k in model["agent"]
             if k not in ("opt", "step")}
    return {"rewards": rewards, "size": buffer.size, "ptr": buffer.ptr,
            "ring": {k: getattr(buffer, k).numpy().copy()
                     for k in trb.FIELDS},
            "ou": ou.numpy(), "agent": agent}


def warm_agent(agent: dict, td3, n_updates: int = 4, seed: int = 0) -> dict:
    """The agent (JAX numpy layout) after ``n_updates`` TD3 updates on
    random transitions in one process: its Adam moments are warm."""
    from gan_rl_3d_tpu_torch.convert import agent_to_numpy

    a = agent_from_numpy(agent, td3, device="cpu")
    rng = np.random.RandomState(seed)
    for _ in range(n_updates):
        batch = rl.TransitionBatch(
            states=t(rng.randn(td3.batch_size, td3.state_dim)),
            actions=t(np.tanh(rng.randn(td3.batch_size, td3.action_dim))),
            rewards=t(rng.randn(td3.batch_size, 1)),
            next_states=t(rng.randn(td3.batch_size, td3.state_dim)),
            dones=t(rng.rand(td3.batch_size, 1) > 0.5))
        rl.agent_update(a, batch, t(rng.randn(td3.batch_size,
                                              td3.action_dim)), td3)
    return agent_to_numpy(a)


def serve(inp, mesh):
    """complete_fast on the f32 engine and the unfolded complete, the
    batch sharded and the outputs gathered."""
    d = inp["serve"]
    model = model_from_numpy(d["tree"], device="cpu")
    engine = inference.prepare_inference_engine(model)
    pc = t(d["pc"])
    fast = inference.complete_fast(engine, pc, mesh=mesh)
    with mesh_lib.use(mesh):
        local = tnet.complete(model, mesh_lib.local_rows(mesh, pc),
                              cfg=d["td3"])
        full = collectives.gather_rows(local["hybrid_output"], mesh)
    return {"fast": as_numpy(fast["hybrid_output"]),
            "complete": as_numpy(full)}


def resident_epoch(inp, mesh, *, sharded=False, key="epoch"):
    """ae_train_epoch over a device-resident split (replicated, or this
    rank's row block), and the batch rows this rank took."""
    d = inp[key]
    data = t(d["data"])
    params, state = params_of(d["params"]), tree_map(t, d["state"])
    opt, sched = tsteps.make_ae_optimizer(params, AETrainConfig(**d["opt"]),
                                          len(d["order"]))
    resident = mesh_lib.row_sharding(mesh, data) if sharded else data
    order = torch.from_numpy(d["order"]).long()
    taken = []
    with mesh_lib.use(mesh):
        for idx in order:
            taken.append(tsteps._resident_batch(
                resident, mesh_lib.local_rows(mesh, idx), sharded))
    state, m = tsteps.ae_train_epoch(
        params, state, opt, sched, resident, order,
        torch.from_numpy(d["pads"]), torch.Generator().manual_seed(d["seed"]),
        augment=False, data_sharded=sharded, mesh=mesh)
    return {"losses": m["losses"].numpy(), "taken": as_numpy(taken),
            "ae": as_numpy({"params": params, "state": state})}


def mesh_facts(inp, mesh):
    """The mesh's shape and this rank's place; the mismatch assertion;
    process_local feeding against the global path; a BN layer's
    statistics in both modes against the whole batch's."""
    out = {"shape": dict(mesh.shape), "rank": mesh.rank,
           "data_rank": mesh.data_rank, "model_rank": mesh.model_rank}
    try:
        mesh_lib.make_mesh(3, 2)
    except AssertionError as e:
        out["mismatch"] = str(e)
    batch = inp["facts"]["batch"]
    local = {k: v[mesh_lib.process_local_slice(
        len(v), mesh.data_rank, mesh.n_data)] for k, v in batch.items()}
    a = mesh_lib.shard_batch(mesh, batch)
    b = mesh_lib.shard_batch(mesh, local, process_local=True)
    out["process_local_equal"] = all(torch.equal(a[k], b[k]) for k in a)
    x = mesh_lib.local_rows(mesh, t(inp["facts"]["x"]))
    p, s = tnn.batchnorm_init(x.shape[-1])
    with mesh_lib.use(mesh):
        for mode in tnn.BN_STATS_MODES:
            y, new = tnn.batchnorm_train(p, s, x, mode=mode)
            out[mode] = as_numpy({"y": collectives.gather_rows(y, mesh),
                                  **new})
    return out


def bn_refusal(inp, mesh):
    """Whether the BatchNorm mesh guard refuses single_read_grouped on a
    data axis that splits its groups across ranks."""
    try:
        tnn.validate_bn_stats_mesh("single_read_grouped", mesh.n_data)
    except ValueError as e:
        return {"refused": "centered" in str(e)}
    return {"refused": False}


JOBS = {f.__name__: f for f in (ae_steps, ae_forced, joint_step,
                                lgan_steps, rl_steps, serve, resident_epoch,
                                mesh_facts, bn_refusal)}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _named(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, path + (i,))
    elif tree is not None:
        yield path, np.asarray(tree, np.float64)


def adam_noise(path, tree) -> bool:
    """The leaves Adam makes noise of (chip_smoke.adam_noise): a dense
    bias that feeds a training BatchNorm, the critic's such biases, and
    the BN running means that take them in. Their true gradient is 0, so
    last-bit gradients become steps of up to lr either way."""
    if path[-1] == "mean":
        return True
    if path[-1] != "b":
        return False
    if path[-2] in ("state_fc", "comb_fc1", "comb_fc2"):
        return True
    node = tree
    for k in path[:-2]:
        node = node[k]
    return path[-2] in ("dense", "conv1") and "bn" in node


def update_errors(new, ref, start) -> tuple:
    """A network's ``{"params", "state"}`` after steps against a
    reference's after the same steps from ``start``: (the largest error of
    a parameter's update, new - start, over the parameters that are not
    Adam noise, relative to the reference's largest such update element;
    the Adam-noise leaves' largest absolute error; the other state leaves'
    largest error relative to each leaf's largest element)."""
    err = moved = noise = state = diff2 = moved2 = 0.0
    start = {k: start[k] for k in ("params", "state")}
    leaves = list(zip(_named(new), _named(ref), _named(start)))
    assert len(leaves) == len(list(_named(ref)))
    for (path, a), (path_r, r), (path_s, s0) in leaves:
        assert path == path_r == path_s, (path, path_r, path_s)
        e = float(np.abs(a - r).max())
        if adam_noise(path, new):
            noise = max(noise, e)
        elif path[0] == "params":
            err = max(err, e)
            moved = max(moved, float(np.abs(r - s0).max()))
            diff2 += float(np.square(a - r).sum())
            moved2 += float(np.square(r - s0).sum())
        else:
            state = max(state, e / max(float(np.abs(r).max()), 1e-30))
    update = err / moved if moved else (0.0 if err == 0 else np.inf)
    norm = (diff2 / moved2) ** 0.5 if moved2 else (0.0 if diff2 == 0
                                                     else np.inf)
    return update, noise, state, norm


def leaves_of(tree):
    return [np.asarray(x) for x in tree_leaves(tree)]
