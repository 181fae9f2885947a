"""The port's mesh layer (gan_rl_3d_tpu_torch/parallel/): the mesh and
its batch arithmetic against the JAX package's, BatchNorm's statistics
across ranks, data-parallel serving, and the world of one process, where
nothing communicates. Multi-rank cases run on gloo ranks spawned by
tests/torch_port_dist_worker.py (which imports no JAX)."""

import jax
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu.parallel import mesh as jmesh
from gan_rl_3d_tpu_torch import nn as tnn
from gan_rl_3d_tpu_torch import config as tcfg
from gan_rl_3d_tpu_torch.data import dataset as tdataset
from gan_rl_3d_tpu_torch.parallel import collectives
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
from gan_rl_3d_tpu_torch.train import steps as tsteps
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves
from test_torch_port_parallel_train import (OVERRIDES, _np, ae_inputs,
                                            jax_model, one_thread,  # noqa: F401
                                            joint_inputs)

import torch_port_dist_worker as worker

N_POINTS = 256
SHAPES = [(8, 1), (4, 2), (2, 4)]


def test_make_mesh_without_a_process_group_is_one_by_one():
    """No process group: a 1x1 mesh, no groups; a larger mesh fails with
    the JAX package's assertion text."""
    m = mesh_lib.make_mesh()
    assert m.shape == {"data": 1, "model": 1}
    assert m.data_group is None and m.model_group is None
    with pytest.raises(AssertionError, match="2x1 mesh needs 2 devices, "
                                             "have 1"):
        mesh_lib.make_mesh(2)
    assert mesh_lib.DATA_AXIS == jmesh.DATA_AXIS
    assert mesh_lib.MODEL_AXIS == jmesh.MODEL_AXIS
    assert mesh_lib.DATA_SHARD_GROUPS == jmesh.DATA_SHARD_GROUPS \
        == tdataset.DATA_SHARD_GROUPS


def test_process_local_slice_matches_jax():
    """test_process_local_slice_arithmetic against JAX's function."""
    for p in range(4):
        assert mesh_lib.process_local_slice(64, p, 4) == \
            jmesh.process_local_slice(64, p, 4)
    rows = np.arange(64)
    np.testing.assert_array_equal(np.concatenate(
        [rows[mesh_lib.process_local_slice(64, p, 4)] for p in range(4)]),
        rows)
    for fn in (mesh_lib.process_local_slice, jmesh.process_local_slice):
        with pytest.raises(ValueError, match="divide evenly"):
            fn(30, 0, 4)
    s = mesh_lib.process_local_slice(8)
    assert (s.start, s.stop) == (0, 8)


def test_tensor_parallel_placement_rule_matches_jax():
    """test_tensor_parallel_placement: the port's rule names the leaves
    JAX's _spec_for_param shards (the decoder head, the 512-wide GAN
    layers), on the whole model tree."""
    model = _np(jax_model(OVERRIDES)[1])
    jm = jmesh.make_mesh(n_data=4, n_model=2)
    ref = [leaf.sharding.spec != jax.sharding.PartitionSpec()
           for leaf in jax.tree.leaves(jmesh.shard_model_for_mesh(jm, model))]
    marks = mesh_lib.model_sharded_leaves(model)
    port = tree_leaves(marks)
    assert port == ref and any(port)
    assert marks["ae"]["params"]["decoder"]["mlp"][2]["dense"]["w"]
    assert not marks["ae"]["params"]["encoder"]["point_mlp"][0]["dense"]["w"]


def test_world_of_one_takes_the_single_process_path():
    """A 1x1 mesh (no process group) activates nothing: an AE step and a
    joint step give the bits of mesh=None, and every collective is the
    identity."""
    d = ae_inputs()
    inputs = {"ae": {**d, "draws": d["draws"][:1]}}
    a = worker.ae_steps(inputs, None)
    b = worker.ae_steps(inputs, mesh_lib.make_mesh())
    assert a["losses"] == b["losses"]
    for x, y in zip(tree_leaves(a["ae"]), tree_leaves(b["ae"])):
        np.testing.assert_array_equal(x, y)
    j = {"joint": joint_inputs()[4]}
    a, b = worker.joint_step(j, None), worker.joint_step(
        j, mesh_lib.make_mesh())
    assert a["loss"] == b["loss"]
    for x, y in zip(tree_leaves(a["nets"]), tree_leaves(b["nets"])):
        np.testing.assert_array_equal(x, y)
    m = mesh_lib.make_mesh()
    with mesh_lib.use(m):
        assert mesh_lib.active() is None
    x = torch.arange(6.0).reshape(2, 3)
    for fn in (collectives.gather_rows, collectives.sum_values,
               collectives.gather_columns, collectives.enter_columns):
        assert torch.equal(fn(x, m), x)
    assert mesh_lib.shard_model_for_mesh(m, {"w": x})["w"] is x


@pytest.fixture(scope="module")
def facts(tmp_path_factory):
    model = jax_model(OVERRIDES)[1]
    rng = np.random.RandomState(0)
    inputs = {
        "facts": {"batch": {"complete_pc": rng.randn(16, N_POINTS, 3)
                            .astype(np.float32),
                            "pad": np.zeros(16, np.float32)},
                  "x": (rng.randn(16, 8, 24) * 3 + 1).astype(np.float32)},
        "serve": {"tree": _np({k: model[k] for k in ("ae", "lgan",
                                                      "agent")}),
                  "pc": np.asarray(jax.random.normal(
                      jax.random.PRNGKey(3), (16, N_POINTS, 3))),
                  "td3": tcfg.load_config(None,
                                          overrides=OVERRIDES).td3_config()}}
    jobs = [(f"facts{n}x{m}", "mesh_facts", (n, m), {}) for n, m in SHAPES]
    jobs.append(("serve", "serve", (8, 1), {}))
    return inputs, worker.spawn(8, tmp_path_factory.mktemp("dist_mesh"),
                                inputs, jobs)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_shapes_and_rank_layout(facts, shape):
    """test_mesh_construction on 8 ranks ({data 8}, 4x2, 2x4): ranks laid
    out ranks.reshape(n_data, n_model), the mismatch assertion's text,
    and process-local feeding equal to the global path
    (test_shard_batch_process_local_matches_global)."""
    _, runs = facts
    n, m = shape
    layout = np.arange(8).reshape(n, m)
    for r, res in enumerate(runs[f"facts{n}x{m}"]):
        assert res["shape"] == {"data": n, "model": m}
        assert res["rank"] == r
        assert layout[res["data_rank"], res["model_rank"]] == r
        assert res["mismatch"] == "3x2 mesh needs 6 devices, have 8"
        assert res["process_local_equal"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", tnn.BN_STATS_MODES)
def test_batchnorm_statistics_across_the_data_group(facts, shape, mode):
    """A training BatchNorm over the rows of every data rank equals the
    one-process BatchNorm of the whole batch: the normalised output and
    the running mean and variance (the unbiased n of the global batch),
    in both statistics modes (single_read_grouped gathers each rank's
    8 / n_data groups and combines all 8 in one order)."""
    inputs, runs = facts
    x = torch.from_numpy(inputs["facts"]["x"])
    p, s = tnn.batchnorm_init(x.shape[-1])
    y, new = tnn.batchnorm_train(p, s, x, mode=mode)
    for res in runs[f"facts{shape[0]}x{shape[1]}"]:
        got = res[mode]
        np.testing.assert_allclose(got["y"], y.numpy(), rtol=1e-5,
                                   atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], new[k].numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_engine_serving_dp8_matches_one_process(facts):
    """test_engine_serving_dp8_matches_single_device: the f32 engine
    replicated, the batch sharded over 8 ranks, the outputs gathered:
    equal to the engine in one process within 1e-5; and
    test_complete_runs_sharded: the unfolded complete under DP-8 is
    finite, of the batch's shape, and equal to one process."""
    inputs, runs = facts
    single = worker.serve(inputs, None)
    for res in runs["serve"]:
        np.testing.assert_allclose(res["fast"], single["fast"], rtol=1e-5,
                                   atol=1e-5)
        assert res["complete"].shape == (16, N_POINTS, 3)
        assert np.isfinite(res["complete"]).all()
        np.testing.assert_allclose(res["complete"], single["complete"],
                                   rtol=1e-5, atol=1e-5)


def test_masked_mean_divides_by_the_groups_count():
    """Under a mesh a loss is this rank's term of the global mean: its
    rows' sum over the data group's count of real rows (here a group of
    one, where the term is the mean)."""
    per, pad = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 0.0, 1.0])
    assert float(tsteps._masked_mean(per, pad)) == 1.5
