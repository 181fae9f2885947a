"""The plain reference against the port, on the CPU at tiny sizes: the
test imports both, the reference imports neither the port nor JAX."""

import pytest
import torch

from perfbench import harness, shapes, weights
from perfbench.reference import chamfer as ref_chamfer
from perfbench.reference import nets, serve
from perfbench.reference import train as ref_train

from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.models import inference, rl_gan_net
from gan_rl_3d_tpu_torch.ops import chamfer
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops

SERVE = harness.Cell("pointnet-serve-bulk", 2**31 + 11)
TRAIN = harness.Cell("attn-adaptive-train-ae", 2**31 + 12)


def _served_model(seed):
    g = torch.Generator().manual_seed(seed)
    return weights.build(weights.serving_spec(SERVE.config["model"]), g)


def _scans(bsz, n, seed):
    g = torch.Generator().manual_seed(seed)
    return shapes.partial_scans(g, shapes.clouds(g, bsz, n), 0.2, 0.5)


def test_served_outputs_agree_with_the_folded_engine_and_complete():
    model = _served_model(1)
    pc, mask = _scans(6, 256, 2)
    ref = serve.complete(model, pc, mask, action_bound=1.0, gate_bias=0.0,
                         block=4)
    port = {"ae": model["ae"], "lgan": model["lgan"],
            "agent": {"actor": model["actor"]}}
    engine = inference.prepare_inference_engine(port)
    for got in (inference.complete_fast(engine, pc, mask),
                rl_gan_net.complete(port, pc, mask)):
        for k, r in ref.items():
            assert torch.allclose(got[k], r, rtol=1e-5, atol=1e-5 * float(
                r.abs().max())), k


def test_spectral_norm_vectors_estimate_the_spectral_norm():
    model = _served_model(3)
    for p, s in zip(model["lgan"]["params"]["discriminator"]["layers"],
                    model["lgan"]["state"]["discriminator"]["layers"]):
        w = p["dense"]["w"]
        sigma = torch.dot(s["sn"]["v"], w @ s["sn"]["u"])
        norm = torch.linalg.matrix_norm(w, ord=2)
        assert 0.95 * norm <= sigma <= norm * (1 + 1e-5)


def test_training_draws_and_transforms_match_the_step():
    bsz, n = 5, 128
    data = shapes.clouds(torch.Generator().manual_seed(4), bsz, n)
    port = pc_ops.draw_training_batch(torch.Generator().manual_seed(5), bsz,
                                      n)
    ref = ref_train.draw_step(torch.Generator().manual_seed(5), bsz, n, 0.2,
                              0.5)
    names = {"rand_scores": "scores"}
    for k, v in port.items():
        assert torch.equal(v, ref[names.get(k, k)]), k
    got = pc_ops.apply_training_batch(data, port)
    want = ref_train.prepare(data, ref, TRAIN.config["data"])
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=1e-6)


def test_chamfer_agrees_with_the_plain_kernel_versions():
    g = torch.Generator().manual_seed(6)
    a = torch.rand((3, 200, 3), generator=g, requires_grad=True)
    b = torch.rand((3, 150, 3), generator=g)
    got = chamfer.chamfer_distance(a, b)
    want = ref_chamfer.chamfer(a, b)
    assert torch.allclose(got, want, rtol=1e-5)
    ga, = torch.autograd.grad(got.sum(), a)
    wa, = torch.autograd.grad(want.sum(), a)
    # the port's distance is sqrt(|a|^2 + |b|^2 - 2 a.b) in float32, which
    # loses digits to cancellation on close pairs; the reference's is the
    # direct difference
    assert torch.norm(ga - wa) <= 1e-2 * torch.norm(wa)


def test_one_training_step_agrees_with_the_port():
    cfg = TRAIN.config
    bsz, n = 8, cfg["model"]["autoencoder"]["num_points"]
    start = weights.build(weights.ae_spec(cfg["model"]["autoencoder"], True),
                          torch.Generator().manual_seed(7))["ae"]
    data = shapes.clouds(torch.Generator().manual_seed(8), bsz, n)
    ref = ref_train.train_steps(start["params"], start["state"], [data],
                                torch.Generator().manual_seed(9), cfg, 16)
    params = {k: v.clone().requires_grad_(True)
              for k, v in nets.leaves(start["params"])}
    tree = ref_train._rebuild(start["params"], params)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(9), bsz,
                                       n)
    complete, incomplete, mask = pc_ops.apply_training_batch(data, draws)
    (recon, _), state = ae.autoencoder_apply(
        tree, start["state"], incomplete, mask, training=True,
        bn_stats=cfg["training"]["bn_stats"])
    loss = chamfer.chamfer_distance(recon, complete).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    assert torch.isclose(loss, ref["losses"][0], rtol=1e-5)
    norms = sorted(float(v.norm()) for v in ref["first_grad"].values())
    median = norms[len(norms) // 2]
    # the gradient's direction is ill-conditioned where the Chamfer loss
    # pairs close points (see the test above): a few percent at B=4; its
    # norm, which the benchmark compares, much less
    for (k, _), gr in zip(params.items(), grads):
        want = ref["first_grad"][k]
        scale = max(float(want.norm()), median)
        assert torch.norm(gr - want) <= 5e-2 * scale, k
        assert abs(float(gr.norm() - want.norm())) <= 1e-2 * scale, k
    for k, v in nets.leaves(state):
        assert torch.allclose(v, ref["state"][k], rtol=1e-4, atol=1e-6), k


@pytest.mark.parametrize("cell", [SERVE, TRAIN], ids=lambda c: c.name)
def test_weights_are_fixed_by_the_seed(cell):
    spec = (weights.serving_spec(cell.config["model"])
            if cell is SERVE else
            weights.ae_spec(cell.config["model"]["autoencoder"], True))
    a = weights.build(spec, torch.Generator().manual_seed(10))
    b = weights.build(spec, torch.Generator().manual_seed(10))
    c = weights.build(spec, torch.Generator().manual_seed(11))
    la, lb, lc = (dict(nets.leaves(t)) for t in (a, b, c))
    assert la.keys() == lb.keys() and all(torch.equal(la[k], lb[k])
                                          for k in la)
    assert any(not torch.equal(la[k], lc[k]) for k in la
               if la[k].numel() > 1 and la[k].std() > 0)


@pytest.mark.parametrize("stats", ["centered", "single_read_grouped"])
def test_batch_statistics_follow_the_configured_mode(stats):
    from gan_rl_3d_tpu_torch import nn as port_nn

    g = torch.Generator().manual_seed(12)
    # a channel whose mean is large against its spread, where one read of
    # E[x^2] - E[x]^2 loses digits that two passes keep
    x = torch.randn((16, 64, 5), generator=g) * 0.01 + torch.tensor(
        [0.0, 0.5, 1.0, 3.0, 10.0])
    params = {"scale": torch.ones(5), "bias": torch.zeros(5)}
    state = {"mean": torch.zeros(5), "var": torch.ones(5)}
    want = nets.bn_train(params, state, x, stats)
    got = port_nn.batchnorm_train(params, state, x, mode=stats)
    assert torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        assert torch.allclose(got[1][k], want[1][k], rtol=1e-6, atol=0)
    # both lose the same digits to one read: the reference follows the
    # configured statistics, not the exact ones
    exact = x.double().reshape(-1, 5).var(dim=0, unbiased=False)
    err = (nets.batch_moments(x, stats)[1].double() - exact).abs() / exact
    assert float(err.max()) < 1e-6 if stats == "centered" \
        else float(err[-1]) > 1e-2
