"""The training BatchNorm + ReLU op (``ops/bn_train.py``, kernels
``csrc/bn_train.cu``) against the composite it replaces,
``nn.dense`` -> ``nn.batchnorm_train`` -> ``torch.relu``, and its routing.

On the CPU: the kernels' arithmetic in plain PyTorch (the op's CPU path)
against the composite in float32 and float64, and which calls take the op.
On the card (``cuda``): the kernels against the composite on the card,
the forward bit for bit, bit-identical twice, and the variant AE step
through the op. Imports no JAX, so on a GPU machine it runs as

  python -m pytest --noconftest tests/test_torch_port_bn_train.py

Inputs: z ~ 0.5 + 2 N(0, 1); the dense bias, scale, bias and running
state near their initial values. The forward's statistics are summed in
the composite's own order, so y and the new running state equal the
composite's bit for bit. The backward's sums run in another order (f64
from f32 runs of 4 rows against autograd's f32 trees over up to 4.2 M
rows), which moves the gradients by about 1e-7 of their largest element
(1.4e-7 read on the CPU): held to 1e-5. Where y lies within 1e-4 of its
largest element from 0 the float64 reference may put the ReLU's kink on
the other side, so the cotangent is 0 there (``_banded``). The dense
bias's gradient is the row sum of dz, analytically 0: both sides' are
rounding noise, so it is held to its own dz's f64 sum (1e-6 of sum |dz|)
and to the composite's within 1e-5 of sum |dz| (7.6e-5 of 25.8 read on
the CPU).
"""

import dataclasses

import pytest
import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.models import common, variants
from gan_rl_3d_tpu_torch.models import latent_gan as lg
from gan_rl_3d_tpu_torch.ops import _cuda
from gan_rl_3d_tpu_torch.ops import bn_train as bt
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

TOL = 1e-5
TOL_DB_SUM = 1e-6
BAND = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, seed, device="cpu", constant=False):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    z = torch.randn(shape, generator=g) * 2 + 0.5
    b = torch.randn(c, generator=g) * 0.1
    if constant:  # x = 0.25 in channel 0: its sums are exact, var is 0
        z[..., 0] = 0.25
        b[0] = 0.0
    out = {"z": z, "b": b,
           "scale": 1 + 0.1 * torch.randn(c, generator=g),
           "bias": 0.1 * torch.randn(c, generator=g),
           "mean": 0.1 * torch.randn(c, generator=g),
           "var": 1 + 0.1 * torch.rand(c, generator=g),
           "dy": torch.randn(shape, generator=g)}
    return {k: v.to(device) for k, v in out.items()}


def _composite(inp, mode, dtype=torch.float32):
    """(y, new mean, new var, (dz, db, d_scale, d_bias), y before the ReLU)
    of dense -> batchnorm_train -> relu (the dense product given as z)."""
    z, b, scale, bias = (inp[k].to(dtype).requires_grad_(True)
                         for k in ("z", "b", "scale", "bias"))
    pre, state = nn.batchnorm_train(
        {"scale": scale, "bias": bias},
        {"mean": inp["mean"].to(dtype), "var": inp["var"].to(dtype)},
        z + b, mode=mode)
    y = torch.relu(pre)
    grads = torch.autograd.grad(y, (z, b, scale, bias),
                                _banded(inp["dy"], pre).to(dtype))
    return y.detach(), state["mean"], state["var"], grads, pre.detach()


def _banded(dy, pre):
    pre = pre.float()
    return torch.where(pre.abs() > BAND * pre.abs().max(), dy,
                       torch.zeros((), device=dy.device))


def _op(inp, mode, dy):
    z, b, scale, bias = (inp[k].clone().requires_grad_(True)
                         for k in ("z", "b", "scale", "bias"))
    grouped = mode == "single_read_grouped" and z.shape[0] % nn.BN_GROUPS == 0
    y, mean, var = bt._BNReLU.apply(z, b, scale, bias, inp["mean"],
                                    inp["var"], grouped, 0.1, 1e-5)
    grads = torch.autograd.grad(y, (z, b, scale, bias), dy)
    return y.detach(), mean, var, grads


def _rel(x, ref):
    ref = ref.double()
    return float((x.double() - ref).abs().max() / ref.abs().max().clamp(
        min=1e-30))


def _check(out, ref, forward_exact=True):
    """The gradients within TOL, db as the module docstring says; y and the
    new state bit for bit, or within TOL without ``forward_exact``."""
    y, mean, var, (dz, db, d_scale, d_bias) = out
    ry, rmean, rvar, (rdz, rdb, rd_scale, rd_bias), _ = ref
    if forward_exact:
        assert torch.equal(y, ry)
        assert torch.equal(mean, rmean) and torch.equal(var, rvar)
    for what, x, r in (("y", y, ry), ("mean", mean, rmean), ("var", var, rvar),
                       ("dz", dz, rdz), ("d_scale", d_scale, rd_scale),
                       ("d_bias", d_bias, rd_bias)):
        assert _rel(x, r) <= TOL, (what, _rel(x, r))
    dz_sum = dz.double().reshape(-1, dz.shape[-1]).sum(dim=0)
    dz_abs = rdz.double().abs().reshape(-1, rdz.shape[-1]).sum(dim=0)
    assert bool(((db.double() - dz_sum).abs() <= TOL_DB_SUM * dz_abs).all())
    assert bool(((db.double() - rdb.double()).abs() <= TOL * dz_abs).all())


# (shape, mode, a constant channel): both modes, a leading axis 8 does not
# divide (the centered form), rows off every multiple of 4, C off the
# 16-byte vector
CPU_CASES = [((16, 256, 64), "single_read_grouped", False),
             ((16, 256, 64), "centered", False),
             ((256, 128), "single_read_grouped", False),
             ((16, 128), "single_read_grouped", False),
             ((12, 50, 64), "single_read_grouped", False),
             ((13, 7, 64), "centered", False),
             ((24, 50, 30), "single_read_grouped", False),
             ((16, 256, 64), "single_read_grouped", True)]


@pytest.mark.parametrize("shape,mode,constant", CPU_CASES)
def test_plain_op_matches_the_composite(shape, mode, constant):
    """The op on CPU tensors (the kernels' arithmetic in plain PyTorch)
    against the composite's autograd in float32, the forward bit for bit,
    and in float64."""
    inp = _inputs(shape, 1, constant=constant)
    ref32 = _composite(inp, mode)
    _check(_op(inp, mode, _banded(inp["dy"], ref32[4])), ref32)
    ref64 = _composite(inp, mode, torch.float64)
    _check(_op(inp, mode, _banded(inp["dy"], ref64[4])), ref64,
           forward_exact=False)


def test_a_clamped_variance_passes_no_gradient():
    """Where the single-read variance clamped to 0 (the forward saves inv
    negated), dz keeps the mean's path alone, k g - k sum(g) / n, as the
    composite's clamp passes no gradient to the variance; the channel sums
    are unchanged."""
    inp = _inputs((16, 32, 8), 3)
    args = [inp[k] for k in ("z", "b", "scale", "bias")]
    _, stats, _, _ = bt.bn_relu_forward_plain(*args, inp["mean"], inp["var"],
                                              grouped=True)
    clamped = torch.stack([stats[0], -stats[1]])
    dz, db, d_scale, d_bias = bt.bn_relu_backward_plain(*args, clamped,
                                                        inp["dy"])
    ref = bt.bn_relu_backward_plain(*args, stats, inp["dy"])
    assert torch.equal(d_scale, ref[2]) and torch.equal(d_bias, ref[3])
    xc = (inp["z"] + inp["b"] - stats[0]).reshape(-1, 8)
    k = stats[1] * inp["scale"]
    g = torch.where(xc * k + inp["bias"] > 0, inp["dy"].reshape(-1, 8), 0.0)
    want = k * g - k * g.sum(dim=0) / g.shape[0]
    assert _rel(dz.reshape(-1, 8), want) <= TOL
    assert _rel(ref[0].reshape(-1, 8), want) > 1e-3


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _block(c_in, c, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    dense = nn.dense_init(g, c_in, c)
    bn_p, bn_s = nn.batchnorm_init(c)
    x = torch.randn(16, 10, c_in, generator=g)
    cast = lambda d: {k: v.to(dtype) for k, v in d.items()}  # noqa: E731
    return cast(dense), cast(bn_p), cast(bn_s), x.to(dtype)


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor counts as on the card; the op still runs its plain
    versions. Returns the list of the op's calls."""
    calls = []
    apply = bt._BNReLU.apply

    def recorded(*args):
        calls.append(tuple(args[0].shape))
        return apply(*args)

    monkeypatch.setattr(bt, "_on_card", lambda t: True)
    monkeypatch.setattr(bt._BNReLU, "apply", recorded)
    return calls


def test_the_cpu_takes_the_composite():
    dense, bn_p, bn_s, x = _block(6, 8)
    assert not bt.takes_op(dense, bn_p, bn_s, x)
    before = dict(_cuda.launch_counts)
    y, state = bt.dense_bn_relu_train(dense, bn_p, bn_s, x,
                                      mode="single_read_grouped")
    ry, rstate = nn.batchnorm_train(bn_p, bn_s, nn.dense(dense, x),
                                    mode="single_read_grouped")
    assert torch.equal(y, torch.relu(ry))
    assert all(torch.equal(state[k], rstate[k]) for k in ("mean", "var"))
    assert dict(_cuda.launch_counts) == before


@pytest.mark.parametrize("case,takes", [
    ("float32", True), ("bfloat16", False), ("data mesh", False),
    ("model mesh", True), ("column-sharded", False), ("one axis", False)])
def test_routing_takes_the_op_only_where_it_may(fake_card, case, takes):
    """On the card in float32 without a data mesh the op runs; a data mesh
    (cross-rank statistics), a column-sharded leaf, bf16 and a 1-D input
    take the composite. A mesh of one data rank is no data mesh."""
    dense, bn_p, bn_s, x = _block(
        6, 8, dtype=torch.bfloat16 if case == "bfloat16" else torch.float32)
    mesh = None
    if case == "data mesh":
        mesh = mesh_lib.Mesh(shape={"data": 2, "model": 1})
    elif case == "model mesh":
        mesh = mesh_lib.Mesh(shape={"data": 1, "model": 2})
    elif case == "column-sharded":
        dense["w"] = mesh_lib.mark_model_sharded(dense["w"])
    elif case == "one axis":
        x = x[0, 0]
    with mesh_lib.use(mesh):
        assert bt.takes_op(dense, bn_p, bn_s, x) == takes


def test_call_sites_route_training_relu_blocks(fake_card):
    """bn_mlp_apply sends its training BN blocks through the op when their
    activation is the ReLU, and nothing else; the adaptive decoder's
    refinement goes through it in training; the op's result is the
    composite's."""
    g = torch.Generator().manual_seed(4)
    params, state = common.bn_mlp_init(g, 3, (8, 16, 12), final_plain=True)
    x = torch.randn(16, 20, 3, generator=g)
    y, _ = common.bn_mlp_apply(params, state, x, training=True,
                               bn_stats="single_read_grouped")
    assert fake_card == [(16, 20, 8), (16, 20, 16)]
    fake_card.clear()
    for kw in ({"training": True, "activation": torch.tanh},
               {"training": False}):
        common.bn_mlp_apply(params, state, x, bn_stats="centered", **kw)
    assert fake_card == []
    with torch.no_grad():
        ref = x
        for p, s in zip(params[:2], state[:2]):
            ref = torch.relu(nn.batchnorm_train(
                p["bn"], s["bn"], nn.dense(p["dense"], ref),
                mode="single_read_grouped")[0])
        ref = nn.dense(params[2]["dense"], ref)
    assert float((y - ref).abs().max()) <= TOL * float(ref.abs().max())

    dec_p, dec_s = variants.adaptive_decoder_init(g, 8, 32, (16, 24))
    variants.adaptive_decoder_apply(dec_p, dec_s, torch.randn(8, 8),
                                    training=True,
                                    bn_stats="single_read_grouped")
    assert fake_card == [(8, 16), (8, 24), (8, 32, 64)]
    fake_card.clear()
    variants.adaptive_decoder_apply(dec_p, dec_s, torch.randn(8, 8))
    assert fake_card == []
    gen_p, gen_s = lg.generator_init(g, 4, 8, (16, 12, 8))
    lg.generator_apply(gen_p, gen_s, torch.randn(16, 4), training=True)
    assert fake_card == [(16, 16), (16, 12)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_CASES = ([((64, 2048, c), "single_read_grouped", False)
               for c in (64, 128, 256)]
              + [((2048, c), "single_read_grouped", False)
                 for c in (128, 256, 512, 1024)]
              + [((16, 128), "single_read_grouped", False),
                 ((12, 300, 64), "single_read_grouped", False),
                 ((64, 2048, 64), "centered", False),
                 ((64, 2048, 64), "single_read_grouped", True),
                 ((13, 7, 64), "centered", False),
                 ((24, 50, 30), "single_read_grouped", False)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mode,constant", CARD_CASES)
def test_op_matches_the_composite_on_card(cuda, shape, mode, constant):
    """The kernels against the composite on the card: y and the new
    running state bit for bit (the statistics summed in PyTorch's order),
    the gradients of z, b, scale and bias; a second run gives the same
    bits; each direction is one wrapper call."""
    inp = _inputs(shape, 5, cuda, constant=constant)
    ref = _composite(inp, mode)
    dy = _banded(inp["dy"], ref[4])
    before = _cuda.launch_counts.copy()
    out = _op(inp, mode, dy)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["bn_train_forward"] == \
        before["bn_train_forward"] + 1
    assert _cuda.launch_counts["bn_train_backward"] == \
        before["bn_train_backward"] + 1
    _check(out, ref)
    again = _op(inp, mode, dy)
    flat = lambda o: [*o[:3], *o[3]]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(again)))


@pytest.mark.cuda
def test_op_checks_its_inputs(cuda):
    inp = _inputs((16, 64), 6, cuda)
    with pytest.raises(ValueError):
        bt.bn_relu_forward(inp["z"], inp["b"][:32], inp["scale"],
                           inp["bias"], inp["mean"], inp["var"], grouped=True)
    with pytest.raises(ValueError):
        bt.bn_relu_forward(inp["z"][:12], inp["b"], inp["scale"],
                           inp["bias"], inp["mean"], inp["var"], grouped=True)
    with pytest.raises(ValueError):
        bt.bn_relu_forward(inp["z"].double(), inp["b"], inp["scale"],
                           inp["bias"], inp["mean"], inp["var"], grouped=True)


@pytest.mark.cuda
def test_variant_ae_step_runs_the_op_on_every_bn_layer(cuda):
    """One f32 ae_train_step of rlgan-attn-adaptive (the flagship widths)
    at B=16 on the card: the op's forward and backward wrappers each run
    once for each of its 10 training BN layers (point MLP 5, head 1,
    feature MLP 3, refinement 1), and the loss is finite."""
    import card_checks
    from gan_rl_3d_tpu_torch.config import flagship_config
    from gan_rl_3d_tpu_torch.models import rl_gan_net as net
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train import steps

    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, autoencoder=dataclasses.replace(
            cfg.model.autoencoder, **card_checks.VARIANT_TYPES)))
    model = net.init_model(torch.Generator().manual_seed(0), cfg, cuda)
    params = card_checks.on_device(model["ae"]["params"], cuda, grad=True)
    opt, _ = steps.make_ae_optimizer(params, cfg.training.autoencoder, 1)
    pc, _ = card_checks.make_clouds(16, 2048, seed=7, device=cuda)
    draws = pc_ops.draw_training_batch(
        torch.Generator(device=cuda).manual_seed(8), 16, 2048)
    before = _cuda.launch_counts.copy()
    _, m = steps.ae_train_step(
        params, model["ae"]["state"], opt,
        {"complete_pc": pc, "pad": torch.zeros(16, device=cuda)}, draws,
        bn_stats="single_read_grouped")
    assert bool(torch.isfinite(m["loss"]))
    for name in ("bn_train_forward", "bn_train_backward"):
        assert _cuda.launch_counts[name] - before[name] == 10, name
