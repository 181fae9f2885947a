"""Kernel-vs-plain tests for the port's CUDA kernels (K1-K6), the Chamfer
gradient and the int8 engine on the card, and the wrappers' device routing.
Imports no JAX, so on a GPU machine it runs as

  python -m pytest --noconftest tests/test_torch_port_cuda.py

The ``cuda`` tests skip where no GPU is visible."""

import numpy as np
import pytest
import torch

import chip_smoke
from gan_rl_3d_tpu_torch.ops import _cuda
from gan_rl_3d_tpu_torch.ops import chamfer, encoder_kernel as ek
from gan_rl_3d_tpu_torch.ops.metrics import evaluate_completion
from gan_rl_3d_tpu_torch.ops.quantize import quantize_encoder
from gan_rl_3d_tpu_torch.utils.tree import tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layers(dims, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    out = []
    for k, c in zip(dims[:-1], dims[1:]):
        w = (torch.rand(k, c, generator=g) * 2 - 1) / k ** 0.5
        b = (torch.rand(c, generator=g) * 2 - 1) * 0.1
        out.append((w.to(device), b.to(device)))
    return out


def _clouds(bsz, n, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    pc = torch.rand(bsz, n, 3, generator=g) * 2 - 1
    keep = torch.randint(1, n + 1, (bsz, 1), generator=g)
    mask = (torch.arange(n)[None, :] < keep).float()
    return pc.to(device), mask.to(device)


DIMS = (3, 64, 128, 128, 256, 128)


def test_cpu_tensors_take_the_plain_versions():
    layers = _layers(DIMS, 0)
    pc, mask = _clouds(2, 100, 1)
    before = dict(_cuda.launch_counts)
    assert torch.equal(ek.fused_encoder_pool(pc, layers, mask),
                       ek.fused_encoder_pool_plain(pc, layers, mask))
    d, i = chamfer.nearest_distances(pc, pc[:, :50], b_mask=mask[:, :50])
    rd, ri = chamfer.nearest_distances_plain(pc, pc[:, :50], mask[:, :50])
    assert torch.equal(d, rd) and torch.equal(i, ri)
    assert torch.equal(chamfer.nearest_min_distances(pc, pc),
                       chamfer.nearest_min_distances_plain(pc, pc))
    g = torch.rand(d.shape, generator=torch.Generator().manual_seed(2))
    da = chamfer.nearest_grad_a(pc, pc[:, :50], i, d, g)
    assert torch.equal(da, chamfer.nearest_grad_a_plain(pc, pc[:, :50], i, d,
                                                        g))
    assert torch.equal(chamfer.nearest_grad_b(i, da, 50),
                       chamfer.nearest_grad_b_plain(i, da, 50))
    assert dict(_cuda.launch_counts) == before


def test_library_path_is_keyed_by_source_and_flags():
    paths = {_cuda.library_path(n) for n in _cuda.SOURCES}
    assert len(paths) == len(_cuda.SOURCES)
    for p in paths:
        assert p.parent == _cuda.BUILD_DIR and p.suffix == ".so"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [2048, 1000])
def test_encoder_pool_kernel_matches_plain(cuda, dtype, tol, masked, n):
    layers = [(w.to(dtype), b.to(dtype)) for w, b in _layers(DIMS, 2, cuda)]
    pc, mask = _clouds(5, n, 3, cuda)
    m = mask if masked else None
    before = _cuda.launch_counts.copy()
    out = ek.fused_encoder_pool(pc, layers, m, compute_dtype=dtype)
    torch.cuda.synchronize()
    ref = ek.fused_encoder_pool_plain(pc, layers, m, compute_dtype=dtype)
    err = float((out - ref).abs().max() / ref.abs().max().clamp(min=1.0))
    assert err <= tol, err
    assert sum(_cuda.launch_counts.values()) == sum(before.values()) + 1


def _qenc(dims, seed, device):
    return tree_map(lambda x: x.to(device),
                    quantize_encoder(_layers(dims, seed)))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [DIMS, (3, 16, 32, 32, 64, 32)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [2048, 1000])
def test_encoder_pool_int8_kernel_matches_plain(cuda, dims, masked, n):
    """K6 against its plain version: expected equal bit for bit (exact int32
    sums, the plain version's rounding steps); held to the JAX package's
    kernel-vs-twin bound, rtol 1e-2 and atol 1e-3. A fully masked cloud
    pools to -inf."""
    qenc = _qenc(dims, 4, cuda)
    pc, mask = _clouds(5, n, 5, cuda)
    mask[1] = 0.0
    m = mask if masked else None
    before = _cuda.launch_counts["encoder_pool_int8"]
    out = ek.fused_encoder_pool_int8(pc, qenc, m)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["encoder_pool_int8"] == before + 1
    ref = ek.fused_encoder_pool_int8_plain(pc, qenc, m)
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    assert torch.allclose(out[fin], ref[fin], rtol=1e-2, atol=1e-3)
    if masked:
        assert bool(torch.isneginf(out[1]).all())


@pytest.mark.cuda
def test_encoder_pool_int8_checks_its_inputs(cuda):
    pc, _ = _clouds(2, 64, 6, cuda)
    with pytest.raises(ValueError, match="multiple of 4 and C of 8"):
        ek.fused_encoder_pool_int8(pc, _qenc((3, 16, 20), 7, cuda))
    qenc = _qenc(DIMS, 7, cuda)
    wq, s_w, b = qenc["layers_q"][0]
    with pytest.raises(ValueError, match="int8"):
        ek.fused_encoder_pool_int8(
            pc, {**qenc, "layers_q": [(wq.float(), s_w, b)]
                 + qenc["layers_q"][1:]})
    with pytest.raises(ValueError, match="device"):
        ek.fused_encoder_pool_int8(pc, tree_map(lambda x: x.cpu(), qenc))


@pytest.mark.cuda
def test_int8_engine_on_card_matches_cpu(cuda):
    """complete_fast with an int8 engine on the card (K6) against the same
    engine on the CPU (the plain version): K6's pool equals the plain
    one's, so only the f32 tail's sums differ, 1e-4 scaled by
    max(1, |ref|)."""
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import inference

    cfg = chip_smoke._flagship()
    model = model_from_numpy(chip_smoke.init_numpy_model(cfg, seed=1),
                             device="cpu")
    engine = inference.prepare_inference_engine(model, quantize_int8=True)
    on_card = tree_map(lambda x: x.to(cuda), engine)
    pc, mask = _clouds(4, 2048, 12)
    ref = inference.complete_fast(engine, pc, mask, gate_mode="rl")
    before = _cuda.launch_counts["encoder_pool_int8"]
    out = inference.complete_fast(on_card, pc.to(cuda), mask.to(cuda),
                                  gate_mode="rl")
    assert _cuda.launch_counts["encoder_pool_int8"] == before + 1
    for k in ref:
        assert chip_smoke.scaled_err(out[k].cpu(), ref[k]) <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2048, 2048), (1001, 777), (5, 3000)])
@pytest.mark.parametrize("masked", [False, True])
def test_nn_kernels_match_plain(cuda, n, m, masked):
    a, _ = _clouds(3, n, 4, cuda)
    b, b_mask = _clouds(3, m, 5, cuda)
    bm = b_mask if masked else None
    d, i = chamfer.nearest_distances(a, b, b_mask=bm)
    torch.cuda.synchronize()
    rd, ri = chamfer.nearest_distances_plain(a, b, bm)
    assert float((d - rd).abs().max()) <= 1e-3
    d2 = chamfer._sqdist(a, b, bm)
    top2 = d2.topk(min(2, m), dim=-1, largest=False).values
    settled = (top2[..., -1] - top2[..., 0]) > 1e-4
    assert bool(((i == ri) | ~settled).all())
    if masked:
        assert bool((b_mask.gather(1, i.long()) > 0).all())
    dm = chamfer.nearest_min_distances(a, b)
    assert float((dm - chamfer.nearest_min_distances_plain(a, b))
                 .abs().max()) <= 1e-3


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_need_a_gradient(cuda):
    """K2 has no backward, as in the JAX package; K3 has one (K4/K5)."""
    a, _ = _clouds(2, 64, 6, cuda)
    a.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        chamfer.nearest_min_distances(a, a.detach())
    with torch.no_grad():
        chamfer.nearest_min_distances(a, a)
    d, _ = chamfer.nearest_distances(a, a.detach() + 0.01)
    d.sum().backward()
    assert a.grad is not None and bool(torch.isfinite(a.grad).all())


def _grad_inputs(bsz, n, m, seed, device, masked):
    a, _ = _clouds(bsz, n, seed, device)
    b, b_mask = _clouds(bsz, m, seed + 1, device)
    bm = b_mask if masked else None
    dist, idx = chamfer.nearest_distances(a, b, b_mask=bm)
    g = 0.5 + torch.rand(bsz, n, generator=torch.Generator().manual_seed(seed))
    return a, b, bm, dist, idx, g.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2048, 2048), (1001, 777), (5000, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_grad_kernels_match_plain(cuda, n, m, masked):
    """K4 rounds as its plain version does; K5 sums in increasing i, the
    plain scatter_add_ in another order: 1e-5 scaled by max(1, |ref|)."""
    a, b, bm, dist, idx, g = _grad_inputs(3, n, m, 8, cuda, masked)
    before = _cuda.launch_counts.copy()
    da = chamfer.nearest_grad_a(a, b, idx, dist, g)
    db = chamfer.nearest_grad_b(idx, da, m)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["nn_gather"] == before["nn_gather"] + 1
    assert _cuda.launch_counts["nn_scatter"] == before["nn_scatter"] + 1
    for out, ref in ((da, chamfer.nearest_grad_a_plain(a, b, idx, dist, g)),
                     (db, chamfer.nearest_grad_b_plain(idx, da, m))):
        err = float((out - ref).abs().max() / ref.abs().max().clamp(min=1.0))
        assert err <= 1e-5, err
    # deterministic: the same inputs give the same bits
    assert torch.equal(db, chamfer.nearest_grad_b(idx, da, m))
    if bm is not None:
        assert float(db[bm == 0].abs().max()) == 0.0


@pytest.mark.cuda
def test_grad_kernels_check_their_inputs(cuda):
    a, b, _, dist, idx, g = _grad_inputs(2, 64, 32, 9, cuda, False)
    with pytest.raises(ValueError, match="int32"):
        chamfer.nearest_grad_a(a, b, idx.long(), dist, g)
    with pytest.raises(ValueError, match="expected"):
        chamfer.nearest_grad_b(idx[:, :10], torch.zeros(2, 64, 3,
                                                        device=cuda), 32)
    with pytest.raises(ValueError, match="b on cpu"):
        chamfer.nearest_grad_a(a, b.cpu(), idx, dist, g)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_gradient_on_card_matches_cpu(cuda, masked):
    """The autograd Function with the kernels against the same Function on
    CPU copies (the plain versions). Distances differ in the last bits,
    and g / dist carries that into the gradient: 1e-4 of its largest
    element; points whose neighbour flips in a near-tie are left out."""
    a, _ = _clouds(4, 2048, 10, cuda)
    b, b_mask = _clouds(4, 1500, 11, cuda)
    err, flipped, masked_grad = chip_smoke.chamfer_grad_vs_cpu(
        a, b, b_mask if masked else None)
    assert err <= 1e-4 and flipped <= 16, (err, flipped)
    assert masked_grad == 0.0


@pytest.mark.cuda
def test_evaluate_completion_on_card_matches_cpu(cuda):
    a, _ = _clouds(4, 512, 7)
    b = a + 0.01 * torch.randn(a.shape, generator=torch.Generator().manual_seed(8))
    metrics = ("chamfer_distance", "completion_ratio", "hausdorff_distance",
               "f_score")
    ref = evaluate_completion(a, b, metrics=metrics)
    out = evaluate_completion(a.to(cuda), b.to(cuda), metrics=metrics)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), atol=1e-3)
