"""Kernel-vs-plain tests for the port's CUDA kernels (K1-K6), the Chamfer
gradient and the int8 engine on the card, and the wrappers' device routing.
Imports no JAX, so on a GPU machine it runs as

  python -m pytest --noconftest tests/test_torch_port_cuda.py

The ``cuda`` tests skip where no GPU is visible."""

import numpy as np
import pytest
import torch

import card_checks
from gan_rl_3d_tpu_torch.config import flagship_config
from gan_rl_3d_tpu_torch.ops import _cuda
from gan_rl_3d_tpu_torch.ops import chamfer, encoder_kernel as ek
from gan_rl_3d_tpu_torch.ops.metrics import evaluate_completion
from gan_rl_3d_tpu_torch.ops.quantize import quantize_encoder
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dims,bsz,n", [
    ((3, 24, 40, 72, 200, 8), 1, 1000),   # odd widths, B=1
    ((3, 24, 40, 72, 200, 8), 4, 1000),
    ((3, 64, 512, 128), 3, 700),          # a 512-wide layer: 32-point tile
    ((3, 512, 512, 96), 2, 300),
    ((3, 907, 907, 8), 2, 100),           # the widest pair either takes
    ((3, 100), 2, 77),                    # one layer
])
def test_encoder_pool_kernel_takes_every_width(cuda, dtype, tol, dims, bsz,
                                               n):
    """K1 at ragged widths and tiles, masked with the first cloud fully
    masked (it pools to -inf) and unmasked; within 1e-4 scaled (f32) and
    2e-2 relative (bf16) of the plain version."""
    layers = [(w.to(dtype), b.to(dtype)) for w, b in _layers(dims, 15, cuda)]
    pc, mask = _clouds(bsz, n, 16, cuda)
    mask[0] = 0.0
    for m in (None, mask):
        before = _cuda.launch_counts.copy()
        out = ek.fused_encoder_pool(pc, layers, m, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert sum(_cuda.launch_counts.values()) == sum(before.values()) + 1
        ref = ek.fused_encoder_pool_plain(pc, layers, m, compute_dtype=dtype)
        assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
        fin = torch.isfinite(ref)
        if m is not None:
            assert bool(torch.isneginf(out[0]).all())
        if fin.any():
            err = float((out[fin] - ref[fin]).abs().max()
                        / ref[fin].abs().max().clamp(min=1.0))
            assert err <= tol, err


@pytest.mark.cuda
def test_encoder_pool_kernel_refuses_what_no_tile_fits(cuda):
    pc, _ = _clouds(1, 64, 17, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ek.fused_encoder_pool(pc, _layers((3, 908, 908, 8), 18, cuda))


EVERY_WIDTH = [(3, 24, 40, 72, 200, 8), (3, 64, 512, 128), (3, 512, 512, 96),
               (3, 907, 907, 8), (3, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", EVERY_WIDTH)
def test_encoder_pool_bf16_instance_follows_the_widths(cuda, dims):
    """K1 bf16 runs the instance that bf16_instance names (the tensor-core
    one up to 256 after padding, the CUDA-core one above), counted under
    its own name, within 2e-2 of the plain version at N=1000, masked with
    a fully masked cloud (-inf) and unmasked."""
    name = {"mma": "encoder_pool_bf16",
            "wide": "encoder_pool_bf16_wide"}[ek.bf16_instance(dims)]
    layers = [(w.bfloat16(), b.bfloat16()) for w, b in _layers(dims, 31, cuda)]
    pc, mask = _clouds(3, 1000, 32, cuda)
    mask[2] = 0.0
    for m in (None, mask):
        before = _cuda.launch_counts.copy()
        out = ek.fused_encoder_pool(pc, layers, m,
                                    compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert _cuda.launch_counts[name] == before[name] + 1
        assert sum(_cuda.launch_counts.values()) == sum(before.values()) + 1
        ref = ek.fused_encoder_pool_plain(pc, layers, m,
                                          compute_dtype=torch.bfloat16)
        assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
        fin = torch.isfinite(ref)
        err = float((out[fin] - ref[fin]).abs().max() / ref[fin].abs().max())
        assert err <= 2e-2, err
    assert bool(torch.isneginf(out[2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dims", EVERY_WIDTH)
def test_encoder_pool_int8_takes_every_width(cuda, dims):
    """The int8 engine's K6 at every width list K1 takes, through the
    instance int8_instance names (the wide one above 256), bit for bit
    equal to the plain version, masked with a fully masked cloud (-inf)
    and unmasked."""
    name = {"mma": "encoder_pool_int8",
            "wide": "encoder_pool_int8_wide"}[ek.int8_instance(dims)]
    qenc = _qenc(dims, 33, cuda)
    pc, mask = _clouds(3, 1000, 34, cuda)
    mask[0] = 0.0
    for m in (None, mask):
        before = _cuda.launch_counts[name]
        out = ek.fused_encoder_pool_int8(pc, qenc, m)
        torch.cuda.synchronize()
        assert _cuda.launch_counts[name] == before + 1
        ref = ek.fused_encoder_pool_int8_plain(pc, qenc, m)
        assert torch.equal(out, ref), int((out != ref).sum())
    assert bool(torch.isneginf(out[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_wide_instances_at_the_flagship_widths(cuda, masked):
    """The instances for wide layers, called at the flagship widths (no
    main path takes them there): K6's wide instance equal to its mma.sync
    instance and the plain version bit for bit, the CUDA-core K1 bf16
    within 2e-2 of the plain version."""
    qenc = _qenc(DIMS, 35, cuda)
    pc, mask = _clouds(4, 2048, 36, cuda)
    m = mask if masked else None
    wide = ek.encoder_pool_int8_packed(pc, ek.pack_int8_encoder(qenc, "wide"),
                                       m)
    assert torch.equal(wide, ek.fused_encoder_pool_int8(pc, qenc, m))
    assert torch.equal(wide, ek.fused_encoder_pool_int8_plain(pc, qenc, m))
    layers = [(w.bfloat16(), b.bfloat16()) for w, b in _layers(DIMS, 37, cuda)]
    before = _cuda.launch_counts["encoder_pool_bf16_wide"]
    out = ek.encoder_pool_cuda_cores(pc, layers, m,
                                     compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["encoder_pool_bf16_wide"] == before + 1
    ref = ek.fused_encoder_pool_plain(pc, layers, m,
                                      compute_dtype=torch.bfloat16)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 2e-2


@pytest.mark.cuda
def test_launch_geometry_is_kept_across_shared_memory_sizes(cuda):
    """One instance launched at widths that need more, then less, then more
    shared memory (K1 f32's 32-point tile; K6's wide instance) stays equal
    to the plain version: the cached geometry never lowers the limit that
    a larger launch needs."""
    pc, mask = _clouds(2, 300, 38, cuda)
    for dims in ((3, 907, 907, 8), (3, 64, 512, 128), (3, 907, 907, 8)):
        layers = _layers(dims, 39, cuda)
        out = ek.fused_encoder_pool(pc, layers, mask)
        ref = ek.fused_encoder_pool_plain(pc, layers, mask)
        assert float((out - ref).abs().max()) <= 1e-4 * max(
            1.0, float(ref.abs().max()))
        qenc = _qenc(dims, 40, cuda)
        assert torch.equal(ek.fused_encoder_pool_int8(pc, qenc, mask),
                           ek.fused_encoder_pool_int8_plain(pc, qenc, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("source,kernel", [
    ("encoder_pool_bf16", "encoder_pool_bf16_kernel"),
    ("encoder_pool_int8_wide", "encoder_pool_int8_wide_kernel"),
    ("encoder_pool_int8", "encoder_pool_int8_kernel"),
    ("encoder_pool", "encoder_pool_kernel"),
    ("nn_dist", "nn_kernel")])
def test_instances_do_not_spill(cuda, source, kernel):
    """ptxas reports no spill for any instance of K1, K6 or K3/K2, and at
    most 255 registers a thread."""
    report = card_checks.ptxas_report(_cuda.build_log(source))
    found = {k: v for k, v in report.items() if k.startswith(kernel + "<")}
    assert found, report
    for name, info in found.items():
        assert "0 B spill stores, 0 B spill loads" in info, (name, info)
        assert int(info.split()[0]) <= 255, (name, info)
    if source == "encoder_pool_bf16":
        for masked in (False, True):
            for flagship in (False, True):
                regs, _ = ek.encoder_pool_bf16_attributes(masked, flagship)
                assert 0 < regs <= 255


def _qenc(dims, seed, device):
    return tree_map(lambda x: x.to(device),
                    quantize_encoder(_layers(dims, seed)))


# widths off every multiple of 32
RAGGED_INT8 = (3, 20, 36, 100, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [DIMS, (3, 16, 32, 32, 64, 32), RAGGED_INT8,
                                  (3, 16, 20)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [2048, 1000])
def test_encoder_pool_int8_kernel_matches_plain(cuda, dims, masked, n):
    """K6 against its plain version, bit for bit: exact int32 sums on the
    tensor cores, the plain version's rounding steps, and padding that
    moves no bit. A fully masked cloud pools to -inf."""
    qenc = _qenc(dims, 4, cuda)
    pc, mask = _clouds(5, n, 5, cuda)
    mask[1] = 0.0
    m = mask if masked else None
    before = _cuda.launch_counts["encoder_pool_int8"]
    out = ek.fused_encoder_pool_int8(pc, qenc, m)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["encoder_pool_int8"] == before + 1
    ref = ek.fused_encoder_pool_int8_plain(pc, qenc, m)
    assert torch.equal(out, ref), int((out != ref).sum())
    if masked:
        assert bool(torch.isneginf(out[1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 3])
def test_encoder_pool_int8_ragged_widths_and_masked_cloud(cuda, bsz):
    """K6 at ragged widths, N=1000, masked, at B=1 and at B=3 with the last
    cloud fully masked (-inf): equal to the plain version."""
    qenc = _qenc(RAGGED_INT8, 23, cuda)
    pc, mask = _clouds(bsz, 1000, 24, cuda)
    if bsz > 1:
        mask[-1] = 0.0
    out = ek.fused_encoder_pool_int8(pc, qenc, mask)
    torch.cuda.synchronize()
    ref = ek.fused_encoder_pool_int8_plain(pc, qenc, mask)
    assert out.shape == (bsz, RAGGED_INT8[-1])
    assert torch.equal(out, ref), int((out != ref).sum())
    if bsz > 1:
        assert bool(torch.isneginf(out[-1]).all())


@pytest.mark.cuda
def test_encoder_pool_int8_after_in_place_weight_edit(cuda):
    """A second call after an in-place edit of one wq repacks (the memo is
    keyed by the version counter) and gives the new result; an unchanged
    bundle is packed once."""
    qenc = _qenc(DIMS, 25, cuda)
    pc, mask = _clouds(4, 700, 26, cuda)
    packs = ek.packed_int8_encoder.packs
    first = ek.fused_encoder_pool_int8(pc, qenc, mask)
    assert torch.equal(first, ek.fused_encoder_pool_int8(pc, qenc, mask))
    assert ek.packed_int8_encoder.packs == packs + 1
    wq = qenc["layers_q"][1][0]
    wq.copy_(-wq)
    out = ek.fused_encoder_pool_int8(pc, qenc, mask)
    torch.cuda.synchronize()
    assert ek.packed_int8_encoder.packs == packs + 2
    ref = ek.fused_encoder_pool_int8_plain(pc, qenc, mask)
    assert torch.equal(out, ref) and not torch.equal(out, first)


@pytest.mark.cuda
def test_encoder_pool_int8_divide_is_the_ieee_divide(cuda):
    """K6 quantizes with a refined reciprocal and one correction instead of
    __fdiv_rn: the same bits on 2^28 quotients, near-ties included."""
    assert ek.int8_divide_mismatches(1 << 28, 1, cuda) == 0


@pytest.mark.cuda
def test_encoder_pool_int8_checks_its_inputs(cuda):
    pc, _ = _clouds(2, 64, 6, cuda)
    with pytest.raises(ValueError, match="exceed K6's shared memory"):
        ek.fused_encoder_pool_int8(pc, _qenc((3, 16, 1800), 7, cuda))
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

    cfg = flagship_config()
    model = model_from_numpy(card_checks.init_numpy_model(cfg, seed=1),
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
        assert card_checks.scaled_err(out[k].cpu(), ref[k]) <= 1e-4, k


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
def test_nn_min_equals_nn_dist_bit_for_bit(cuda):
    """K2's distances equal K3's unmasked ones bit for bit at B=64,
    N=M=2048 and at card_checks.NN_RAGGED's shapes."""
    card_checks.nn_k2_equals_k3(cuda)


@pytest.mark.cuda
def test_nn_dist_mask_of_ones_equals_no_mask(cuda):
    card_checks.nn_ones_mask(cuda)


@pytest.mark.cuda
def test_nn_dist_duplicates_give_the_first_copy(cuda):
    """Exact duplicates in b within a sub-tile and across the sub-tile and
    tile boundaries (card_checks.NN_TIES) give the first copy."""
    card_checks.nn_duplicate_ties(cuda)


@pytest.mark.cuda
def test_nn_kernels_on_ragged_shapes(cuda):
    """(N, M) = (1, 1), (7, 3000), (1001, 777), (2048, 2048), B=3, masked
    with a fully masked cloud and unmasked, against the plain versions."""
    assert max(card_checks.nn_ragged(cuda)) <= card_checks.TOL_DIST


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
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bsz,n,m", [(64, 2048, 2048), (3, 2501, 777)])
def test_scatter_kernel_equals_ordered_plain(cuda, masked, bsz, n, m):
    """K5 and its plain version add the same f32 values in the same order
    (increasing i per target): equal bit for bit, on K3's indices."""
    _, _, _, _, idx, _ = _grad_inputs(bsz, n, m, 13, cuda, masked)
    da = torch.randn(bsz, n, 3, generator=torch.Generator().manual_seed(14))
    da = da.to(cuda)
    db = chamfer.nearest_grad_b(idx, da, m)
    torch.cuda.synchronize()
    assert torch.equal(db, chamfer.nearest_grad_b_plain(idx, da, m))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(card_checks.SCATTER_CASES))
def test_scatter_kernel_on_adversarial_targets(cuda, case):
    """Every point on one target, all distinct, M > N, N > M, a cloud past
    shared memory and B=2, N=M=20000: equal to the plain version, and two
    launches give the same bits."""
    _, idx, da, m = next(c for c in card_checks.scatter_cases(cuda)
                         if c[0] == case)
    before = _cuda.launch_counts["nn_scatter"]
    db = chamfer.nearest_grad_b(idx, da, m)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["nn_scatter"] == before + 1
    assert torch.equal(db, chamfer.nearest_grad_b_plain(idx, da, m))
    assert torch.equal(db, chamfer.nearest_grad_b(idx, da, m))


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
    err, flipped, masked_grad = card_checks.chamfer_grad_vs_cpu(
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


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_kernels_take_batches_past_grid_y(cuda, masked):
    """B = 65,537 clouds of N = M = 16 points, one more than grid.y holds:
    K1 (f32, 1e-4 scaled; bf16 on the tensor cores, 2e-2 relative), K3 and
    K2 (1e-3, settled indices equal), K4
    (1e-5 scaled) and K5 (bit for bit) against their plain versions, so
    the whole Chamfer backward is covered (card_checks.big_batch_checks)."""
    before = _cuda.launch_counts.copy()
    card_checks.big_batch_checks(cuda, masked)
    torch.cuda.synchronize()
    for name in ("encoder_pool_f32", "encoder_pool_bf16", "nn_dist",
                 "nn_min", "nn_gather", "nn_scatter"):
        assert _cuda.launch_counts[name] > before[name], name


def _bf16_engine_file(engine, path):
    """Write ``engine`` as the JAX package writes a bf16 engine: bf16
    arrays pickled with the dtype ml_dtypes.bfloat16. The card's machine
    has no ml_dtypes, so the uint16 words are pickled and the dtype's
    name is swapped for that global (protocol 3: no frames to resize, and
    GLOBAL pushes one object where the name string pushed one)."""
    import pickle

    def leaf(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()

    raw = pickle.dumps(tree_map(leaf, engine), protocol=3)
    assert raw.count(b"X\x02\x00\x00\x00u2") == 1
    path.write_bytes(raw.replace(b"X\x02\x00\x00\x00u2",
                                 b"cml_dtypes\nbfloat16\n"))


@pytest.mark.cuda
def test_bf16_engine_file_loads_on_card(cuda, tmp_path):
    """A bf16 engine file with ml_dtypes.bfloat16 arrays loads on the card
    through the stand-in with every bf16 leaf's bits, and serves as the
    engine it was written from (K1 bf16)."""
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.utils.tree import tree_leaves

    model = model_from_numpy(card_checks.init_numpy_model(
        flagship_config(), seed=2), device=cuda)
    engine = inference.prepare_inference_engine(model, dtype=torch.bfloat16)
    _bf16_engine_file(engine, tmp_path / "bf16.pkl")
    loaded = inference.load_engine(str(tmp_path / "bf16.pkl"), device=cuda,
                                   dtype=torch.bfloat16)
    for a, b in zip(tree_leaves(engine), tree_leaves(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    pc, mask = _clouds(4, 2048, 27, cuda)
    before = _cuda.launch_counts["encoder_pool_bf16"]
    out = inference.complete_fast(loaded, pc, mask, gate_mode="rl")
    ref = inference.complete_fast(engine, pc, mask, gate_mode="rl")
    assert _cuda.launch_counts["encoder_pool_bf16"] == before + 2
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def _rl_model(device, seed=3):
    """The flagship model with fresh weights on ``device`` and a copy on
    the CPU."""
    from gan_rl_3d_tpu_torch.models import rl_gan_net as net

    cfg = flagship_config()
    model = net.init_model(torch.Generator().manual_seed(seed), cfg, device)
    td3 = cfg.td3_config()
    copy = {**{k: card_checks.on_device(model[k], torch.device("cpu"))
               for k in ("ae", "lgan")},
            "agent": card_checks.agent_copy(model["agent"],
                                            torch.device("cpu"), td3)}
    return cfg, td3, model, copy


@pytest.mark.cuda
def test_reward_chamfer_launches_k3(cuda):
    """The RL reward's Chamfer distance runs K3 (twice: both directions)
    and agrees with the CPU's plain version."""
    from gan_rl_3d_tpu_torch.models import rl_gan_net as net

    cfg, _, model, copy = _rl_model(cuda)
    pc, _ = _clouds(8, 2048, 30)
    gfv = torch.tanh(torch.randn(8, 128,
                                 generator=torch.Generator().manual_seed(1)))
    pred = pc + 0.05
    before = _cuda.launch_counts["nn_dist"]
    r = net.compute_reward(model, pred.to(cuda), pc.to(cuda), gfv.to(cuda),
                           (0.9 * gfv).to(cuda))
    assert _cuda.launch_counts["nn_dist"] == before + 2
    ref = net.compute_reward(copy, pred, pc, gfv, 0.9 * gfv)
    assert card_checks.rel_err(r.cpu(), ref) <= card_checks.TOL_RL_LOSS
    assert not r.requires_grad


@pytest.mark.cuda
def test_lgan_combined_step_on_card_matches_cpu(cuda):
    """One combined step on the card and on the CPU from the same weights
    and Adam moments one step old (card_checks.lgan_warm): losses, each
    network's update, its state; lr 0 on the card fails the update
    check."""
    cfg, _, _, copy = _rl_model(cuda, seed=4)
    lc, m = cfg.training.lgan, cfg.model.lgan
    real = [torch.tanh(torch.randn(
        lc.d_steps, lc.batch_size, m.latent_dim,
        generator=torch.Generator().manual_seed(seed))) for seed in (5, 6)]
    warm = card_checks.lgan_warm(copy["lgan"], cfg, real[0], seed=7)
    draws = card_checks.lgan_draws(cfg, seed=8)
    (sm, card), (ref_m, ref) = (
        card_checks.lgan_step_on(dev, warm, cfg, real[1], draws)
        for dev in (cuda, torch.device("cpu")))
    for k in ("d_loss", "g_loss"):
        assert card_checks.rel_diff(sm[k], ref_m[k]) <= card_checks.TOL_RL_LOSS, (
            k, float(sm[k]), float(ref_m[k]))
    _, frozen = card_checks.lgan_step_on(cuda, warm, cfg, real[1], draws,
                                        lr_scale=0.0)
    for k in card:
        start = {part: warm[0][part][k] for part in ("params", "state")}
        update, state, worst, noise = card_checks.network_errs(
            card[k], ref[k], start)
        assert update <= card_checks.TOL_RL_UPDATE, (k, update)
        assert state <= card_checks.TOL_RL_PARAM, (k, state, worst)
        assert noise <= 2 * lc.generator_lr * lc.d_steps, (k, noise)
        assert card_checks.network_errs(frozen[k], ref[k], start)[0] > \
            card_checks.TOL_RL_UPDATE, k


@pytest.mark.cuda
def test_rl_step_on_card_matches_cpu(cuda):
    """One rl_step of 8 environments and 4 TD3 updates on the card and on
    CPU copies with the same draws: rewards, buffer rows, OU state, agent;
    K3 launches in the reward."""
    from gan_rl_3d_tpu_torch.models import rl_agent as rl
    from gan_rl_3d_tpu_torch.train import replay_buffer as rb
    from gan_rl_3d_tpu_torch.train import steps

    cfg, td3, model, copy = _rl_model(cuda, seed=7)
    envs, updates, prefill = 8, 4, td3.batch_size
    pc, _ = _clouds(envs, 2048, 31)
    pre = card_checks.random_transitions(prefill, td3, 8, "cpu")
    draws = steps.draw_rl_step(torch.Generator().manual_seed(9), envs, 2048,
                               cfg=td3, buffer_size=prefill + envs,
                               updates_per_step=updates)
    out = []
    start = card_checks.agent_copy(copy["agent"], torch.device("cpu"), td3)
    for dev, src in ((cuda, model), (torch.device("cpu"), copy)):
        buf = rb.ReplayBuffer(1000, td3.state_dim, td3.action_dim, dev)
        buf.add_batch(rl.TransitionBatch(*(v.to(dev) for v in pre)))
        before = _cuda.launch_counts["nn_dist"]
        src, buf, ou, sm = steps.rl_step(
            src, buf, rl.ou_init(td3, (envs,), dev),
            {"complete_pc": pc.to(dev), "pad": torch.zeros(envs,
                                                           device=dev)},
            card_checks.on_device(draws, dev), cfg=td3, start_training_size=prefill,
            updates_per_step=updates)
        launched = _cuda.launch_counts["nn_dist"] - before
        out.append((src, buf, ou, sm, launched))
    (card, buf, ou, sm, launched), (ref, rbuf, rou, rsm, rlaunched) = out
    assert launched == 2 and rlaunched == 0
    for k in ("reward", "critic_loss", "actor_loss"):
        assert card_checks.rel_diff(sm[k], rsm[k]) <= card_checks.TOL_RL_LOSS, k
    for name in rb.FIELDS:
        assert card_checks.scaled_err(getattr(buf, name).cpu(),
                                     getattr(rbuf, name)) <= \
            card_checks.TOL_RL_PARAM
    assert card_checks.scaled_err(ou.cpu(), rou) <= card_checks.TOL_RL_PARAM
    card_checks.check_agents("rl_step", card["agent"], ref["agent"], start,
                             updates, td3.critic_lr)


def _joint_trainer(device, seed=11):
    """What the joint step checks read of a trainer: the flagship
    config and a fresh model on ``device``."""
    import types

    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train.trainer import fixed_holes_seed

    cfg, td3, model, _ = _rl_model(device, seed=seed)
    return types.SimpleNamespace(
        config=cfg, model=model, td3=td3, preproc=cfg.preproc_spec(),
        bidirectional=cfg.loss.bidirectional, bn_stats=cfg.training.bn_stats,
        _fixed_holes=lambda stream, i, bsz, n: pc_ops.draw_training_batch(
            torch.Generator(device).manual_seed(fixed_holes_seed(stream, i)),
            bsz, n, spec=cfg.preproc_spec(), augment=False))


@pytest.mark.cuda
def test_joint_step_on_card_matches_cpu(cuda):
    """One f32 joint step (the recipe's w_ae_recon 1) at B=8, full width,
    on the card and on CPU copies from the same weights, draws and Adam
    moments one step old (card_checks.joint_warm): the loss and its parts,
    each network's update (card_checks.TOL_JOINT_UPDATE, which says why it
    is looser than the phase 3-4 steps') and state; lr 0 on the card fails
    the update check."""
    trainer = _joint_trainer(cuda)
    lr = trainer.config.training.joint.lr
    warm = card_checks.joint_warm(trainer, seed=12)
    start = card_checks.joint_networks(warm[0])
    batch, draws = card_checks.joint_batch(trainer, seed=13)
    (sm, card), (ref_m, ref) = (
        card_checks.joint_step_on(dev, warm, trainer, batch, draws)
        for dev in (cuda, torch.device("cpu")))
    for k in ("loss", "chamfer", "gfv"):
        assert card_checks.rel_diff(sm[k], ref_m[k]) <= card_checks.TOL_RL_LOSS, k
    _, frozen = card_checks.joint_step_on(cuda, warm, trainer, batch, draws,
                                         lr_scale=0.0)
    for k in card:
        update, state, worst, noise = card_checks.network_errs(
            card[k], ref[k], start[k])
        assert update <= card_checks.TOL_JOINT_UPDATE, (k, update)
        assert state <= card_checks.TOL_RL_PARAM, (k, state, worst)
        assert noise <= 2 * lr, (k, noise)
        assert card_checks.network_errs(frozen[k], ref[k], start[k])[0] > \
            card_checks.TOL_JOINT_UPDATE, k


@pytest.mark.cuda
@pytest.mark.parametrize("w_ae_recon,launches", [(1.0, (4, 4, 2)),
                                                 (0.0, (2, 2, 1))])
def test_joint_step_launches_k3_k4_k5(cuda, w_ae_recon, launches):
    """A joint step on the card runs each bidirectional Chamfer through the
    kernels: K3 twice forward, K4 twice and K5 once backward (b, the
    decoded cloud, needs a gradient in one direction); with the AE-path
    term there are two such losses. On CPU tensors none launches."""
    from gan_rl_3d_tpu_torch.train import steps

    trainer = _joint_trainer(cuda)
    kw = dict(card_checks.joint_kw(trainer), w_ae_recon=w_ae_recon)
    names = ("nn_dist", "nn_gather", "nn_scatter")
    for dev, expect in ((cuda, launches), (torch.device("cpu"), (0, 0, 0))):
        model = card_checks.joint_model(trainer.model, dev)
        opt = steps.make_joint_optimizer(steps.joint_trainable(model),
                                         trainer.config.training.joint)
        batch, draws = card_checks.joint_batch(trainer, seed=14, bsz=4)
        before = [_cuda.launch_counts[n] for n in names]
        _, m = steps.joint_train_step(model, opt, card_checks.on_device(batch, dev),
                                      card_checks.on_device(draws, dev), **kw)
        assert tuple(_cuda.launch_counts[n] - b
                     for n, b in zip(names, before)) == expect
        assert bool(torch.isfinite(m["loss"]))


@pytest.mark.cuda
def test_gate_stats_step_on_card_matches_cpu(cuda):
    """gate_stats_step on a full-width batch of 16 on the card and on CPU
    copies, the same holes: both paths' Chamfer distances (K3 four times
    on the card) and the D margins."""
    from gan_rl_3d_tpu_torch.train import gate as gate_lib

    trainer = _joint_trainer(cuda, seed=15)
    cpu = torch.device("cpu")
    batch = {"complete_pc": _clouds(16, 2048, 16)[0],
             "pad": torch.zeros(16)}
    draws = card_checks.on_device(trainer._fixed_holes(2, 0, 16, 2048), cpu)
    model_cpu = {k: card_checks.on_device(trainer.model[k], cpu)
                 for k in ("ae", "lgan")}
    model_cpu["agent"] = {"actor": card_checks.on_device(
        trainer.model["agent"]["actor"], cpu)}
    kw = dict(cfg=trainer.td3, spec=trainer.preproc)
    before = _cuda.launch_counts["nn_dist"]
    out = gate_lib.gate_stats_step(trainer.model, card_checks.on_device(batch, cuda),
                                   card_checks.on_device(draws, cuda), **kw)
    assert _cuda.launch_counts["nn_dist"] == before + 4
    ref = gate_lib.gate_stats_step(model_cpu, batch, draws, **kw)
    for k in ("cd_rl", "cd_ae"):
        assert card_checks.scaled_err(out[k].cpu(), ref[k]) <= \
            card_checks.TOL_F32, k
    assert float((out["margin"].cpu() - ref["margin"]).abs().max()) <= \
        card_checks.TOL_GATE_MARGIN * float(ref["margin"].abs().max())


# ---------------------------------------------------------------------------
# the mesh on the card (gan_rl_3d_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

MESH_B, MESH_N = 8, 256
MESH_AE = dict(latent_dim=32, num_points=MESH_N,
               encoder_dims=(16, 32, 32, 64, 32), decoder_dims=(64, 64, 768))


def _mesh_ae_step(device, mesh, seed=0):
    """One f32 ae_train_step at small widths on ``device`` under ``mesh``
    (this rank's rows of a global batch of MESH_B, the global draws):
    (loss, {"params", "state"} on the CPU, the start)."""
    from gan_rl_3d_tpu_torch.config import AETrainConfig
    from gan_rl_3d_tpu_torch.models import autoencoder as ae
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
    from gan_rl_3d_tpu_torch.train import steps

    p, s = ae.autoencoder_init(torch.Generator().manual_seed(seed), 3,
                               **MESH_AE)
    start = {"params": tree_map(lambda v: v.clone(), p),
             "state": tree_map(lambda v: v.clone(), s)}
    params = tree_map(lambda v: v.to(device).requires_grad_(True), p)
    state = tree_map(lambda v: v.to(device), s)
    opt, _ = steps.make_ae_optimizer(params, AETrainConfig(), 10)
    pc, _ = _clouds(MESH_B, MESH_N, seed + 1)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(seed),
                                       MESH_B, MESH_N)
    batch = mesh_lib.shard_batch(mesh, {"complete_pc": pc.to(device),
                                        "pad": torch.zeros(MESH_B,
                                                           device=device)})
    state, m = steps.ae_train_step(
        params, state, opt, batch, tree_map(lambda v: v.to(device), draws),
        mesh=mesh)
    out = {"params": tree_map(lambda v: v.detach().cpu(), params),
           "state": tree_map(lambda v: v.cpu(), state)}
    return float(m["loss"]), out, start


def _gloo_rank(rank, world, store, out):
    import torch.distributed as dist

    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_mesh(device="cuda:0")
        loss, net, _ = _mesh_ae_step(torch.device("cuda", 0), mesh)
        if rank == 0:
            torch.save({"loss": loss, "net": net}, out)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_world_one_nccl_step_is_the_one_process_step(cuda, tmp_path):
    """A 1x1 mesh over an NCCL group of one rank issues no collective: the
    AE step's loss and every leaf equal the step without a mesh, bit for
    bit."""
    import torch.distributed as dist

    from gan_rl_3d_tpu_torch.parallel import collectives
    from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mesh(device=cuda)
        before = sum(collectives.calls.values())
        a = _mesh_ae_step(cuda, mesh)
        assert sum(collectives.calls.values()) == before
    finally:
        dist.destroy_process_group()
    b = _mesh_ae_step(cuda, None)
    assert a[0] == b[0]
    for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card (CUDA tensors staged through the
    host) take one DP AE step: the loss within 1e-4 relative and the
    update within 1e-2 of the one process's in the 2-norm (Adam-noise
    leaves within 2 lr), as the multi path's card test holds them."""
    import torch.multiprocessing as mp

    out = tmp_path / "rank0.pt"
    mp.spawn(_gloo_rank, args=(2, str(tmp_path / "store"), str(out)),
             nprocs=2, join=True)
    got = torch.load(out, weights_only=False)
    loss, net, start = _mesh_ae_step(cuda, None)
    assert abs(got["loss"] - loss) <= 1e-4 * abs(loss)
    update, _, _, noise = card_checks.network_errs(got["net"], net, start)
    assert update <= 1e-2 and noise <= 2e-3, (update, noise)
