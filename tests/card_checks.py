"""The bounds, inputs and card-vs-plain checks the port's tests share.

The CPU tests (against the JAX package) and the card tests (``cuda``
marker: tests/test_torch_port_cuda.py, test_torch_port_card_paths.py and
the marked tests of test_torch_port_bn_train.py and test_torch_port_pcn.py)
take their bounds and inputs from here, so that a bound is set in one
place with the reason it is what it is. Imports no JAX: on the card's
machine the card tests run as

  python -m pytest --noconftest tests/test_torch_port_cuda.py \\
      tests/test_torch_port_card_paths.py tests/test_torch_port_bn_train.py \\
      tests/test_torch_port_pcn.py -m cuda
"""

from __future__ import annotations

import copy
import re

import numpy as np
import torch

from gan_rl_3d_tpu_torch.convert import agent_from_numpy, agent_to_numpy
from gan_rl_3d_tpu_torch.data.synthetic import (CATEGORIES,
                                                generate_synthetic_cloud)
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.ops import _cuda, chamfer, encoder_kernel as ek
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.train import steps
from gan_rl_3d_tpu_torch.utils.tree import tree_map

TOL_F32 = 1e-4      # f32 kernel / engine vs plain, scaled by max(1, |ref|)
TOL_BF16 = 2e-2     # bf16 vs its reference, relative to max |ref|
# K6 vs its plain version: equal bit for bit (torch.equal), since the int32
# sums are exact in any order and every rounding step is the plain version's
# the int8 engine against f32: the GFV within 2e-2 of its largest element
# (the JAX package's pooled-feature bound, test_fused_encoder.py:98-100),
# clouds within 0.1 of the unfolded complete (test_fused_encoder.py:119-121)
TOL_INT8_GFV = 2e-2
TOL_INT8_PC = 0.1
# on the trained lgan_best the JAX package's own int8 engine reads 2.2749e-2
# of f32 (tests/test_torch_port_orbax.py::test_trained_int8_engine_matches_
# jax holds the port's to it): the limit sits just above that reading
TOL_INT8_GFV_TRAINED = 2.4e-2
# the int8 engine on the card against the same engine on the CPU, of the
# largest element: the int32 sums are exact, and only a last-bit difference
# of a row's f32 scale can move an int8 level (1.165e-6 read on lgan_best)
TOL_INT8_CARD = 1e-4
TOL_DIST = 1e-3     # |a|^2+|b|^2-2ab cancellation in f32
TIE_GAP = 1e-4      # squared-distance gap below which an index may differ
# K4 vs plain, scaled by max(1, |ref|): K4 rounds as its plain version does
# (K5 and its plain version sum in the same order and must be equal)
TOL_GRAD_KERNEL = 1e-5
# Chamfer gradient, card vs CPU copies, relative to the largest element:
# K3's distances differ from the plain version's in the last bits (another
# order of |a|^2 + |b|^2 - 2ab), and g / dist carries that into da
TOL_CHAMFER_GRAD = 1e-4
# one f32 AE step, card vs CPU: cuBLAS and the CPU's BLAS sum in other
# orders, and at a random init a nearest-neighbour near-tie can flip under
# last-bit differences of the reconstruction, which moves that point's
# gradient (such a flip measured 4.3e-4 of the largest gradient element
# between the JAX package and the port on the CPU); relative to the
# largest gradient element, and to the loss
TOL_STEP_GRAD = 2e-3
TOL_STEP_LOSS = 1e-4
# phases 2-4, card against CPU with the same draws and the same start
# (cuBLAS and the CPU's BLAS sum in other orders, as for the AE step):
# losses and rewards relative to the CPU's; each network's update (new
# parameters - start) in the 2-norm relative to the CPU's update, so that
# a step that skipped the optimizer or took the wrong lr reads about 1;
# state leaves (BN variances, spectral-norm vectors), buffer rows and the
# OU state relative to their own largest element. Adam divides each
# gradient element by its own RMS, and the biases ahead of a training
# BatchNorm have a true gradient of 0 (the BN subtracts them again), so
# their last-bit gradients become steps of up to lr either way: those
# biases and the BN running means that take them in (adam_noise) are
# held to 2 lr an update, absolute (tests/test_torch_port_rl.py and
# tests/test_torch_port_lgan.py measure this against JAX).
TOL_RL_LOSS = 1e-4
TOL_GATE_MARGIN = 1e-5  # D(clean) - D(noisy), of the largest margin
# one joint step (B=8), each network's update card vs CPU in the 2-norm:
# not TOL_RL_UPDATE. The step is conditioned worse than the phase 3-4
# steps: the decoder's training BatchNorm divides by the spread of G's
# outputs over 8 rows, the max-pool and the Chamfer loss pick one point
# each, and Adam divides each element by its own RMS, so the CPU's own
# update moves by about 1e-2 when the input clouds are scaled by 1 + 1e-7
# (read on an H100 80GB HBM3 at 700 W: 6.8e-3, 1.36e-2, 1.29e-2 for the
# encoder, decoder and generator, against the card's 8.8e-3, 1.79e-2,
# 1.57e-2). A step with lr 0 or twice the lr reads 1.
TOL_JOINT_UPDATE = 5e-2
TOL_RL_UPDATE = 1e-2
TOL_RL_PARAM = 2e-3

B_MAIN, N_MAIN = 64, 2048   # the main paths' batch and points a cloud
B_STEP_CHECK = 8            # the card-vs-CPU steps' batch
BIG_BATCH = 65537   # one more cloud than a grid's y dimension holds
# K3/K2: (N, M) off every tile boundary, checked at B=3 against the plain
# version; pairs (j, j') with b[j'] = b[j] within one 8-point sub-tile, and
# straddling the sub-tile and the 256-point tile boundaries (M = 2048)
NN_RAGGED = ((1, 1), (7, 3000), (1001, 777), (2048, 2048))
NN_TIES = ((5, 11), (250, 260), (252, 253), (255, 256), (678, 690),
           (1020, 1030), (1000, 1500), (0, 2047))
SCATTER_CASES = {  # name: (B, N, M, targets)
    "all on target 0": (4, 2048, 2048, "zero"),
    "all distinct": (4, 2048, 2048, "perm"),
    "M > N": (4, 500, 3000, "rand"),
    "N > M": (4, 3000, 100, "rand"),
    "global scratch": (3, 5000, 4000, "rand"),
    "B=2, N=M=20000": (2, 20000, 20000, "rand"),
}
# the variant family's model block (runs/variant/config_variant.yaml)
VARIANT_TYPES = {"encoder_type": "attention", "decoder_type": "adaptive"}


# ---------------------------------------------------------------------------
# errors, weights and inputs
# ---------------------------------------------------------------------------


def scaled_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max(1, max |ref|): absolute for O(1) outputs."""
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / max(1.0, float(ref.abs().max())))


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / ref.abs().max())


def rel_diff(a, b) -> float:
    """|a - b| / max(1, |b|) of two scalars: relative, absolute for O(1)
    values (a loss near 0 is a difference of terms of order 1)."""
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1.0)


def _bn_mlp(rng, d_in, dims, final_plain=False, xavier=False):
    params, state = [], []
    for i, d_out in enumerate(dims):
        bound = (np.sqrt(6.0 / (d_in + d_out)) if xavier
                 else 1.0 / np.sqrt(d_in))
        p = {"dense": {"w": rng.uniform(-bound, bound, (d_in, d_out)),
                       "b": rng.uniform(-1 / np.sqrt(d_in), 1 / np.sqrt(d_in),
                                        d_out)}}
        s = {}
        if not (final_plain and i == len(dims) - 1):
            p["bn"] = {"scale": rng.uniform(0.8, 1.2, d_out),
                       "bias": rng.uniform(-0.1, 0.1, d_out)}
            s["bn"] = {"mean": rng.uniform(-0.1, 0.1, d_out),
                       "var": rng.uniform(0.5, 2.0, d_out)}
        params.append(p)
        state.append(s)
        d_in = d_out
    return params, state


def init_numpy_model(config, seed: int = 0) -> dict:
    """A model tree in the JAX package's layout (numpy leaves) with random
    weights from ``seed``: torch-default weight ranges, BN running
    statistics jittered around the init values (mean 0, var 1) so folding
    is exercised, and spectral-norm u, v set to the top singular vectors,
    as the power iteration leaves them."""
    rng = np.random.RandomState(seed)
    m = config.model
    a, g, r = m.autoencoder, m.lgan, m.rl_agent
    enc_p, enc_s = _bn_mlp(rng, a.input_dim, a.encoder_dims)
    head_p, head_s = _bn_mlp(rng, a.encoder_dims[-1], [a.latent_dim])
    dec_p, dec_s = _bn_mlp(rng, a.latent_dim, a.decoder_dims, final_plain=True)
    gen_p, gen_s = _bn_mlp(rng, g.z_dim, g.generator_dims, final_plain=True)
    act_p, act_s = _bn_mlp(rng, r.state_dim,
                           list(r.hidden_dims) + [r.action_dim],
                           final_plain=True, xavier=True)
    d_layers_p, d_layers_s = [], []
    d_in = g.latent_dim
    for i, d_out in enumerate(g.discriminator_dims):
        bound = 1.0 / np.sqrt(d_in)
        w = rng.uniform(-bound, bound, (d_in, d_out))
        p = {"dense": {"w": w, "b": rng.uniform(-bound, bound, d_out)}}
        if i < len(g.discriminator_dims) - 1:
            p["ln"] = {"scale": rng.uniform(0.8, 1.2, d_out),
                       "bias": rng.uniform(-0.1, 0.1, d_out)}
        left, _, right = np.linalg.svd(w, full_matrices=False)
        d_layers_p.append(p)
        d_layers_s.append({"sn": {"u": right[0], "v": left[:, 0]}})
        d_in = d_out
    tree = {
        "ae": {"params": {"encoder": {"point_mlp": enc_p, "head": head_p},
                          "decoder": {"mlp": dec_p}},
               "state": {"encoder": {"point_mlp": enc_s, "head": head_s},
                         "decoder": {"mlp": dec_s}}},
        "lgan": {"params": {"generator": {"mlp": gen_p},
                            "discriminator": {"layers": d_layers_p}},
                 "state": {"generator": {"mlp": gen_s},
                           "discriminator": {"layers": d_layers_s}}},
        "agent": {"actor": {"params": {"mlp": act_p},
                            "state": {"mlp": act_s}}},
    }
    return tree_map(lambda v: np.asarray(v, np.float32), tree)


def make_clouds(bsz: int, n: int, seed: int, device) -> tuple:
    """Complete clouds on noisy ellipsoid surfaces, and masks that cut a
    random share of each cloud (the padded tail the serving CLI produces)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(bsz, n, 3, generator=g, device=device)
    x = x / x.norm(dim=-1, keepdim=True)
    axes = 0.4 + 0.6 * torch.rand(bsz, 1, 3, generator=g, device=device)
    pc = x * axes + 0.01 * torch.randn(bsz, n, 3, generator=g, device=device)
    keep = torch.randint(n // 2, n + 1, (bsz, 1), generator=g, device=device)
    mask = (torch.arange(n, device=device)[None, :] < keep).float()
    return pc.contiguous(), mask


def synthetic_clouds(bsz: int, n: int, seed: int, device) -> tuple:
    """``bsz`` clouds of the port's synthetic categories
    (``data/synthetic.py``, in turn), on the unit sphere as the dataset
    serves them, with masks that cut a random share of each (the padded
    tail the serving CLI produces)."""
    rng = np.random.RandomState(seed)
    pc = np.stack([generate_synthetic_cloud(CATEGORIES[i % len(CATEGORIES)],
                                            n, rng) for i in range(bsz)])
    keep = rng.randint(n // 2, n + 1, (bsz, 1))
    mask = (np.arange(n)[None, :] < keep).astype(np.float32)
    return (pc_ops.normalize_unit_sphere(torch.from_numpy(pc)).to(device)
            .contiguous(), torch.from_numpy(mask).to(device))


# ---------------------------------------------------------------------------
# the kernels' builds
# ---------------------------------------------------------------------------


def ptxas_report(log: str) -> dict:
    """nvcc -Xptxas -v output -> {kernel: "N registers, F B stack frame, S
    B spill stores, L B spill loads"}, with the template arguments of K1
    (encoder_pool_kernel<tile, bf16, masked>), K1 bf16's tensor-core
    instance, K6's instances and K5 spelled out."""
    names = (
        (r"encoder_pool_kernelILi(\d+)ELb(\d)ELb(\d)E",
         "encoder_pool_kernel<{}, bf16={}, masked={}>"),
        (r"encoder_pool_bf16_kernelILb(\d)ELb(\d)E",
         "encoder_pool_bf16_kernel<masked={}, flagship={}>"),
        (r"encoder_pool_int8_kernelILb(\d)ELb(\d)E",
         "encoder_pool_int8_kernel<masked={}, flagship={}>"),
        (r"encoder_pool_int8_wide_kernelILb(\d)E",
         "encoder_pool_int8_wide_kernel<masked={}>"),
        (r"scatter_kernelILb(\d)E", "scatter_kernel<shared={}>"),
        (r"nn_kernelILb(\d)ELb(\d)E", "nn_kernel<keep_idx={}, masked={}>"),
        (r"\d+(pool_init|pool_decode|[a-z_]+_kernel)", "{}"))
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            for pattern, form in names:
                k = re.search(pattern, fn)
                if k:
                    fn = form.format(*k.groups())
                    break
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = (f"{m.group(1)} B stack frame, {m.group(2)} B spill "
                       f"stores, {m.group(3)} B spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, " + out.get(fn, "")
            fn = None
    return out


def nn_geometry():
    """K3/K2's query points a thread (R) and distances a compare (C), as
    csrc/nn_dist.cu fixes them."""
    src = (_cuda.CSRC / "nn_dist.cu").read_text()
    return {k: int(re.search(rf"constexpr int k{k} = (\d+);", src).group(1))
            for k in ("R", "C")}


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def _k1_case(x, layers, m, dtype, what):
    """K1 against its plain version on one input: one instance launched,
    the same -inf, within TOL_F32 scaled (f32) or TOL_BF16 relative (bf16)
    elsewhere."""
    before = _cuda.launch_counts.copy()
    out = ek.fused_encoder_pool(x, layers, m, compute_dtype=dtype)
    ran = [k for k, v in _cuda.launch_counts.items() if v > before[k]]
    ref = ek.fused_encoder_pool_plain(x, layers, m, compute_dtype=dtype)
    fin = torch.isfinite(ref)
    assert (out.shape == ref.shape and len(ran) == 1
            and torch.equal(torch.isneginf(out), torch.isneginf(ref))
            and bool(fin.any())), f"K1 {what} {dtype}: bad output ({ran})"
    e = (scaled_err(out[fin], ref[fin]) if dtype == torch.float32
         else rel_err(out[fin], ref[fin]))
    assert e <= (TOL_F32 if dtype == torch.float32 else TOL_BF16), (
        f"K1 {what} {dtype}: err {e:.3e}")


def big_batch_checks(device, masked):
    """B = BIG_BATCH clouds of N = M = 16 points, one more than grid.y
    holds: K1 f32 (TOL_F32 scaled) and bf16 on the tensor cores (TOL_BF16
    relative), K3 and K2 (TOL_DIST, settled indices equal), K4
    (TOL_GRAD_KERNEL scaled) and K5 (bit for bit) against their plain
    versions, the whole Chamfer backward."""
    bsz, n = BIG_BATCH, 16
    a, a_mask = make_clouds(bsz, n, seed=21, device=device)
    b, b_mask = make_clouds(bsz, n, seed=22, device=device)
    am, bm = (a_mask, b_mask) if masked else (None, None)
    g = torch.Generator(device="cpu").manual_seed(23)
    layers = [((torch.rand(k, c, generator=g) * 2 - 1) / k ** 0.5)
              .to(device) for k, c in ((3, 16), (16, 32))]
    layers = [(w, torch.zeros(w.shape[1], device=device)) for w in layers]
    e = scaled_err(ek.fused_encoder_pool(a, layers, am),
                   ek.fused_encoder_pool_plain(a, layers, am))
    assert e <= TOL_F32, f"encoder_pool_f32 at B={bsz}: err {e:.3e}"
    _k1_case(a, [(w.bfloat16(), z.bfloat16()) for w, z in layers], am,
             torch.bfloat16, f"B={bsz}")
    d, i = chamfer.nearest_distances(a, b, b_mask=bm)
    rd, ri = chamfer.nearest_distances_plain(a, b, bm)
    top2 = chamfer._sqdist(a, b, bm).topk(2, dim=-1, largest=False).values
    settled = (top2[..., 1] - top2[..., 0]) > TIE_GAP
    assert (float((d - rd).abs().max()) <= TOL_DIST
            and int(((i != ri) & settled).sum()) == 0), (
        f"nn_dist at B={bsz} disagrees")
    e = float((chamfer.nearest_min_distances(a, b)
               - chamfer.nearest_min_distances_plain(a, b)).abs().max())
    assert e <= TOL_DIST, f"nn_min at B={bsz}: err {e:.3e}"
    cot = 0.5 + torch.rand(bsz, n, generator=g).to(device)
    da = chamfer.nearest_grad_a(a, b, i, d, cot)
    e = scaled_err(da, chamfer.nearest_grad_a_plain(a, b, i, d, cot))
    assert e <= TOL_GRAD_KERNEL, f"nn_gather at B={bsz}: err {e:.3e}"
    assert torch.equal(chamfer.nearest_grad_b(i, da, n),
                       chamfer.nearest_grad_b_plain(i, da, n)), (
        f"nn_scatter at B={bsz} differs from its plain version")


def nn_vs_plain(a, b, bm):
    """K3 and K2 against their plain versions: (K3's largest distance
    error, over its distances and those of the neighbours it chose; K2's;
    the settled query points, those whose two nearest squared distances
    are more than TIE_GAP apart, whose index differs)."""
    d, i = chamfer.nearest_distances(a, b, b_mask=bm)
    rd, ri = chamfer.nearest_distances_plain(a, b, bm)
    d2 = chamfer._sqdist(a, b, bm)
    top2 = d2.topk(min(2, b.shape[1]), dim=-1, largest=False).values
    settled = (top2[..., -1] - top2[..., 0]) > TIE_GAP
    mismatched = int(((i != ri) & settled).sum())
    # where the index may differ, the chosen neighbours' distances agree
    chosen = torch.sqrt(torch.clamp(
        d2.gather(-1, i.long()[..., None])[..., 0], min=1e-12))
    e3 = max(float((d - rd).abs().max()), float((chosen - rd).abs().max()))
    e2 = float((chamfer.nearest_min_distances(a, b)
                - chamfer.nearest_min_distances_plain(a, b)).abs().max())
    return e3, e2, mismatched


def nn_k2_equals_k3(device):
    """K2's distances equal K3's unmasked ones bit for bit (the same min),
    at B=64, N=M=2048 and at every NN_RAGGED shape."""
    shapes = [(B_MAIN, N_MAIN, N_MAIN)] + [(3, n, m) for n, m in NN_RAGGED]
    for k, (bsz, n, m) in enumerate(shapes):
        a, _ = make_clouds(bsz, n, seed=40 + k, device=device)
        b, _ = make_clouds(bsz, m, seed=50 + k, device=device)
        assert torch.equal(chamfer.nearest_min_distances(a, b),
                           chamfer.nearest_distances(a, b)[0]), (
            f"nn_min differs from nn_dist's distances at B={bsz}, N={n}, "
            f"M={m}")


def nn_ones_mask(device):
    """K3 with a b_mask of all ones equals K3 unmasked bit for bit, in dist
    and idx, at B=64, N=M=2048."""
    a, _ = make_clouds(B_MAIN, N_MAIN, seed=41, device=device)
    b, _ = make_clouds(B_MAIN, N_MAIN, seed=51, device=device)
    ones = torch.ones(B_MAIN, N_MAIN, device=device)
    d, i = chamfer.nearest_distances(a, b)
    dm, im = chamfer.nearest_distances(a, b, b_mask=ones)
    assert torch.equal(d, dm) and torch.equal(i, im), (
        "nn_dist with a mask of ones differs from unmasked")


def nn_tie_inputs(device, masked):
    """B=64 clouds of 2048 points where b[j'] = b[j] for each (j, j') of
    NN_TIES and query point 3 + 37 t of a sits on pair t's point; masked:
    a tenth of b masked, never a copy."""
    a, _ = make_clouds(B_MAIN, N_MAIN, seed=42, device=device)
    b, _ = make_clouds(B_MAIN, N_MAIN, seed=52, device=device)
    queries = [3 + 37 * t for t in range(len(NN_TIES))]
    for q, (j, dup) in zip(queries, NN_TIES):
        b[:, dup] = b[:, j]
        a[:, q] = b[:, j]
    bm = None
    if masked:
        g = torch.Generator(device=device).manual_seed(53)
        bm = (torch.rand(B_MAIN, N_MAIN, generator=g, device=device)
              > 0.1).float()
        bm[:, [p for pair in NN_TIES for p in pair]] = 1.0
    return a, b, bm, queries


def nn_duplicate_ties(device):
    """Exact duplicates in b within a sub-tile and straddling the sub-tile
    and tile boundaries (NN_TIES): K3 returns the first copy for the query
    point on it, as the plain version does, with the same distance; masked
    and unmasked."""
    firsts = torch.tensor([j for j, _ in NN_TIES], device=device)
    for masked in (False, True):
        a, b, bm, queries = nn_tie_inputs(device, masked)
        rd, ri = chamfer.nearest_distances_plain(a, b, bm)
        assert bool((ri[:, queries] == firsts).all()), (
            "the plain version does not return the first copy")
        d, i = chamfer.nearest_distances(a, b, b_mask=bm)
        assert bool((i[:, queries] == firsts).all()), (
            f"nn_dist (masked {masked}) does not return the first copy of a "
            "duplicated point")
        assert float((d - rd).abs().max()) <= TOL_DIST, (
            f"nn_dist on duplicates (masked {masked}): distances")


def nn_ragged(device):
    """K3 and K2 at every (N, M) of NN_RAGGED, B=3, masked with one cloud
    fully masked, and unmasked, against the plain version (TOL_DIST, no
    settled index differing); the fully masked cloud's indices are 0, as
    the plain version's. Returns the largest distance errors of K3 and
    K2."""
    worst = [0.0, 0.0]
    for k, (n, m) in enumerate(NN_RAGGED):
        a, _ = make_clouds(3, n, seed=60 + k, device=device)
        b, bm = make_clouds(3, m, seed=70 + k, device=device)
        bm[1] = 0.0
        for mask in (None, bm):
            e3, e2, mismatched = nn_vs_plain(a, b, mask)
            assert max(e3, e2) <= TOL_DIST and mismatched == 0, (
                f"nn_dist/nn_min at N={n}, M={m} (masked "
                f"{mask is not None}): err {e3:.3e} / {e2:.3e}, "
                f"{mismatched} settled indices differ")
            worst = [max(worst[0], e3), max(worst[1], e2)]
        _, i = chamfer.nearest_distances(a, b, b_mask=bm)
        assert bool((i[1] == 0).all()), (
            f"nn_dist at N={n}, M={m}: a fully masked cloud's indices are "
            "not 0")
    return worst


def chamfer_grad_vs_cpu(a, b, b_mask=None):
    """The Chamfer gradient w.r.t. both clouds by the autograd Function on
    ``a``'s device (the kernels) against the same Function on CPU copies
    (the plain versions). A query point whose neighbour differs (a
    near-tie: K3 and the plain version round |a|^2 + |b|^2 - 2ab
    differently) moves the gradient of it and of both candidate
    neighbours, so those are left out. Returns (the largest difference
    relative to the largest gradient element, the number of points left
    out, the largest |gradient| of a masked b point)."""
    grads = []
    for dev in (a.device, torch.device("cpu")):
        x = a.detach().to(dev).requires_grad_(True)
        y = b.detach().to(dev).requires_grad_(True)
        bm = None if b_mask is None else b_mask.to(dev)
        chamfer.chamfer_distance(x, y, b_mask=bm).sum().backward()
        i_ab = chamfer.nearest_distances(x.detach(), y.detach(), b_mask=bm)[1]
        i_ba = chamfer.nearest_distances(y.detach(), x.detach())[1]
        grads.append((x.grad.cpu(), y.grad.cpu(), i_ab.cpu(), i_ba.cpu()))
    (ga, gb, ia, ib), (ra, rb, ria, rib) = grads
    bad_a, bad_b = ia != ria, ib != rib
    for q, p, bad_target in ((ia, ria, bad_b), (ib, rib, bad_a)):
        rows, cols = (q != p).nonzero(as_tuple=True)
        bad_target[rows, q[rows, cols].long()] = True
        bad_target[rows, p[rows, cols].long()] = True
    scale = float(torch.maximum(ra.abs().max(), rb.abs().max()))
    err = max(float((ga - ra).abs()[~bad_a].max()),
              float((gb - rb).abs()[~bad_b].max())) / scale
    masked_grad = 0.0
    if b_mask is not None and bool((b_mask == 0).any()):
        masked_grad = float(gb[(b_mask == 0).cpu()].abs().max())
    return err, int(bad_a.sum() + bad_b.sum()), masked_grad


def scatter_cases(device):
    """(name, idx, da, m): adversarial inputs for K5, from a fixed seed."""
    out = []
    for k, (name, (bsz, n, m, kind)) in enumerate(SCATTER_CASES.items()):
        g = torch.Generator(device=device).manual_seed(30 + k)
        if kind == "zero":
            idx = torch.zeros(bsz, n, dtype=torch.int32, device=device)
        elif kind == "perm":
            idx = torch.stack([torch.randperm(n, generator=g, device=device)
                               for _ in range(bsz)]).to(torch.int32)
        else:
            idx = torch.randint(0, m, (bsz, n), generator=g, device=device,
                                dtype=torch.int32)
        da = torch.randn(bsz, n, 3, generator=g, device=device)
        out.append((name, idx, da, m))
    return out


# ---------------------------------------------------------------------------
# trees, and a network's update on the card against the CPU's
# ---------------------------------------------------------------------------


def named_leaves(tree, path=()):
    """(path, tensor) of every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def on_device(tree, dev, grad=False):
    """A copy of a tree of tensors (or None leaves) on ``dev``; with
    ``grad`` its leaves take a gradient."""
    return tree_map(lambda v: v.detach().to(dev).clone().requires_grad_(grad),
                    tree)


def adam_noise(path, tree) -> bool:
    """Whether the leaf at ``path`` of ``tree`` (a network's params, state
    or Adam moments) is one Adam makes noise of: the bias of a dense layer
    that feeds a training BatchNorm (a ``bn_mlp`` block with a "bn" entry;
    the adaptive decoder's refinement conv1; the critic's state_fc,
    comb_fc1, comb_fc2) and the BN running means that take it in.
    tests/test_torch_port_rl.py and tests/test_torch_port_lgan.py hold the
    same leaves loosely against JAX."""
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


def network_errs(card: dict, cpu: dict, start: dict) -> tuple:
    """A network {"params", "state"} after a step on the card against its
    CPU copy after the same step from ``start``: (the update's error,
    |(card - start) - (cpu - start)| / |cpu - start| in the 2-norm over
    the parameters that are not Adam noise; the worst state leaf's error
    relative to its own largest element, and its path; the Adam-noise
    leaves' largest absolute error). A network that the CPU left where it
    was reads 0 when the card did too."""
    diff = moved = state_err = noise = 0.0
    worst = None
    for part in ("params", "state"):
        for (path, a), (_, b), (_, s0) in zip(named_leaves(card[part]),
                                              named_leaves(cpu[part]),
                                              named_leaves(start[part])):
            a, b, s0 = (v.detach().cpu().double() for v in (a, b, s0))
            if adam_noise(path, card[part]):
                noise = max(noise, float((a - b).abs().max()))
            elif part == "params":
                diff += float((a - b).square().sum())
                moved += float((b - s0).square().sum())
            else:
                e = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                if e >= state_err:
                    state_err, worst = e, path
    update = ((diff / moved) ** 0.5 if moved
              else 0.0 if diff == 0 else float("inf"))
    return update, state_err, worst, noise


def errs_ok(errs, tol_noise, tol_update=TOL_RL_UPDATE) -> bool:
    """Every network_errs within the update, state and noise bounds."""
    return all(u <= tol_update and s <= TOL_RL_PARAM and z <= tol_noise
               for u, s, _, z in errs)


# ---------------------------------------------------------------------------
# the TD3 agent
# ---------------------------------------------------------------------------


def agent_copy(agent, dev, td3):
    return agent_from_numpy(agent_to_numpy(agent), td3, device=dev)


def check_agents(what, card, cpu, start, n_updates, lr):
    """Every network and target of an agent after a step on the card
    against its CPU copy after the same step from the agent ``start``."""
    tol_noise = 2 * lr * n_updates
    errs = {name: network_errs(card[name], cpu[name], start[name])
            for name in rl.NETWORKS + tuple(n + "_target"
                                            for n in rl.NETWORKS)}
    assert errs_ok(errs.values(), tol_noise), (
        f"{what}: the card disagrees with the CPU: {errs}")
    assert card["step"] == cpu["step"], f"{what}: step differs"


def random_transitions(n, td3, seed, device):
    """n transitions of the RL phase's shapes: GFV-scale states, actions in
    [-1, 1], rewards about the reward's scale, done."""
    g = torch.Generator().manual_seed(seed)
    batch = rl.TransitionBatch(
        states=0.5 * torch.randn(n, td3.state_dim, generator=g),
        actions=torch.tanh(torch.randn(n, td3.action_dim, generator=g)),
        rewards=-20.0 + torch.randn(n, 1, generator=g),
        next_states=0.5 * torch.randn(n, td3.state_dim, generator=g),
        dones=torch.ones(n, 1))
    return rl.TransitionBatch(*(v.to(device) for v in batch))


def agent_warm(agent, td3, seed):
    """The agent on the CPU after ``policy_delay`` TD3 updates on random
    transitions, one of them the actor's, so every element of every
    network's Adam holds moments (``lgan_warm`` says why): the trained
    agent's elements that no training state fed (an input channel the
    encoder left at 0 on the training clouds) are fresh, and a fresh
    element's first step is lr times the sign of its gradient, which flips
    between two devices where a ReLU kink moves the gradient through 0
    (on an H100: one element of the actor's first layer moved the
    rl_step's actor update 2.4e-2 of the CPU's)."""
    cpu = torch.device("cpu")
    warm = agent_copy(agent, cpu, td3)
    for i in range(td3.policy_delay):
        rl.agent_update(
            warm, random_transitions(td3.batch_size, td3, seed + i, cpu),
            torch.randn((td3.batch_size, td3.action_dim),
                        generator=torch.Generator().manual_seed(seed + i)),
            td3)
    return warm


# ---------------------------------------------------------------------------
# the latent GAN
# ---------------------------------------------------------------------------


def lgan_draws(cfg, seed):
    """The draws of one ``lgan_combined_step`` at ``cfg``'s widths."""
    lc, m = cfg.training.lgan, cfg.model.lgan
    return steps.draw_lgan_combined(torch.Generator().manual_seed(seed),
                                     lc.batch_size, m.z_dim,
                                     m.discriminator_dims, lc.d_steps)


def lgan_warm(lgan, cfg, real, seed):
    """The LGAN ``{"params", "state"}`` on the CPU after one
    ``lgan_combined_step`` on ``real`` (d_steps, B, latent), and the G and
    D Adam states it built. A fresh Adam's first step moves each element
    by lr times the sign of its gradient, so an element whose gradient is
    at the rounding level flips between two devices; from moments one
    step old the update is a smooth function of the gradient."""
    lc = cfg.training.lgan
    params = on_device(lgan["params"], torch.device("cpu"), grad=True)
    state = on_device(lgan["state"], torch.device("cpu"))
    g_opt = steps.make_gan_optimizer(params["generator"], lc.generator_lr, lc)
    d_opt = steps.make_gan_optimizer(params["discriminator"],
                                     lc.discriminator_lr, lc)
    state, _ = steps.lgan_combined_step(params, state, d_opt, g_opt, real,
                                        lgan_draws(cfg, seed),
                                        lambda_gp=lc.lambda_gp)
    return ({"params": params, "state": state}, g_opt.state_dict(),
            d_opt.state_dict())


def lgan_step_on(dev, warm, cfg, real, draws, lr_scale=1.0, mesh=None):
    """One ``lgan_combined_step`` on ``dev`` from ``lgan_warm``'s
    weights, state and Adam states, with lr times ``lr_scale``: (metrics,
    {"generator", "discriminator"} each {"params", "state"}). Under
    ``mesh`` ``real`` is this rank's rows and ``draws`` the global
    batch's."""
    lc = cfg.training.lgan
    lgan, g_sd, d_sd = warm
    params = on_device(lgan["params"], dev, grad=True)
    state = on_device(lgan["state"], dev)
    opts = {}
    for k, sd, lr in (("generator", g_sd, lc.generator_lr),
                      ("discriminator", d_sd, lc.discriminator_lr)):
        opts[k] = steps.make_gan_optimizer(params[k], lr, lc)
        # a copy: on the CPU load_state_dict would share the step counts
        opts[k].load_state_dict(copy.deepcopy(sd))
        for group in opts[k].param_groups:
            group["lr"] = lr * lr_scale
    state, sm = steps.lgan_combined_step(
        params, state, opts["discriminator"], opts["generator"], real.to(dev),
        on_device(draws, dev), lambda_gp=lc.lambda_gp, mesh=mesh)
    return sm, {k: {"params": params[k], "state": state[k]}
                for k in ("generator", "discriminator")}


# ---------------------------------------------------------------------------
# the joint fine-tune (phase 5)
# ---------------------------------------------------------------------------


def joint_model(model, dev):
    """A copy of what the joint step reads (ae, lgan, the actor) on
    ``dev``, its ae and lgan parameters taking a gradient."""
    out = {k: {"params": on_device(model[k]["params"], dev, grad=True),
               "state": on_device(model[k]["state"], dev)}
           for k in ("ae", "lgan")}
    out["agent"] = {"actor": on_device(model["agent"]["actor"], dev)}
    return out


def joint_networks(model):
    """{"encoder", "decoder", "generator"}, each {"params", "state"}."""
    ae, lgan = model["ae"], model["lgan"]
    return {"encoder": {p: ae[p]["encoder"] for p in ("params", "state")},
            "decoder": {p: ae[p]["decoder"] for p in ("params", "state")},
            "generator": {p: lgan[p]["generator"]
                          for p in ("params", "state")}}


def joint_kw(trainer, precision="float32"):
    """The joint step's keywords as the trainer passes them."""
    jc = trainer.config.training.joint
    dtype, selective = steps.compute_dtype_of(precision)
    return dict(cfg=trainer.td3, compute_dtype=dtype, selective=selective,
                spec=trainer.preproc, bidirectional=trainer.bidirectional,
                w_ae_recon=jc.w_ae_recon, bn_stats=trainer.bn_stats,
                freeze_generator=jc.freeze_generator)


def joint_batch(trainer, seed, bsz=B_STEP_CHECK):
    """A batch of ``bsz`` full-width clouds and its draws (holes and
    augmentation), on the CPU."""
    pc, _ = make_clouds(bsz, N_MAIN, seed=seed, device=torch.device("cpu"))
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(seed),
                                       bsz, N_MAIN, spec=trainer.preproc)
    return {"complete_pc": pc, "pad": torch.zeros(bsz)}, draws


def joint_warm(trainer, seed):
    """The joint model on the CPU after one f32 ``joint_train_step`` from
    the trainer's, and its Adam's state: moments one step old (a fresh
    Adam's first step is lr x sign(gradient), see lgan_warm)."""
    cpu = torch.device("cpu")
    jc = trainer.config.training.joint
    model = joint_model(trainer.model, cpu)
    opt = steps.make_joint_optimizer(
        steps.joint_trainable(model, jc.freeze_generator), jc)
    model, _ = steps.joint_train_step(model, opt, *joint_batch(trainer, seed),
                                      **joint_kw(trainer))
    return model, opt.state_dict()


def joint_step_on(dev, warm, trainer, batch, draws, lr_scale=1.0):
    """One f32 ``joint_train_step`` on ``dev`` from ``joint_warm``'s model
    and Adam state, lr times ``lr_scale``: (metrics, joint_networks)."""
    jc = trainer.config.training.joint
    model = joint_model(warm[0], dev)
    opt = steps.make_joint_optimizer(
        steps.joint_trainable(model, jc.freeze_generator), jc)
    opt.load_state_dict(copy.deepcopy(warm[1]))
    for group in opt.param_groups:
        group["lr"] = jc.lr * lr_scale
    model, m = steps.joint_train_step(model, opt, on_device(batch, dev),
                                      on_device(draws, dev),
                                      **joint_kw(trainer))
    return m, joint_networks(model)
