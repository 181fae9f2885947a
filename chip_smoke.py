#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gan_rl_3d_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each failing the run if it fails:
  1. device: require CUDA, print the card's name and power limit, build
     every kernel from csrc/ with nvcc (sm_90a), one process per source;
  2. kernels vs their plain PyTorch versions at the main paths' shapes
     (B=64, N=M=2048, masked and unmasked): K1, K6 (also at B=3, N=1500
     with a fully masked cloud), K3, K2; K4 (gather) and K5 (scatter), K5
     twice for identical bits; the Chamfer gradient by the kernels against
     the same autograd Function on CPU copies;
  3. the serving path at full width: the flagship config with random
     weights from a fixed seed, ``complete`` against ``complete_fast``
     (f32, all gate modes), the bf16 engine against f32, the int8 engine
     against f32 and ``complete`` (all gate modes), f32 and int8 engine
     files served by ``gan_rl_3d_tpu_torch.complete_clouds --engine`` on
     .txt and .ply clouds, and the completions scored by
     ``evaluate_completion``; K1, K6, K3 and K2 must launch in this phase;
  4. the training path at full width: a synthetic dataset written by the
     port, ``RLGANNetTrainer(...).train_autoencoder()`` for 2 epochs of
     2 steps at B=64 with the flagship recipe (bf16_selective), every
     loss finite, K3, K4 and K5 launched, the best checkpoint reloaded;
     then one f32 ``ae_train_step`` at B=8 on the card against the same
     step on the CPU (same weights and draws): loss and every gradient;
     then the serving side on that checkpoint: ``gan_rl_3d_tpu_torch.
     evaluate --checkpoint autoencoder_best --export-engine``, and
     ``complete_clouds --checkpoint`` and ``--engine`` (the exported
     engine) on a few files (K3 and K2 must launch);
  5. times: each kernel, its plain version, the least time the card could
     take (bound) and a library yardstick, at B=64 (and B=4096 for the
     serving kernels, B=512 for K4 and K5), the time per ``complete_fast``
     call at B=64 and B=4096 (f32, bf16 and int8 engines), and per
     ``ae_train_step`` at B=64 in f32 and bf16_selective, with a
     torch.profiler trace of the step (device busy time, idle share,
     launches, top kernels).

The next-to-last line is a JSON object describing every kernel; the last
line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on
# the tensor cores, HBM3 bandwidth. They assume the full 700 W limit.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

TOL_F32 = 1e-4      # f32 kernel / engine vs plain, scaled by max(1, |ref|)
TOL_BF16 = 2e-2     # bf16 vs its reference, relative to max |ref|
# K6 vs its plain version: the int32 sums are exact and every rounding step
# is the plain version's, so the expected error is 0; the bound is the
# JAX package's kernel-vs-twin one (tests/test_fused_encoder.py:96-97)
TOL_INT8_RTOL, TOL_INT8_ATOL = 1e-2, 1e-3
# the int8 engine against f32: the GFV within 2e-2 of its largest element
# (the JAX package's pooled-feature bound, test_fused_encoder.py:98-100),
# clouds within 0.1 of the unfolded complete (test_fused_encoder.py:119-121)
TOL_INT8_GFV = 2e-2
TOL_INT8_PC = 0.1
TOL_DIST = 1e-3     # |a|^2+|b|^2-2ab cancellation in f32
TIE_GAP = 1e-4      # squared-distance gap below which an index may differ
# K4 / K5 vs plain, scaled by max(1, |ref|): K4 rounds as its plain version
# does; K5 sums in increasing i, the plain scatter_add_ in another order
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
B_MAIN, N_MAIN = 64, 2048
B_BIG = 4096
B_GRAD_BIG = 512
B_STEP_CHECK = 8
TRACE_STEPS = 5     # ae_train_steps traced by torch.profiler
TRACE_TOP = 12      # kernels listed by their device time


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def scaled_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max(1, max |ref|): absolute for O(1) outputs."""
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / max(1.0, float(ref.abs().max())))


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / ref.abs().max())


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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
    return _as_f32(tree)


def _as_f32(tree):
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_f32(v) for v in tree]
    return np.asarray(tree, np.float32)


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


def timed_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def graph_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Device time per call of a short kernel: ``reps`` calls captured in
    one CUDA graph and replayed, so the host's per-call work (argument
    checks, allocation, the ctypes call) is left out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return timed_ms(graph.replay, reps=1, repeats=repeats) / reps


def chunked(fn, bsz: int, chunk: int):
    """fn(lo, hi) over batch chunks: the plain distance versions and the
    library call materialise (B, N, M), too large to hold at B=4096."""
    def run():
        for lo in range(0, bsz, chunk):
            fn(lo, min(bsz, lo + chunk))
    return run


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on a GPU only")
    from gan_rl_3d_tpu_torch.device import resolve_device
    from gan_rl_3d_tpu_torch.ops import _cuda

    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"built {sorted(_cuda.SOURCES)} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    torch.cuda.synchronize()
    return device


def phase_kernels(device, engine_f32, engine_bf16, engine_int8):
    """Each kernel against its plain version at the main path's shapes."""
    from gan_rl_3d_tpu_torch.ops import chamfer, encoder_kernel as ek

    errs = {}
    pc, mask = make_clouds(B_MAIN, N_MAIN, seed=1, device=device)
    for name, eng, dtype in (("encoder_pool_f32", engine_f32, torch.float32),
                             ("encoder_pool_bf16", engine_bf16,
                              torch.bfloat16)):
        worst, worst_abs = 0.0, 0.0
        for m in (None, mask):
            out = ek.fused_encoder_pool(pc, eng["encoder"]["layers"], m,
                                        compute_dtype=dtype)
            ref = ek.fused_encoder_pool_plain(pc, eng["encoder"]["layers"], m,
                                              compute_dtype=dtype)
            expect(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                   f"{name}: bad output")
            e = (scaled_err(out, ref) if dtype == torch.float32
                 else rel_err(out, ref))
            worst = max(worst, e)
            worst_abs = max(worst_abs, float((out - ref).abs().max()))
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        kind = "scaled" if dtype == torch.float32 else "relative"
        print(f"{name}: {kind} err vs plain {worst:.3e} (tol {tol:g}), "
              f"max abs err {worst_abs:.3e}")
        expect(worst <= tol, f"{name} disagrees with its plain version")
        errs[name] = worst_abs
    torch.cuda.synchronize()

    qenc = engine_int8["encoder_q"]
    rpc, rmask = make_clouds(3, 1500, seed=9, device=device)
    rmask[0] = 0.0  # a fully masked cloud pools to -inf
    worst, n_diff, n_all = 0.0, 0, 0
    for x, m in ((pc, None), (pc, mask), (rpc, None), (rpc, rmask)):
        out = ek.fused_encoder_pool_int8(x, qenc, m)
        ref = ek.fused_encoder_pool_int8_plain(x, qenc, m)
        expect(out.shape == ref.shape
               and torch.equal(torch.isneginf(out), torch.isneginf(ref))
               and not bool((torch.isnan(out) | torch.isposinf(out)).any()),
               "encoder_pool_int8: bad output")
        fin = torch.isfinite(ref)
        expect(torch.allclose(out[fin], ref[fin], rtol=TOL_INT8_RTOL,
                              atol=TOL_INT8_ATOL),
               "encoder_pool_int8 disagrees with its plain version")
        worst = max(worst, float((out[fin] - ref[fin]).abs().max()))
        n_diff += int((out != ref).sum())
        n_all += out.numel()
    expect(bool(torch.isneginf(out[0]).all()),
           "encoder_pool_int8: a fully masked cloud is not -inf")
    print(f"encoder_pool_int8: max abs err vs plain {worst:.3e} (bound rtol "
          f"{TOL_INT8_RTOL:g}, atol {TOL_INT8_ATOL:g}; expected 0), {n_diff} "
          f"of {n_all} elements differ (B={B_MAIN}, N={N_MAIN} and B=3, "
          "N=1500, masked and unmasked)")
    errs["encoder_pool_int8"] = worst
    torch.cuda.synchronize()

    a, _ = make_clouds(B_MAIN, N_MAIN, seed=2, device=device)
    b, b_mask = make_clouds(B_MAIN, N_MAIN, seed=3, device=device)
    worst_d, worst_i = 0.0, 0
    for bm in (None, b_mask):
        d, i = chamfer.nearest_distances(a, b, b_mask=bm)
        rd, ri = chamfer.nearest_distances_plain(a, b, bm)
        worst_d = max(worst_d, float((d - rd).abs().max()))
        d2 = chamfer._sqdist(a, b, bm)
        top2 = d2.topk(2, dim=-1, largest=False).values
        settled = (top2[..., 1] - top2[..., 0]) > TIE_GAP
        mismatched = int(((i != ri) & settled).sum())
        worst_i = max(worst_i, mismatched)
        # where the index may differ, the chosen neighbours' distances agree
        chosen = torch.sqrt(torch.clamp(
            d2.gather(-1, i.long()[..., None])[..., 0], min=1e-12))
        worst_d = max(worst_d, float((chosen - rd).abs().max()))
        del d2
    print(f"nn_dist: max dist err {worst_d:.3e} (tol {TOL_DIST:g}), "
          f"{worst_i} settled index mismatches")
    expect(worst_d <= TOL_DIST and worst_i == 0, "nn_dist disagrees")
    errs["nn_dist"] = worst_d
    e = float((chamfer.nearest_min_distances(a, b)
               - chamfer.nearest_min_distances_plain(a, b)).abs().max())
    print(f"nn_min: max dist err {e:.3e} (tol {TOL_DIST:g})")
    expect(e <= TOL_DIST, "nn_min disagrees")
    errs["nn_min"] = e
    # a ragged size, off every tile boundary
    ra, rb = a[:3, :1001], b[:3, :777]
    e = float((chamfer.nearest_min_distances(ra, rb)
               - chamfer.nearest_min_distances_plain(ra, rb)).abs().max())
    expect(e <= TOL_DIST, f"nn_min ragged disagrees ({e})")
    torch.cuda.synchronize()
    return errs


def grad_inputs(bsz, n, m, seed, device, masked):
    """K3's outputs on two clouds and a cotangent g ~ U(0.5, 1.5), the
    inputs K4 and K5 see in the Chamfer backward."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    a, _ = make_clouds(bsz, n, seed=seed, device=device)
    b, b_mask = make_clouds(bsz, m, seed=seed + 1, device=device)
    bm = b_mask if masked else None
    dist, idx = chamfer.nearest_distances(a, b, b_mask=bm)
    g = 0.5 + torch.rand(bsz, n, generator=torch.Generator(device=device)
                         .manual_seed(seed + 2), device=device)
    return a, b, bm, dist, idx, g


def chamfer_grad_vs_cpu(a, b, b_mask=None):
    """The Chamfer gradient w.r.t. both clouds by the autograd Function on
    ``a``'s device (the kernels) against the same Function on CPU copies
    (the plain versions). A query point whose neighbour differs (a
    near-tie: K3 and the plain version round |a|^2 + |b|^2 - 2ab
    differently) moves the gradient of it and of both candidate
    neighbours, so those are left out. Returns (the largest difference
    relative to the largest gradient element, the number of points left
    out, the largest |gradient| of a masked b point)."""
    from gan_rl_3d_tpu_torch.ops import chamfer

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


def phase_grad_kernels(device):
    """K4 and K5 against their plain versions, K5's repeatability, and the
    Chamfer gradient by the kernels against the same Function on the CPU."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    errs = {"nn_gather": 0.0, "nn_scatter": 0.0}
    for masked in (False, True):
        a, b, _, dist, idx, g = grad_inputs(B_MAIN, N_MAIN, N_MAIN, 10,
                                            device, masked)
        da = chamfer.nearest_grad_a(a, b, idx, dist, g)
        ref = chamfer.nearest_grad_a_plain(a, b, idx, dist, g)
        e = scaled_err(da, ref)
        errs["nn_gather"] = max(errs["nn_gather"],
                                float((da - ref).abs().max()))
        expect(e <= TOL_GRAD_KERNEL, f"nn_gather disagrees ({e:.3e})")
        db = chamfer.nearest_grad_b(idx, da, N_MAIN)
        ref = chamfer.nearest_grad_b_plain(idx, da, N_MAIN)
        e = scaled_err(db, ref)
        errs["nn_scatter"] = max(errs["nn_scatter"],
                                 float((db - ref).abs().max()))
        expect(e <= TOL_GRAD_KERNEL, f"nn_scatter disagrees ({e:.3e})")
        expect(torch.equal(db, chamfer.nearest_grad_b(idx, da, N_MAIN)),
               "nn_scatter: two launches on the same inputs differ")
        # ragged sizes, off every tile and chunk boundary
        ra, rb, _, rd, ri, rg = grad_inputs(3, 2501, 777, 11, device, masked)
        rda = chamfer.nearest_grad_a(ra, rb, ri, rd, rg)
        expect(scaled_err(rda, chamfer.nearest_grad_a_plain(ra, rb, ri, rd,
                                                            rg))
               <= TOL_GRAD_KERNEL, "nn_gather ragged disagrees")
        expect(scaled_err(chamfer.nearest_grad_b(ri, rda, 777),
                          chamfer.nearest_grad_b_plain(ri, rda, 777))
               <= TOL_GRAD_KERNEL, "nn_scatter ragged disagrees")
    print(f"nn_gather: max abs err vs plain {errs['nn_gather']:.3e}; "
          f"nn_scatter: {errs['nn_scatter']:.3e} (tol {TOL_GRAD_KERNEL:g} "
          "scaled), bitwise repeatable")

    worst = 0.0
    for masked in (False, True):
        a, _ = make_clouds(B_MAIN, N_MAIN, seed=12, device=device)
        b, b_mask = make_clouds(B_MAIN, N_MAIN, seed=13, device=device)
        e, flipped, masked_grad = chamfer_grad_vs_cpu(
            a, b, b_mask if masked else None)
        worst = max(worst, e)
        print(f"chamfer grad ({'masked' if masked else 'unmasked'}): "
              f"card vs CPU {e:.3e} of max |grad| (tol "
              f"{TOL_CHAMFER_GRAD:g}); {flipped} of {2 * B_MAIN * N_MAIN} "
              "points left out for a flipped neighbour")
        expect(flipped <= 64, "too many flipped neighbours")
        expect(masked_grad == 0.0, "masked b points got a gradient")
    expect(worst <= TOL_CHAMFER_GRAD, "chamfer gradient disagrees")
    torch.cuda.synchronize()
    return errs


def write_scans(folder: Path, seed: int) -> list:
    """Three scans of 1500, 2048 and 3000 points (.txt, .ply, .txt) far
    from the origin, as a user's files would be."""
    from gan_rl_3d_tpu_torch.utils.ply import save_ply

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    inputs = []
    for i, n in enumerate((1500, 2048, 3000)):
        pts = (rng.randn(n, 3) * [1.0, 0.5, 0.3] + SCAN_CENTRE)
        path = folder / f"scan_{i}.{'ply' if i == 1 else 'txt'}"
        if path.suffix == ".ply":
            save_ply(str(path), pts)
        else:
            np.savetxt(path, pts)
        inputs.append(path)
    return inputs


def serve_files(inputs, out_dir: Path, args, n_out: int) -> None:
    """Run ``complete_clouds`` on ``inputs`` with ``args`` and check every
    PLY it writes: ``n_out`` finite points in the input's frame."""
    from gan_rl_3d_tpu_torch import complete_clouds
    from gan_rl_3d_tpu_torch.data.dataset import load_ply

    complete_clouds.main([*map(str, inputs), *args, "--output-dir",
                          str(out_dir)])
    for src in inputs:
        pts = load_ply(out_dir / f"{src.stem}_completed.ply")
        expect(pts.shape == (n_out, 3) and np.isfinite(pts).all(),
               f"served {src.name} ({args}): {pts.shape}")
        # written in the input's frame: centred near the input's centroid
        expect(np.abs(pts.mean(0) - SCAN_CENTRE).max() < 5.0,
               f"served {src.name} not in the input frame")


def phase_main(device, model, tmp: Path):
    """The completion path at full width, counted launch by launch."""
    from gan_rl_3d_tpu_torch.models import inference, rl_gan_net
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.ops.metrics import evaluate_completion

    target, mask = make_clouds(B_MAIN, N_MAIN, seed=4, device=device)
    cfg = _flagship().td3_config()
    _cuda.launch_counts.clear()

    engine = inference.prepare_inference_engine(model)
    for mode in ("discriminator", "rl", "ae", "union"):
        ref = rl_gan_net.complete(model, target, mask, cfg=cfg, gate_mode=mode)
        fast = inference.complete_fast(engine, target, mask, gate_mode=mode)
        expect(set(ref) == set(fast), f"{mode}: output keys differ")
        for k in ref:
            r, f = ref[k], fast[k]
            if k == "hybrid_output" and mode == "discriminator":
                margin = (ref["rl_gan_score"] - ref["ae_score"])[:, 0].abs()
                r, f = r[margin > 1e-4], f[margin > 1e-4]
            e = scaled_err(f, r)
            expect(e <= TOL_F32, f"complete_fast {mode} {k}: err {e:.3e}")
        print(f"complete_fast f32 == complete, gate {mode} "
              f"(hybrid {tuple(fast['hybrid_output'].shape)})")

    engine_bf16 = inference.prepare_inference_engine(model,
                                                     dtype=torch.bfloat16)
    f32 = inference.complete_fast(engine, target, mask, gate_mode="rl")
    bf = inference.complete_fast(engine_bf16, target, mask, gate_mode="rl")
    worst = max(rel_err(bf[k], f32[k]) for k in
                ("noisy_gfv", "z_vector", "clean_gfv", "completed_pc",
                 "ae_reconstruction"))
    print(f"complete_fast bf16 vs f32: max rel err {worst:.3e} "
          f"(tol {TOL_BF16:g})")
    expect(worst <= TOL_BF16, "bf16 engine disagrees with f32")

    engine_q = inference.prepare_inference_engine(model, quantize_int8=True)
    for mode in ("discriminator", "rl", "ae", "union"):
        ref = rl_gan_net.complete(model, target, mask, cfg=cfg, gate_mode=mode)
        f32 = inference.complete_fast(engine, target, mask, gate_mode=mode)
        q = inference.complete_fast(engine_q, target, mask, gate_mode=mode)
        expect(set(q) == set(ref), f"int8 {mode}: output keys differ")
        gfv = rel_err(q["noisy_gfv"], f32["noisy_gfv"])
        pc_err = max(float((q[k] - ref[k]).abs().max())
                     for k in ("completed_pc", "ae_reconstruction"))
        hq, hr, ties = q["hybrid_output"], ref["hybrid_output"], 0
        if mode == "discriminator":
            # a row's gate cannot flip where the reference margin exceeds
            # how far the int8 engine moved the two scores
            margin = (ref["rl_gan_score"] - ref["ae_score"])[:, 0].abs()
            shift = ((q["rl_gan_score"] - ref["rl_gan_score"]).abs()
                     + (q["ae_score"] - ref["ae_score"]).abs())[:, 0]
            settled = margin > shift
            hq, hr, ties = hq[settled], hr[settled], int((~settled).sum())
        hyb = float((hq - hr).abs().max()) if hq.numel() else 0.0
        print(f"complete_fast int8, gate {mode}: noisy_gfv vs f32 engine "
              f"{gfv:.3e} of max (tol {TOL_INT8_GFV:g}); completed_pc / "
              f"ae_reconstruction vs complete {pc_err:.3e}, hybrid_output "
              f"{hyb:.3e} (tol {TOL_INT8_PC:g}; {ties} near-tie rows left "
              "out)")
        expect(gfv <= TOL_INT8_GFV and pc_err <= TOL_INT8_PC
               and hyb <= TOL_INT8_PC, f"int8 engine disagrees ({mode})")

    # serve files through the CLI, as a user would
    eng_path, q_path = tmp / "engine.pkl", tmp / "engine_q.pkl"
    inference.save_engine(str(eng_path), engine)
    inference.save_engine(str(q_path), engine_q)
    inputs = write_scans(tmp / "scans", seed=5)
    for path, mode, n_out in ((eng_path, "discriminator", N_MAIN),
                              (eng_path, "union", 2 * N_MAIN),
                              (q_path, "discriminator", N_MAIN)):
        serve_files(inputs, tmp / f"out_{path.stem}_{mode}",
                    ["--engine", str(path), "--gate-mode", mode, "--device",
                     device.type], n_out)
    print(f"complete_clouds --engine served {len(inputs)} files: f32 engine "
          "x 2 gate modes, int8 engine")

    completion = inference.complete_fast(engine, target, mask)["hybrid_output"]
    scores = evaluate_completion(
        completion, target,
        metrics=("chamfer_distance", "completion_ratio",
                 "hausdorff_distance", "f_score"))
    expect(all(bool(torch.isfinite(v)) for v in scores.values()),
           "non-finite metric")
    print("evaluate_completion: " + ", ".join(
        f"{k}={float(v):.6f}" for k, v in scores.items()))
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    print(f"serving-path launches: {counts}")
    for name in SERVING_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "serving path")
    return engine, engine_bf16, engine_q, counts


def _flagship():
    from gan_rl_3d_tpu_torch.config import flagship_config
    return flagship_config()


def phase_train(device, tmp: Path):
    """The training path at full width: phase 1 of the curriculum through
    the trainer the CLI calls, counted launch by launch; then one f32 step
    on the card against the same step on the CPU."""
    import dataclasses

    from gan_rl_3d_tpu_torch.data.dataset import setup_dataset
    from gan_rl_3d_tpu_torch.ops import _cuda
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer

    t0 = time.perf_counter()
    # 8 categories x 16 train clouds: 2 steps per epoch at B=64
    setup_dataset(str(tmp / "data"), synthetic=True, samples_per_category=16)
    print(f"synthetic dataset written in {time.perf_counter() - t0:.1f}s")
    cfg = _flagship()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_dir=str(tmp / "data")),
        training=dataclasses.replace(
            cfg.training, checkpoint_dir=str(tmp / "ckpt"),
            autoencoder=dataclasses.replace(cfg.training.autoencoder,
                                            epochs=2)))
    trainer = RLGANNetTrainer(cfg, device=device)
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    best = trainer.train_autoencoder()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    losses = trainer.train_losses
    print(f"training-path launches: {counts}")
    print(f"train_autoencoder: {len(losses)} steps ({dt:.2f}s with "
          f"validation), losses {[round(x, 6) for x in losses]}, best val "
          f"{best:.6f}")
    expect(len(losses) == 4 and all(np.isfinite(losses)) and np.isfinite(best),
           "non-finite or missing training loss")
    for name in TRAINING_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "training path")
    saved = trainer.model["ae"]
    expect((tmp / "ckpt" / "autoencoder_best").exists(),
           "autoencoder_best was not written")
    epoch, phase = trainer.load_checkpoint("autoencoder_best")
    expect((epoch, phase) == (1, "autoencoder"), f"checkpoint meta {epoch}, "
           f"{phase}")
    for a, b in zip(_leaves(saved), _leaves(trainer.model["ae"])):
        expect(torch.equal(a.detach(), b.detach()),
               "reloaded checkpoint differs from the trained model")
    print("autoencoder_best reloaded through the port's load_checkpoint")
    step_check(device, trainer.model["ae"])
    return counts, cfg


def phase_eval(device, tmp: Path, cfg):
    """The serving side on phase 1's checkpoint, through the CLIs a user
    calls: ``evaluate --checkpoint autoencoder_best --export-engine``, then
    ``complete_clouds --checkpoint`` and ``--engine`` (the exported
    engine) on a few files; counted launch by launch."""
    import dataclasses

    from gan_rl_3d_tpu_torch import evaluate
    from gan_rl_3d_tpu_torch.config import load_config
    from gan_rl_3d_tpu_torch.ops import _cuda

    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, results_dir=str(tmp / "results")))
    cfg_path = tmp / "run.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(cfg)))
    expect(load_config(str(cfg_path)) == cfg, "config JSON round trip")
    engine_path = tmp / "engine_eval.pkl"
    inputs = write_scans(tmp / "scans_eval", seed=6)
    torch.cuda.synchronize()
    _cuda.launch_counts.clear()
    t0 = time.perf_counter()
    stats = evaluate.main(["--config", str(cfg_path), "--checkpoint",
                           "autoencoder_best", "--num-export", "2",
                           "--export-engine", str(engine_path), "--device",
                           device.type])
    dt = time.perf_counter() - t0
    expect(len(stats) >= 5 and all(np.isfinite(v) for v in stats.values()),
           f"evaluate: non-finite or missing metrics {stats}")
    expect((tmp / "results" / "results_viewer.html").exists()
           and len(list((tmp / "results" / "point_clouds").glob("*.ply")))
           == 6, "evaluate: report or PLY samples missing")
    print(f"evaluate --checkpoint autoencoder_best: {len(stats)} metrics in "
          f"{dt:.2f}s, " + ", ".join(f"{k}={v:.6f}" for k, v in stats.items()))
    for args in (["--checkpoint", "autoencoder_best"],
                 ["--engine", str(engine_path)]):
        serve_files(inputs, tmp / f"out_eval_{args[0][2:]}",
                    [*args, "--config", str(cfg_path), "--device",
                     device.type], N_MAIN)
    print(f"complete_clouds --checkpoint autoencoder_best and --engine "
          f"{engine_path.name} served {len(inputs)} files each")
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    print(f"evaluation-path launches: {counts}")
    for name in EVAL_KERNELS:
        expect(counts.get(name, 0) > 0, f"{name} never launched on the "
               "evaluation path")
    return counts


def _leaves(tree):
    from gan_rl_3d_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def step_check(device, ae_model):
    """One f32 ae_train_step at B=8 on the card and on the CPU, from the
    same weights, batch and draws: the loss and every gradient."""
    from gan_rl_3d_tpu_torch.config import AETrainConfig
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train import steps
    from gan_rl_3d_tpu_torch.utils.tree import tree_map

    pc, _ = make_clouds(B_STEP_CHECK, N_MAIN, seed=20, device=device)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(21),
                                       B_STEP_CHECK, N_MAIN)
    results = []
    for dev in (device, torch.device("cpu")):
        params = tree_map(lambda v: v.detach().to(dev).clone()
                          .requires_grad_(True), ae_model["params"])
        state = tree_map(lambda v: v.detach().to(dev), ae_model["state"])
        opt, _ = steps.make_ae_optimizer(params, AETrainConfig(), 1)
        _, m = steps.ae_train_step(
            params, state, opt,
            {"complete_pc": pc.to(dev),
             "pad": torch.zeros(B_STEP_CHECK, device=dev)},
            {k: v.to(dev) for k, v in draws.items()},
            bn_stats="single_read_grouped")
        results.append((float(m["loss"]),
                        [p.grad.cpu() for p in _leaves(params)]))
    (loss, grads), (ref_loss, ref_grads) = results
    scale = max(float(g.abs().max()) for g in ref_grads)
    e = max(float((g - r).abs().max()) for g, r in zip(grads, ref_grads))
    e /= scale
    le = abs(loss - ref_loss) / abs(ref_loss)
    print(f"ae_train_step f32 B={B_STEP_CHECK}: loss card {loss:.7f} cpu "
          f"{ref_loss:.7f} (rel {le:.3e}, tol {TOL_STEP_LOSS:g}); gradients "
          f"{e:.3e} of max |grad| {scale:.3e} (tol {TOL_STEP_GRAD:g})")
    expect(le <= TOL_STEP_LOSS and e <= TOL_STEP_GRAD,
           "the f32 step on the card disagrees with the CPU")


KERNELS = {
    "encoder_pool_f32": ("gan_rl_3d_tpu_torch/csrc/encoder_pool.cu",
                         "gan_rl_3d_tpu/ops/encoder_kernel.py:151"),
    "encoder_pool_bf16": ("gan_rl_3d_tpu_torch/csrc/encoder_pool.cu",
                          "gan_rl_3d_tpu/ops/encoder_kernel.py:151"),
    "encoder_pool_int8": ("gan_rl_3d_tpu_torch/csrc/encoder_pool_int8.cu",
                          "gan_rl_3d_tpu/ops/encoder_kernel.py:249"),
    "nn_dist": ("gan_rl_3d_tpu_torch/csrc/nn_dist.cu",
                "gan_rl_3d_tpu/ops/chamfer.py:121"),
    "nn_min": ("gan_rl_3d_tpu_torch/csrc/nn_dist.cu",
               "gan_rl_3d_tpu/ops/chamfer.py:201"),
    "nn_gather": ("gan_rl_3d_tpu_torch/csrc/nn_grad.cu",
                  "gan_rl_3d_tpu/ops/chamfer.py:289"),
    "nn_scatter": ("gan_rl_3d_tpu_torch/csrc/nn_grad.cu",
                   "gan_rl_3d_tpu/ops/chamfer.py:309"),
}
SERVING_KERNELS = ("encoder_pool_f32", "encoder_pool_bf16",
                   "encoder_pool_int8", "nn_dist", "nn_min")
TRAINING_KERNELS = ("nn_dist", "nn_gather", "nn_scatter")
EVAL_KERNELS = ("encoder_pool_f32", "nn_dist", "nn_min")
SCAN_CENTRE = np.array([10.0, -2.0, 3.0])


def encoder_bound(bsz, n, layers, bf16):
    """(ms, bound_by): ops over the type's peak vs bytes over HBM rate."""
    dims = [3] + [w.shape[1] for w, _ in layers]
    flop0 = 2 * bsz * n * dims[0] * dims[1]
    flop_rest = 2 * bsz * n * sum(a * b for a, b in zip(dims[1:], dims[2:]))
    ops_s = (flop0 / PEAK_F32
             + flop_rest / (PEAK_BF16 if bf16 else PEAK_F32))
    wbytes = sum(w.numel() * (2 if bf16 else 4) + b.numel() * 4
                 for w, b in layers)
    nbytes = bsz * n * 3 * 4 + wbytes + bsz * dims[-1] * 4
    return _bound(ops_s, nbytes)


def int8_encoder_bound(bsz, n, qenc):
    """K6: (ms, bound_by) from layer 0's f32 flop on the CUDA cores and the
    int8 ops on the tensor cores, or the bytes; and the ms the row
    quantization and dequantization would take on the CUDA cores at the
    f32 rate, which the bound leaves out (per quantized layer: per input
    activation an abs-max compare, a divide, a round and a two-sided clip;
    per output two multiplies, an add and a ReLU)."""
    w0, b0 = qenc["layer0"]
    layers = qenc["layers_q"]
    ops_s = (2 * bsz * n * w0.numel() / PEAK_F32
             + 2 * bsz * n * sum(wq.numel() for wq, _, _ in layers)
             / PEAK_INT8)
    wbytes = sum(x.numel() * x.element_size()
                 for x in (w0, b0, *[x for layer in layers for x in layer]))
    nbytes = bsz * n * 3 * 4 + wbytes + bsz * layers[-1][0].shape[1] * 4
    per_point = sum(5 * wq.shape[0] + 4 * wq.shape[1] for wq, _, _ in layers)
    return (*_bound(ops_s, nbytes), bsz * n * per_point / PEAK_F32 * 1e3)


def nn_bound(bsz, n, m, keep_idx):
    ops_s = bsz * n * m * 8 / PEAK_F32
    nbytes = (bsz * n * 3 + bsz * m * 3) * 4 + bsz * n * (8 if keep_idx else 4)
    return _bound(ops_s, nbytes)


def gather_bound(bsz, n, m):
    """K4 reads a, b, idx, dist, g once and writes da; about 9 flop a point
    (compare, max, divide, 3 subtract, 3 multiply)."""
    nbytes = (bsz * n * 3 + bsz * m * 3 + 3 * bsz * n + bsz * n * 3) * 4
    return _bound(bsz * n * 9 / PEAK_F32, nbytes)


def scatter_bound(bsz, n, m):
    """K5 reads idx and da once and writes db; the sum needs 3 adds a query
    point (its O(N M) compares are this design's cost, not the function's)."""
    nbytes = (bsz * n + bsz * n * 3 + bsz * m * 3) * 4
    return _bound(bsz * n * 3 / PEAK_F32, nbytes)


def _bound(ops_s, nbytes):
    bytes_s = nbytes / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def phase_times(device, engine, engine_bf16, engine_q):
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.ops import chamfer, encoder_kernel as ek

    rows = {}
    for bsz in (B_MAIN, B_BIG):
        pc, _ = make_clouds(bsz, N_MAIN, seed=6, device=device)
        b, _ = make_clouds(bsz, N_MAIN, seed=7, device=device)
        for name, eng, dtype in (("encoder_pool_f32", engine, torch.float32),
                                 ("encoder_pool_bf16", engine_bf16,
                                  torch.bfloat16)):
            layers = eng["encoder"]["layers"]
            reps = 20 if bsz == B_MAIN else 3
            ms = timed_ms(lambda: ek.fused_encoder_pool(
                pc, layers, compute_dtype=dtype), reps=reps)
            plain = timed_ms(lambda: ek.fused_encoder_pool_plain(
                pc, layers, compute_dtype=dtype), reps=reps)
            bound, by = encoder_bound(bsz, N_MAIN, layers,
                                      dtype == torch.bfloat16)
            rows[(name, bsz)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                     bound_by=by, library_ms=None)
        qenc = engine_q["encoder_q"]
        reps = 20 if bsz == B_MAIN else 3
        ms = timed_ms(lambda: ek.fused_encoder_pool_int8(pc, qenc), reps=reps)
        plain = timed_ms(lambda: ek.fused_encoder_pool_int8_plain(pc, qenc),
                         reps=reps)
        bound, by, core_ms = int8_encoder_bound(bsz, N_MAIN, qenc)
        rows[("encoder_pool_int8", bsz)] = dict(
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=None, quantize_f32_ms=core_ms)
        torch.cuda.empty_cache()
        chunk = 256
        reps = 20 if bsz == B_MAIN else 2
        for name, kernel, plain_fn, keep in (
                ("nn_dist", lambda: chamfer.nearest_distances(pc, b),
                 lambda lo, hi: chamfer.nearest_distances_plain(
                     pc[lo:hi], b[lo:hi]), True),
                ("nn_min", lambda: chamfer.nearest_min_distances(pc, b),
                 lambda lo, hi: chamfer.nearest_min_distances_plain(
                     pc[lo:hi], b[lo:hi]), False)):
            ms = timed_ms(kernel, reps=reps)
            plain = timed_ms(chunked(plain_fn, bsz, chunk), reps=reps)
            lib = timed_ms(chunked(lambda lo, hi: torch.cdist(
                pc[lo:hi], b[lo:hi]).min(-1), bsz, chunk), reps=reps)
            bound, by = nn_bound(bsz, N_MAIN, N_MAIN, keep)
            rows[(name, bsz)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                     bound_by=by, library_ms=lib)
        del pc, b
        torch.cuda.empty_cache()
    for (name, bsz), r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = ("" if "quantize_f32_ms" not in r else
                 f"; row (de)quantization on the CUDA cores alone "
                 f"{r['quantize_f32_ms']:.4f} ms at the f32 rate")
        print(f"time {name} B={bsz}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib} ms{extra}")

    for bsz, reps in ((B_MAIN, 20), (B_BIG, 3)):
        pc, mask = make_clouds(bsz, N_MAIN, seed=8, device=device)
        for label, eng in (("f32", engine), ("bf16", engine_bf16),
                           ("int8", engine_q)):
            ms = timed_ms(lambda: inference.complete_fast(eng, pc, mask),
                          reps=reps, repeats=3)
            print(f"complete_fast {label} B={bsz}: {ms:.3f} ms per call, "
                  f"{bsz / (ms / 1e3):.1f} clouds/s")
    torch.cuda.synchronize()
    return rows


def device_kernel_times(prof):
    """(name, launches, device us) of every kernel, copy and memset in a
    torch.profiler trace. The device-side range of a record_function
    annotation (such as Optimizer.step#Adam.step) overlaps the kernels it
    holds; it carries the name of its host-side range, so device events
    named like a host event are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type != cuda}
    return [(e.key, e.count, e.self_device_time_total) for e in events
            if e.device_type == cuda and e.key not in host_names]


def phase_train_times(device):
    """K4 and K5 at B=64 and 512 beside their plain versions, bounds and
    library yardsticks (K4's is torch.gather plus the arithmetic, which is
    its plain version timed again: no one library call computes the fused
    function; index_add_ for K5), all as device time from CUDA graphs (an
    eager call of these microsecond kernels measures the host). Then one
    ae_train_step at B=64, N=2048 at the flagship widths in f32 and
    bf16_selective: its time, and a torch.profiler trace of TRACE_STEPS
    steps for the device's busy time, its idle share of the step, the
    launches per step and the kernels that take the most device time."""
    from gan_rl_3d_tpu_torch.models import autoencoder as ae
    from gan_rl_3d_tpu_torch.ops import chamfer
    from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
    from gan_rl_3d_tpu_torch.train import steps
    from gan_rl_3d_tpu_torch.utils.tree import tree_map

    rows = {}
    for bsz in (B_MAIN, B_GRAD_BIG):
        a, b, _, dist, idx, g = grad_inputs(bsz, N_MAIN, N_MAIN, 14, device,
                                            False)
        da = chamfer.nearest_grad_a(a, b, idx, dist, g)
        flat = (idx.long() + N_MAIN * torch.arange(
            bsz, device=device)[:, None]).reshape(-1)
        neg = (-da).reshape(-1, 3)
        acc = torch.zeros(bsz * N_MAIN, 3, device=device)
        for name, kernel, plain, library, (bound, by) in (
                ("nn_gather",
                 lambda: chamfer.nearest_grad_a(a, b, idx, dist, g),
                 lambda: chamfer.nearest_grad_a_plain(a, b, idx, dist, g),
                 lambda: chamfer.nearest_grad_a_plain(a, b, idx, dist, g),
                 gather_bound(bsz, N_MAIN, N_MAIN)),
                ("nn_scatter",
                 lambda: chamfer.nearest_grad_b(idx, da, N_MAIN),
                 lambda: chamfer.nearest_grad_b_plain(idx, da, N_MAIN),
                 lambda: acc.index_add_(0, flat, neg),
                 scatter_bound(bsz, N_MAIN, N_MAIN))):
            rows[(name, bsz)] = dict(
                ms=graph_ms(kernel), plain_ms=graph_ms(plain),
                bound_ms=bound, bound_by=by, library_ms=graph_ms(library),
                call_ms=timed_ms(kernel))
    for (name, bsz), r in rows.items():
        print(f"time {name} B={bsz}: kernel {r['ms']:.4f} ms (device, "
              f"CUDA graph; {r['call_ms']:.4f} ms per eager call), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']:.4f} ms")

    cfg = _flagship()
    m = cfg.model.autoencoder
    params, state = ae.autoencoder_init(
        torch.Generator().manual_seed(0), m.input_dim, m.latent_dim,
        m.num_points, m.encoder_dims, m.decoder_dims)
    params = tree_map(lambda v: v.to(device).requires_grad_(True), params)
    state = tree_map(lambda v: v.to(device), state)
    opt, _ = steps.make_ae_optimizer(params, cfg.training.autoencoder, 2)
    pc, _ = make_clouds(B_MAIN, N_MAIN, seed=15, device=device)
    batch = {"complete_pc": pc, "pad": torch.zeros(B_MAIN, device=device)}
    draws = pc_ops.draw_training_batch(
        torch.Generator(device=device).manual_seed(16), B_MAIN, N_MAIN)

    def ae_step(precision):
        dtype, selective = steps.compute_dtype_of(precision)
        steps.ae_train_step(params, state, opt, batch, draws,
                            compute_dtype=dtype, selective=selective,
                            bn_stats=cfg.training.bn_stats)

    step_ms = {}
    for precision in ("float32", "bf16_selective"):
        torch.cuda.reset_peak_memory_stats()
        ms = step_ms[precision] = timed_ms(
            lambda: ae_step(precision), reps=10, repeats=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"ae_train_step {precision} B={B_MAIN}: {ms:.3f} ms per step, "
              f"{B_MAIN / (ms / 1e3):.1f} clouds/s, peak memory "
              f"{peak:.2f} GiB")
    # traced only after every step is timed: timed after a trace in the
    # same process, the bf16_selective step read 67.8 ms, against 48.8 ms
    # in a process that had traced nothing (H100 80GB HBM3, 700 W)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for precision, ms in step_ms.items():
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(TRACE_STEPS):
                ae_step(precision)
            torch.cuda.synchronize()
        events = device_kernel_times(prof)
        busy = sum(us for _, _, us in events) / 1e3 / TRACE_STEPS
        launches = sum(n for _, n, _ in events) / TRACE_STEPS
        print(f"ae_train_step {precision} trace of {TRACE_STEPS} steps: "
              f"device busy {busy:.3f} ms a step, idle share "
              f"{1 - busy / ms:.3f} of the {ms:.3f} ms step, {launches:.0f} "
              "device launches a step; most device time:")
        for name, n, us in sorted(events, key=lambda e: -e[2])[:TRACE_TOP]:
            print(f"  {us / 1e3 / TRACE_STEPS:9.4f} ms  x{n / TRACE_STEPS:5.0f}"
                  f"  {name[:110]}")
    ms = timed_ms(lambda: ae_step("float32"), reps=10, repeats=3)
    print(f"ae_train_step float32 B={B_MAIN} timed again after the traces: "
          f"{ms:.3f} ms per step")
    torch.cuda.synchronize()
    return rows


def main() -> None:
    device = phase_device()
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import inference

    model = model_from_numpy(init_numpy_model(_flagship(), seed=0),
                             device=device)
    errs = phase_kernels(device, inference.prepare_inference_engine(model),
                         inference.prepare_inference_engine(
                             model, dtype=torch.bfloat16),
                         inference.prepare_inference_engine(
                             model, quantize_int8=True))
    errs.update(phase_grad_kernels(device))
    with tempfile.TemporaryDirectory() as tmp:
        engine, engine_bf16, engine_q, serving = phase_main(device, model,
                                                            Path(tmp))
        training, cfg = phase_train(device, Path(tmp))
        evaluation = phase_eval(device, Path(tmp), cfg)
    rows = phase_times(device, engine, engine_bf16, engine_q)
    rows.update(phase_train_times(device))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {"serving": serving.get(name, 0),
                   "training": training.get(name, 0),
                   "evaluation": evaluation.get(name, 0)}
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[name],
            **rows[(name, B_MAIN)], "shape": f"B={B_MAIN}, N=M={N_MAIN}",
        }
        for big in (B_BIG, B_GRAD_BIG):
            if (name, big) in rows:
                row[f"b{big}"] = rows[(name, big)]
        kernels.append(row)
    print("kernels: " + ", ".join(
        f"{k['name']} x{k['launches']}" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
