#!/usr/bin/env python3
"""A/B of two builds of the port's K1 (csrc/encoder_pool.cu), K6
(csrc/encoder_pool_int8.cu), K3/K2 (csrc/nn_dist.cu) and K5
(csrc/nn_grad.cu) on one NVIDIA GPU: this checkout's kernels, through
their wrappers (which pick each instance by the widths), against another
checkout's, built from its sources.

  python3 kernel_ab.py --other DIR [--kernels encoder_pool
                                    encoder_pool_int8 nn_dist nn_grad]

DIR is the root of the other checkout (for example the parent commit
unpacked with ``git archive``). The other build is called through its own
C entry points: ``grl_encoder_pool`` with or without the point tile
(which it then takes from this checkout's ``encoder_tile``) and the
device index, and
``grl_nn_grad_b`` with or without a global scratch (which it then sizes
by its ``grl_nn_grad_b_scratch``); K6 through ``grl_encoder_pool_int8``,
the ``mma.sync`` build's on this checkout's packed bundle, or the
``__dp4a`` build's on int32 words of four int8 weights; K3 and K2
through ``grl_nn_dist`` and ``grl_nn_min``.
For each kernel it prints the count of output elements that differ
between the two builds (K1 at B=64 and 4096, N=2048 with the flagship
engine's f32 and bf16 weights, masked and unmasked, with the largest
difference: this checkout's bf16 engine runs the tensor-core instance,
which sums in another order than the other build's CUDA-core one; K6 at
B=64 and 4096 with the
flagship int8 engine, masked and unmasked; K3's dist and idx and K2's dist
at B=64 masked and unmasked and B=4096, N=M=2048; K5 on the Chamfer
backward's
inputs at B=64 masked and unmasked, B=512, and the adversarial cases of
chip_smoke.py), then times both in turns (other, this, this, other).
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
from gan_rl_3d_tpu_torch.ops import _cuda


def build_other(root: Path, name: str, out_dir: Path) -> ctypes.CDLL:
    src = root / "gan_rl_3d_tpu_torch" / "csrc" / f"{name}.cu"
    lib = out_dir / f"libother_{name}.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    text = src.read_text()
    lib.takes_tile = "int bf16, int tile," in text
    lib.takes_device = "int n_points, int device," in text
    lib.takes_packed = "const void* packed, const int* dims" in text
    return lib


def other_encoder_pool(lib, pc, layers, mask, dtype):
    from gan_rl_3d_tpu_torch.ops.encoder_kernel import encoder_tile

    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grl_encoder_pool.argtypes = ([p, p, p, p, p, i, i]
                                     + [i] * lib.takes_tile + [i, i]
                                     + [i] * lib.takes_device + [p, p, p])
    lib.grl_encoder_pool.restype = i
    weights = [w.to(dtype).contiguous() for w, _ in layers]
    biases = [b.float().contiguous() for _, b in layers]
    dims = [3] + [w.shape[1] for w in weights]
    bsz, n, _ = pc.shape
    bits = torch.empty((bsz, dims[-1]), dtype=torch.int32, device=pc.device)
    out = torch.empty((bsz, dims[-1]), device=pc.device)
    w_ptrs = (p * len(weights))(*[w.data_ptr() for w in weights])
    b_ptrs = (p * len(biases))(*[b.data_ptr() for b in biases])
    c_dims = (i * len(dims))(*dims)
    tile = [encoder_tile(dims)] if lib.takes_tile else []
    device = [pc.device.index] if lib.takes_device else []
    err = lib.grl_encoder_pool(
        pc.data_ptr(), None if mask is None else mask.data_ptr(),
        ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
        ctypes.addressof(c_dims), len(weights),
        int(dtype == torch.bfloat16), *tile, bsz, n, *device,
        bits.data_ptr(), out.data_ptr(), _cuda.stream_of(pc))
    if err:
        raise RuntimeError(f"other encoder_pool: CUDA error {err}")
    return out


def other_scatter(lib, idx, da, m):
    p, i = ctypes.c_void_p, ctypes.c_int
    with_scratch = hasattr(lib, "grl_nn_grad_b_scratch")
    lib.grl_nn_grad_b.argtypes = [p, p, i, i, i] + [p] * with_scratch + [p, p]
    lib.grl_nn_grad_b.restype = i
    bsz, n = idx.shape
    db = torch.empty((bsz, m, 3), device=da.device)
    scratch = []
    if with_scratch:
        lib.grl_nn_grad_b_scratch.argtypes = [i, i]
        lib.grl_nn_grad_b_scratch.restype = ctypes.c_longlong
        words = lib.grl_nn_grad_b_scratch(n, m)
        scratch = [torch.empty((bsz, words), dtype=torch.int32,
                               device=da.device).data_ptr() if words else None]
    err = lib.grl_nn_grad_b(idx.data_ptr(), da.data_ptr(), bsz, n, m,
                            *scratch, db.data_ptr(), _cuda.stream_of(da))
    if err:
        raise RuntimeError(f"other nn_grad_b: CUDA error {err}")
    return db


def other_encoder_pool_int8(lib, pc, qenc, mask, words=None):
    """The other build's K6 through its C entry: the ``mma.sync`` one on
    this checkout's packed bundle in its ``mma.sync`` layout (which that
    build reads), or the ``__dp4a`` one on each layer's int8 weights as
    int32 words of four along K (byte j of word [k4, c] is wq[4 k4 + j,
    c]), with separate scale and bias pointers; ``words`` holds them
    packed once (``int8_words``)."""
    from gan_rl_3d_tpu_torch.ops import encoder_kernel as ek

    p, i = ctypes.c_void_p, ctypes.c_int
    bsz, n, _ = pc.shape
    if lib.takes_packed:
        packed = ek.packed_int8_encoder(qenc)
        lib.grl_encoder_pool_int8.argtypes = [p, p, p, p] + [i] * 6 + [p] * 3
        lib.grl_encoder_pool_int8.restype = i
        bits = torch.empty((bsz, packed.c_last), dtype=torch.int32,
                           device=pc.device)
        out = torch.empty((bsz, packed.c_last), device=pc.device)
        err = lib.grl_encoder_pool_int8(
            pc.data_ptr(), None if mask is None else mask.data_ptr(),
            packed.data.data_ptr(), ctypes.addressof(packed.c_dims),
            len(packed.dims) - 1, packed.c_last, bsz, n,
            torch.cuda.get_device_properties(pc.device).multi_processor_count,
            pc.device.index, bits.data_ptr(), out.data_ptr(),
            _cuda.stream_of(pc))
        if err:
            raise RuntimeError(f"other encoder_pool_int8: CUDA error {err}")
        return out
    lib.grl_encoder_pool_int8.argtypes = [p] * 8 + [i, i, i, p, p, p]
    lib.grl_encoder_pool_int8.restype = i
    layers = qenc["layers_q"]
    words = words if words is not None else int8_words(qenc)
    w0, b0 = qenc["layer0"]
    w0 = w0.float().contiguous()
    b0 = b0.float().reshape(-1).contiguous()
    scales = [s.float().reshape(-1).contiguous() for _, s, _ in layers]
    biases = [b.float().reshape(-1).contiguous() for _, _, b in layers]
    dims = [w0.shape[1]] + [wq.shape[1] for wq, _, _ in layers]
    bits = torch.empty((bsz, dims[-1]), dtype=torch.int32, device=pc.device)
    out = torch.empty((bsz, dims[-1]), device=pc.device)
    ptrs = [(p * len(layers))(*[x.data_ptr() for x in xs])
            for xs in (words, scales, biases)]
    c_dims = (i * len(dims))(*dims)
    err = lib.grl_encoder_pool_int8(
        pc.data_ptr(), None if mask is None else mask.data_ptr(),
        w0.data_ptr(), b0.data_ptr(), *map(ctypes.addressof, ptrs),
        ctypes.addressof(c_dims), len(layers), bsz, n, bits.data_ptr(),
        out.data_ptr(), _cuda.stream_of(pc))
    if err:
        raise RuntimeError(f"other encoder_pool_int8: CUDA error {err}")
    return out


def int8_words(qenc):
    return [wq.reshape(wq.shape[0] // 4, 4, wq.shape[1]).transpose(1, 2)
            .contiguous().view(torch.int32).reshape(wq.shape[0] // 4, -1)
            for wq, _, _ in qenc["layers_q"]]


def differ(x, y) -> int:
    return int((x.view(torch.int32) != y.view(torch.int32)).sum())


def in_turns(label, other_fn, this_fn, timer):
    t = [timer(other_fn), timer(this_fn), timer(this_fn), timer(other_fn)]
    print(f"  time {label}: other {t[0]:.4f} / {t[3]:.4f} ms, this "
          f"{t[1]:.4f} / {t[2]:.4f} ms (other, this, this, other)")


def ab_encoder_pool(lib, device):
    """K1 of the two builds on the flagship engine at B=64 and 4096, N=2048,
    masked and unmasked: f32 (the other build's f32 instance) with its
    differing elements, expected 0; bf16, this checkout's instance by the
    widths against the other build's bf16 instance, with its differing
    elements and largest difference (absolute, and relative to the other
    build's largest |output|); then times in turns."""
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.ops import encoder_kernel as ek

    model = model_from_numpy(chip_smoke.init_numpy_model(
        chip_smoke._flagship(), seed=0), device=device)
    for dtype in (torch.float32, torch.bfloat16):
        layers = inference.prepare_inference_engine(
            model, dtype=dtype)["encoder"]["layers"]
        name = "f32" if dtype == torch.float32 else "bf16"
        for bsz, reps in ((chip_smoke.B_MAIN, 20), (chip_smoke.B_BIG, 3)):
            pc, mask = chip_smoke.make_clouds(bsz, chip_smoke.N_MAIN, 1,
                                              device)
            n_diff, n_all, worst, scale = 0, 0, 0.0, 0.0
            for m in (None, mask):
                mine = ek.fused_encoder_pool(pc, layers, m,
                                             compute_dtype=dtype)
                theirs = other_encoder_pool(lib, pc, layers, m, dtype)
                n_diff += differ(mine, theirs)
                n_all += mine.numel()
                worst = max(worst, float((mine - theirs).abs().max()))
                scale = max(scale, float(theirs.abs().max()))
            print(f"encoder_pool_{name}: {n_diff} of {n_all} elements differ "
                  f"from the other build, largest difference {worst:.3e} "
                  f"({worst / scale:.3e} of its largest |output|; B={bsz}, "
                  f"N={chip_smoke.N_MAIN}, masked and unmasked)")
            in_turns(f"encoder_pool_{name} B={bsz}",
                     lambda: other_encoder_pool(lib, pc, layers, None, dtype),
                     lambda: ek.fused_encoder_pool(pc, layers,
                                                   compute_dtype=dtype),
                     lambda fn: chip_smoke.timed_ms(fn, reps=reps))
            del pc, mask
            torch.cuda.empty_cache()


def ab_encoder_pool_int8(lib, device):
    """K6 of the two builds on the flagship int8 engine: differing elements
    at B=64 and 4096, masked and unmasked, then times in turns (the other
    build's weights packed once, outside the timed calls)."""
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.ops import encoder_kernel as ek

    model = model_from_numpy(chip_smoke.init_numpy_model(
        chip_smoke._flagship(), seed=0), device=device)
    qenc = inference.prepare_inference_engine(
        model, quantize_int8=True)["encoder_q"]
    words = int8_words(qenc)
    for bsz, reps in ((chip_smoke.B_MAIN, 20), (chip_smoke.B_BIG, 3)):
        pc, mask = chip_smoke.make_clouds(bsz, chip_smoke.N_MAIN, 1, device)
        n_diff, n_all = 0, 0
        for m in (None, mask):
            mine = ek.fused_encoder_pool_int8(pc, qenc, m)
            theirs = other_encoder_pool_int8(lib, pc, qenc, m, words)
            n_diff += differ(mine, theirs)
            n_all += mine.numel()
        print(f"encoder_pool_int8: {n_diff} of {n_all} elements differ from "
              f"the other build (B={bsz}, N={chip_smoke.N_MAIN}, masked and "
              "unmasked)")
        in_turns(f"encoder_pool_int8 B={bsz}",
                 lambda: other_encoder_pool_int8(lib, pc, qenc, None, words),
                 lambda: ek.fused_encoder_pool_int8(pc, qenc),
                 lambda fn: chip_smoke.timed_ms(fn, reps=reps))
        del pc, mask
        torch.cuda.empty_cache()


def ab_scatter(lib, device):
    from gan_rl_3d_tpu_torch.ops import chamfer

    n = chip_smoke.N_MAIN
    cases = []
    for bsz, masked in ((chip_smoke.B_MAIN, False), (chip_smoke.B_MAIN, True),
                        (chip_smoke.B_GRAD_BIG, False)):
        a, b, _, dist, idx, g = chip_smoke.grad_inputs(bsz, n, n, 14, device,
                                                       masked)
        da = chamfer.nearest_grad_a(a, b, idx, dist, g)
        cases.append((f"B={bsz}{' masked' if masked else ''}", idx, da, n))
    cases += chip_smoke.scatter_cases(device)
    for name, idx, da, m in cases:
        mine = chamfer.nearest_grad_b(idx, da, m)
        theirs = other_scatter(lib, idx, da, m)
        print(f"nn_scatter {name}: {differ(mine, theirs)} of {mine.numel()} "
              "elements differ from the other build")
    for name, idx, da, m in cases[1:3]:
        in_turns(f"nn_scatter {name} (device, CUDA graph)",
                 lambda: other_scatter(lib, idx, da, m),
                 lambda: chamfer.nearest_grad_b(idx, da, m),
                 chip_smoke.graph_ms)


def other_nn(lib, a, b, bm, keep_idx):
    """K3 (``keep_idx``: dist and idx) or K2 (dist, None) of another build
    through its C entry."""
    p, i = ctypes.c_void_p, ctypes.c_int
    bsz, n, _ = a.shape
    m = b.shape[1]
    dist = torch.empty((bsz, n), device=a.device)
    idx = None
    if keep_idx:
        idx = torch.empty((bsz, n), dtype=torch.int32, device=a.device)
        lib.grl_nn_dist.argtypes = [p, p, p, i, i, i, p, p, p]
        lib.grl_nn_dist.restype = i
        err = lib.grl_nn_dist(a.data_ptr(), b.data_ptr(),
                              None if bm is None else bm.data_ptr(), bsz, n,
                              m, dist.data_ptr(), idx.data_ptr(),
                              _cuda.stream_of(a))
    else:
        lib.grl_nn_min.argtypes = [p, p, i, i, i, p, p]
        lib.grl_nn_min.restype = i
        err = lib.grl_nn_min(a.data_ptr(), b.data_ptr(), bsz, n, m,
                             dist.data_ptr(), _cuda.stream_of(a))
    if err:
        raise RuntimeError(f"other nn_dist: CUDA error {err}")
    return dist, idx


def ab_nn_dist(lib, device):
    """K3 and K2 of the two builds at B=64 masked and unmasked and B=4096
    unmasked, N=M=2048: differing elements of K3's dist and idx and of
    K2's dist (expected 0: the same arithmetic a pair, the same first
    index), then the unmasked times in turns, of the eager call and as
    device time (CUDA graph)."""
    from gan_rl_3d_tpu_torch.ops import chamfer

    def this(a, b, bm, keep_idx):
        # K3's wrapper without autograd, as the other build is called
        if keep_idx:
            return chamfer._nearest_forward(a, b, bm)
        return chamfer.nearest_min_distances(a, b), None

    for bsz, masked in ((chip_smoke.B_MAIN, True), (chip_smoke.B_MAIN, False),
                        (chip_smoke.B_BIG, False)):
        a, _ = chip_smoke.make_clouds(bsz, chip_smoke.N_MAIN, 80, device)
        b, bm = chip_smoke.make_clouds(bsz, chip_smoke.N_MAIN, 81, device)
        bm = bm if masked else None
        what = f"B={bsz}{' masked' if masked else ''}"
        reps = 20 if bsz == chip_smoke.B_MAIN else 2
        for keep_idx, name in ((True, "nn_dist"), (False, "nn_min")):
            if masked and not keep_idx:
                continue
            d, i = this(a, b, bm, keep_idx)
            od, oi = other_nn(lib, a, b, bm, keep_idx)
            counts = f"dist {differ(d, od)}"
            if keep_idx:
                counts += f", idx {int((i != oi).sum())}"
            print(f"{name} {what}: {counts} of {d.numel()} elements differ "
                  "from the other build")
            if masked:
                continue
            for timer, how in ((chip_smoke.timed_ms, "eager call"),
                               (chip_smoke.graph_ms, "device, CUDA graph")):
                in_turns(f"{name} {what} ({how})",
                         lambda: other_nn(lib, a, b, None, keep_idx),
                         lambda: this(a, b, None, keep_idx),
                         lambda fn: timer(fn, reps=reps, repeats=3))
        del a, b, bm
        torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True)
    parser.add_argument("--kernels", nargs="+",
                        default=["encoder_pool", "nn_grad"],
                        choices=["encoder_pool", "encoder_pool_int8",
                                 "nn_dist", "nn_grad"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA device")
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _cuda.build(args.kernels)
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.kernels:
            lib = build_other(args.other, name, Path(tmp))
            {"encoder_pool": ab_encoder_pool,
             "encoder_pool_int8": ab_encoder_pool_int8,
             "nn_dist": ab_nn_dist,
             "nn_grad": ab_scatter}[name](lib, device)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
