#!/usr/bin/env python3
"""Where K6's time goes (csrc/encoder_pool_int8.cu) on one NVIDIA GPU: the
source as it is, built beside variants that change one part of it, each
called through the same C entry on the flagship int8 engine's packed
bundle and timed at B=64 and 4096.

  python3 k6_breakdown.py

Variants (text substitutions of the source and of its shared header
int8_quantize.cuh; each must still match one of them):
  ieee_divide     the quantizing divide as __fdiv_rn (the same bits),
  skip_zeros      that, with zero dividends kept off the divide (the same
                  bits),
  no_products     the mma replaced by one integer op (wrong output;
                  timing only: the CUDA-core work and the fragment loads),
  no_quantize     the quantization replaced by one multiply (wrong
                  output; timing only),
  generic         the flagship widths through the generic instance (the
                  same bits), against the one with the widths fixed at
                  compile time.
Prints each variant's registers from nvcc -Xptxas -v, its time and its
count of output elements that differ from the built kernel's.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
from gan_rl_3d_tpu_torch.ops import _cuda, encoder_kernel as ek

QUANTIZE = "rintf(divide(v, s, r))"
VARIANTS = {
    "as_built": [],
    "ieee_divide": [(QUANTIZE, "rintf(__fdiv_rn(v, s))")],
    "skip_zeros": [(QUANTIZE,
                    "(v == 0.f ? 0.f : rintf(__fdiv_rn(v == 0.f ? s : v, s)))")],
    "no_products": [("mma_s8(acc[j], a[kc], b.x, b.y);",
                     "acc[j][0] ^= b.x + a[kc][0];")],
    "no_quantize": [(QUANTIZE, "__fmul_rn(v, r)")],
    "generic": [("const bool fixed = is_flagship(p);",
                 "const bool fixed = false;")],
}


def build(folder: Path) -> dict:
    """Each variant's source and K6's shared header (int8_quantize.cuh),
    substituted, in a folder of its own (a quoted include finds the
    variant's header first), built side by side."""
    files = {f: (_cuda.CSRC / f).read_text()
             for f in ("encoder_pool_int8.cu", "int8_quantize.cuh")}
    procs = {}
    for name, subs in VARIANTS.items():
        texts = dict(files)
        for old, new in subs:
            hits = [f for f, text in texts.items() if old in text]
            if not hits:
                sys.exit(f"k6_breakdown: {name}: {old!r} not in the source")
            for f in hits:
                texts[f] = texts[f].replace(old, new)
        (folder / name).mkdir()
        for f, text in texts.items():
            (folder / name / f).write_text(text)
        cu = folder / name / "encoder_pool_int8.cu"
        so = folder / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"k6_breakdown: {name} failed to build:\n{log}")
        regs = sorted(set(int(x) for x in
                          re.findall(r"Used (\d+) registers", log)))
        print(f"{name}: registers of its instances {regs}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grl_encoder_pool_int8.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                              p, p, p]
        libs[name] = lib
    return libs


def call(lib, packed, pc, mask, sms):
    bsz, n, _ = pc.shape
    bits = torch.empty((bsz, packed.c_last), dtype=torch.int32,
                       device=pc.device)
    out = torch.empty((bsz, packed.c_last), device=pc.device)
    err = lib.grl_encoder_pool_int8(
        pc.data_ptr(), None if mask is None else mask.data_ptr(),
        packed.data.data_ptr(), ctypes.addressof(packed.c_dims),
        len(packed.dims) - 1, packed.c_last, bsz, n, sms, pc.device.index,
        bits.data_ptr(), out.data_ptr(), _cuda.stream_of(pc))
    if err:
        raise RuntimeError(f"k6_breakdown: CUDA error {err}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k6_breakdown: needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    from gan_rl_3d_tpu_torch.convert import model_from_numpy
    from gan_rl_3d_tpu_torch.models import inference

    model = model_from_numpy(chip_smoke.init_numpy_model(
        chip_smoke._flagship(), seed=0), device=device)
    qenc = inference.prepare_inference_engine(
        model, quantize_int8=True)["encoder_q"]
    packed = ek.packed_int8_encoder(qenc)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for bsz, reps in ((chip_smoke.B_MAIN, 20), (chip_smoke.B_BIG, 3)):
            pc, mask = chip_smoke.make_clouds(bsz, chip_smoke.N_MAIN, 1,
                                              device)
            ref = call(libs["as_built"], packed, pc, mask, sms)
            for name, lib in libs.items():
                n_diff = int((call(lib, packed, pc, mask, sms) != ref).sum())
                ms = chip_smoke.timed_ms(
                    lambda: call(lib, packed, pc, None, sms), reps=reps)
                print(f"K6 {name} B={bsz}: {ms:.4f} ms, {n_diff} of "
                      f"{ref.numel()} elements differ from as_built")
            del pc, mask, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
