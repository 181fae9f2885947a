"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by nvcc for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes. Libraries go
to ``_build/`` inside the package, named by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one is reused. A
missing nvcc or a failed build raises; nothing falls back to another path.

``launch_counts`` holds one plain integer per kernel wrapper; a wrapper
adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("encoder_pool", "encoder_pool_bf16", "encoder_pool_int8",
           "encoder_pool_int8_wide", "nn_dist", "nn_grad", "bn_train")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

launch_counts: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together. Returns nvcc's output (the ``-Xptxas -v``
    register, spill and shared-memory report) per source that was
    compiled, and keeps it beside the library (``build_log``)."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and out.with_suffix(".log").exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
            continue
        out.with_suffix(".log").write_text(logs[name])
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return library_path(name).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.grl_error_string.argtypes = [ctypes.c_int]
            lib.grl_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.grl_error_string(err).decode()}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")


def refuse_grad(what: str, reason: str, *tensors) -> None:
    """A kernel without a backward refuses inputs that need a gradient
    rather than silently detaching them."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} on CUDA has no backward ({reason}); call it under "
            "torch.no_grad() or on detached inputs")
