"""The host data loader: ctypes over ``cpp/loader.cpp``
(gan_rl_3d_tpu/runtime/__init__.py).

Text and PLY parsing, unit-sphere normalisation and resampling in C++, with
the JAX package's arithmetic, so a data directory loads into the same arrays
in both packages. The library is built at first use with the system ``g++``
and the JAX package's flags into ``_build/`` inside the package, named by a
hash of the source and the flags (``-march=native``: a build serves the
machine that made it). A missing compiler or a failed build raises with the
compiler's output; nothing falls back to another parser here.

ctypes releases the GIL during calls, so ``load_files_parallel`` parses in
parallel from a thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cpp" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
_MAX_ROWS = 1 << 20  # rows read from one file; longer files are truncated

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgrl_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader unless this source and these flags are built
    already; returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's data loader "
                           f"({SOURCE.name}) is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        rows = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long]
        for name in ("grl_parse_xyz_file", "grl_parse_ply_file"):
            getattr(lib, name).restype = ctypes.c_long
            getattr(lib, name).argtypes = rows
        lib.grl_normalize_unit_sphere.restype = None
        lib.grl_normalize_unit_sphere.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.grl_resample.restype = ctypes.c_long
        lib.grl_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_uint64]
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _rows(pts: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(pts, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected (N, 3) points, got {pts.shape}")
    return pts


def _parse(fn, path: str, max_rows: int) -> np.ndarray:
    out = np.empty((max_rows, 3), np.float32)
    n = fn(str(path).encode(), _fptr(out), max_rows)
    if n <= 0:
        raise IOError(f"cannot parse {path} (rows={n})")
    return out[:n].copy()


def parse_xyz_file(path: str, max_rows: int = _MAX_ROWS) -> np.ndarray:
    """Parse a .txt/.pts cloud (the first 3 numeric columns of each row)
    -> (N, 3) float32."""
    return _parse(_load().grl_parse_xyz_file, path, max_rows)


def parse_ply_file(path: str, max_rows: int = _MAX_ROWS) -> np.ndarray:
    """Parse an ASCII PLY's vertex rows (after ``end_header``)."""
    return _parse(_load().grl_parse_ply_file, path, max_rows)


def normalize_unit_sphere(pts: np.ndarray) -> np.ndarray:
    """Centroid to the origin, largest radius to 1 (in doubles); a copy
    unless ``pts`` is already contiguous float32, which is changed in
    place."""
    lib = _load()
    pts = _rows(pts)
    lib.grl_normalize_unit_sphere(_fptr(pts), len(pts))
    return pts


def resample(pts: np.ndarray, target: int, seed: int = 1) -> np.ndarray:
    """Exactly ``target`` rows: a cloud of ``target`` rows unchanged, a
    larger one subsampled without replacement (partial Fisher-Yates), a
    smaller one padded with random rows; xorshift draws from ``seed``."""
    lib = _load()
    pts = _rows(pts)
    if target <= 0:
        raise ValueError(f"target must be positive, got {target}")
    out = np.empty((target, 3), np.float32)
    n = lib.grl_resample(_fptr(pts), len(pts), _fptr(out), target,
                         ctypes.c_uint64(seed or 1))
    if n < 0:
        raise ValueError("resample failed (empty input?)")
    return out


def load_files_parallel(paths: Sequence[str], target: int,
                        seed: int = 1, workers: int = 8) -> np.ndarray:
    """Parse and resample many files on ``workers`` threads ->
    (len(paths), target, 3); file i resamples with seed ``seed + i``."""
    lib = _load()
    if target <= 0:
        raise ValueError(f"target must be positive, got {target}")

    def one(args):
        i, path = args
        out = np.empty((_MAX_ROWS, 3), np.float32)
        parse = (lib.grl_parse_ply_file if path.endswith(".ply")
                 else lib.grl_parse_xyz_file)
        n = parse(path.encode(), _fptr(out), _MAX_ROWS)
        if n <= 0:
            raise IOError(f"cannot parse {path} (rows={n})")
        res = np.empty((target, 3), np.float32)
        if lib.grl_resample(_fptr(out), n, _fptr(res), target,
                            ctypes.c_uint64(seed + i)) < 0:
            raise IOError(f"resample failed for {path}")
        return i, res

    result = np.empty((len(paths), target, 3), np.float32)
    with ThreadPoolExecutor(max_workers=max(int(workers), 1)) as ex:
        for i, res in ex.map(one, enumerate(paths)):
            result[i] = res
    return result
