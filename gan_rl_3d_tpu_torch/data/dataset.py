"""Point-cloud files, the dataset and its batch plan
(gan_rl_3d_tpu/data/dataset.py).

Numpy only. ``load_h5`` imports h5py when it is called. Files are parsed
by numpy; the JAX package's C++ loader (``gan_rl_3d_tpu/runtime``) is not
ported yet, so a split this module caches may resample clouds in another
order than the JAX package's C++ path does.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from gan_rl_3d_tpu_torch.data.synthetic import create_synthetic_dataset

CATEGORY_MAPPING = {
    "airplane": "02691156",
    "car": "02958343",
    "chair": "03001627",
    "lamp": "03636649",
    "sofa": "04256520",
    "table": "04379243",
    "watercraft": "04530566",
    "cabinet": "02933112",
}


def load_ply(path: Path) -> np.ndarray:
    """ASCII PLY vertex loader (x y z [r g b])."""
    with open(path) as f:
        lines = f.readlines()
    start = 0
    for i, line in enumerate(lines):
        if line.strip() == "end_header":
            start = i + 1
            break
    pts = []
    for line in lines[start:]:
        parts = line.split()
        if len(parts) >= 3:
            try:
                pts.append([float(parts[0]), float(parts[1]), float(parts[2])])
            except ValueError:
                continue
    return np.asarray(pts, np.float32)


def load_txt(path: Path) -> np.ndarray:
    arr = np.atleast_2d(np.loadtxt(path).astype(np.float32))
    if arr.size == 0:
        return np.zeros((0, 3), np.float32)
    return arr[:, :3]


def load_h5(path: Path) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        for key in ("data", "points"):
            if key in f:
                return np.asarray(f[key], np.float32).reshape(-1, 3)
        key = list(f.keys())[0]
        return np.asarray(f[key], np.float32).reshape(-1, 3)


def load_point_cloud(path: str) -> np.ndarray:
    p = Path(path)
    if p.suffix == ".ply":
        return load_ply(p)
    if p.suffix in (".txt", ".pts"):
        return load_txt(p)
    if p.suffix == ".h5":
        return load_h5(p)
    raise ValueError(f"unsupported point-cloud format: {p.suffix}")


def resample_with_mask(pc: np.ndarray, num_points: int,
                       rng: np.random.RandomState
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Resample one cloud to exactly ``num_points`` rows: subsample without
    replacement when larger, repeat-pad when smaller. Returns (points
    (num_points, 3), validity mask (num_points,))."""
    n = len(pc)
    if n == 0:
        raise ValueError("cannot resample an empty point cloud")
    if n >= num_points:
        idx = rng.choice(n, num_points, replace=False)
        return pc[idx].astype(np.float32), np.ones(num_points, np.float32)
    pad = pc[rng.randint(0, n, num_points - n)]
    mask = np.concatenate([np.ones(n, np.float32),
                           np.zeros(num_points - n, np.float32)])
    return np.concatenate([pc, pad]).astype(np.float32), mask


class ShapeNetDataset:
    """Fixed-size point clouds under a directory tree (dataset.py:127-281):
    the file index is cached as ``{split}_data[_frac..].json``; splits come
    from per-split directories, or from ``split_fractions`` (train, val,
    test) by a hash of the file name for flat trees. Every cloud is
    resampled to ``num_points`` rows and the split is held in memory as
    one (S, num_points, 3) float32 array."""

    def __init__(self, data_dir: str, split: str = "train",
                 num_points: int = 2048, seed: int = 0,
                 split_fractions: Optional[Tuple[float, float, float]] = None):
        self.data_dir = Path(data_dir)
        self.split = split
        self.num_points = num_points
        self.split_fractions = split_fractions
        self._rng = np.random.RandomState(seed)
        self.files = self._load_index()
        self._cache: Optional[np.ndarray] = None

    def _load_index(self) -> List[Dict]:
        suffix = ""
        if self.split_fractions is not None:
            f = self.split_fractions
            suffix = (f"_frac{int(f[0] * 100)}_{int(f[1] * 100)}"
                      f"_{int(f[2] * 100)}")
        index_file = self.data_dir / f"{self.split}_data{suffix}.json"
        if index_file.exists():
            with open(index_file) as f:
                files = json.load(f)
        else:
            files = self._scan()
            if files:
                index_file.parent.mkdir(parents=True, exist_ok=True)
                with open(index_file, "w") as f:
                    json.dump(files, f, indent=2)
        return files

    def _split_of_path(self, p: Path) -> str:
        frac = self.split_fractions
        h = int(hashlib.md5(str(p.name).encode()).hexdigest()[:8], 16)
        u = h / 0xFFFFFFFF
        if u < frac[0]:
            return "train"
        if u < frac[0] + frac[1]:
            return "val"
        return "test"

    def _scan(self) -> List[Dict]:
        files = []
        for ext in ("*.ply", "*.pts", "*.txt", "*.h5"):
            for p in sorted(self.data_dir.rglob(ext)):
                if self.split_fractions is not None:
                    in_split = self._split_of_path(p) == self.split
                else:
                    # path components or the file stem, not a substring of
                    # the whole path (a data_dir "train_set" holds all splits)
                    parts = [q.lower() for q in
                             p.relative_to(self.data_dir).parts[:-1]]
                    in_split = (self.split in parts
                                or self.split in p.stem.lower())
                if in_split:
                    files.append({"path": str(p),
                                  "category": self._category_of(p),
                                  "model_id": p.stem})
        return files

    @staticmethod
    def _category_of(path: Path) -> str:
        for part in path.parts:
            if part in CATEGORY_MAPPING:
                return part
            for name, cid in CATEGORY_MAPPING.items():
                if part == cid:
                    return name
        return "unknown"

    def __len__(self) -> int:
        return len(self.files)

    def as_array(self) -> np.ndarray:
        """The whole split as one (S, num_points, 3) float32 array."""
        if self._cache is None:
            if not self.files:
                raise ValueError(f"empty {self.split} split at "
                                 f"{self.data_dir}")
            arr = np.empty((len(self.files), self.num_points, 3), np.float32)
            for i, entry in enumerate(self.files):
                try:
                    arr[i], _ = resample_with_mask(
                        load_point_cloud(entry["path"]), self.num_points,
                        self._rng)
                except (ValueError, IOError) as e:
                    raise IOError(f"failed to load {entry['path']!r} "
                                  f"({self.split} split): {e}") from e
            self._cache = arr
        return self._cache


class BatchLoader:
    """Shuffled fixed-shape batches over a ShapeNetDataset
    (dataset.py:289-383, one shard group). The last short batch wraps
    around to the front of the epoch's order, and ``pad`` marks the
    wrapped rows so losses can leave them out."""

    def __init__(self, dataset: ShapeNetDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def epoch_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """One epoch's batch plan: (indices (S, B) int32, pad (S, B) f32)."""
        n, bs = len(self.dataset), self.batch_size
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        if n == 0:
            return (np.zeros((0, bs), np.int32), np.zeros((0, bs), np.float32))
        all_idx, all_pad = [], []
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            pad = np.zeros((len(idx),), np.float32)
            if len(idx) < bs:
                # np.resize tiles, so a dataset smaller than the batch
                # still fills it
                extra = np.resize(order, bs - len(idx))
                idx = np.concatenate([idx, extra])
                pad = np.concatenate([pad, np.ones((len(extra),), np.float32)])
            all_idx.append(idx)
            all_pad.append(pad)
        return np.stack(all_idx).astype(np.int32), np.stack(all_pad)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        data = self.dataset.as_array()
        for idx, pad in zip(*self.epoch_indices()):
            yield {"complete_pc": data[idx], "pad": pad}


def setup_dataset(data_dir: str, synthetic: bool = False,
                  samples_per_category: int = 100,
                  num_points: int = 2048) -> None:
    """Write the synthetic dataset (the JAX package's generator, same seed,
    same files); real ShapeNet is downloaded by hand."""
    if not synthetic:
        raise ValueError(
            "real ShapeNet (latent_3d_points) is downloaded by hand and "
            f"extracted under {data_dir} as <split>/<category>/*.ply; pass "
            "synthetic=True to generate data")
    create_synthetic_dataset(data_dir,
                             samples_per_category=samples_per_category,
                             num_points=num_points)
