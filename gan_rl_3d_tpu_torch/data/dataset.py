"""Point-cloud files, the dataset and its batch plan
(gan_rl_3d_tpu/data/dataset.py), at the JAX package's arrays.

A split whose files are all .txt/.pts/.ply is parsed and resampled by the
port's C++ loader (``gan_rl_3d_tpu_torch.runtime``) with the JAX package's
seed draw, so a data directory gives the JAX package's ``as_array()`` bit
for bit. ``.h5`` files, mixed splits and uncached ``__getitem__`` take the
numpy path (``load_point_cloud`` + ``resample_with_mask``), as in the JAX
package; it is also the plain version the tests hold the loader to.
``load_h5`` imports h5py when it is called.
"""

from __future__ import annotations

import hashlib
import json
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gan_rl_3d_tpu_torch import runtime
from gan_rl_3d_tpu_torch.data.synthetic import create_synthetic_dataset
# the shard-aligned batch plan's slot groups under training.data_residency
# "sharded"; importable from here as before
from gan_rl_3d_tpu_torch.parallel.mesh import DATA_SHARD_GROUPS  # noqa: F401

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


def load_txt_plain(path: Path) -> np.ndarray:
    """The numpy parser of a .txt/.pts cloud: the first 3 columns."""
    arr = np.atleast_2d(np.loadtxt(path).astype(np.float32))
    if arr.size == 0:
        return np.zeros((0, 3), np.float32)
    return arr[:, :3]


def load_txt(path: Path) -> np.ndarray:
    """A .txt/.pts cloud through the C++ parser; a file it reads no rows
    from goes to numpy, as in the JAX package."""
    try:
        return runtime.parse_xyz_file(str(path))
    except OSError:
        return load_txt_plain(path)


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
    test) by a hash of the file name for flat trees; ``categories`` keeps
    the named categories (names or ShapeNet ids). Every cloud is resampled
    to ``num_points`` rows. With ``cache_in_memory`` the constructor loads
    the whole split as one (S, num_points, 3) float32 array on ``workers``
    threads, drawing the loader's seed before any other use of the RNG, as
    the JAX package does."""

    def __init__(self, data_dir: str, split: str = "train",
                 num_points: int = 2048,
                 categories: Optional[Sequence[str]] = None,
                 cache_in_memory: bool = True, seed: int = 0,
                 split_fractions: Optional[Tuple[float, float, float]] = None,
                 workers: int = 8):
        self.data_dir = Path(data_dir)
        self.split = split
        self.num_points = num_points
        self.categories = list(categories) if categories else None
        self.split_fractions = split_fractions
        self.workers = max(int(workers), 1)
        self._rng = np.random.RandomState(seed)
        self.files = self._load_index()
        self._cache: Optional[np.ndarray] = None
        self._cache_lock = threading.Lock()
        if cache_in_memory:
            self._build_cache()

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
        if self.categories:
            ids = [CATEGORY_MAPPING.get(c, c) for c in self.categories]
            wanted = set(ids) | set(self.categories)
            files = [e for e in files
                     if e["category"] in wanted
                     or any(i in e["path"] for i in ids)]
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

    def _resample(self, pc: np.ndarray) -> np.ndarray:
        return resample_with_mask(pc, self.num_points, self._rng)[0]

    def _load_plain(self) -> np.ndarray:
        """The numpy path: each file parsed, then resampled by the
        dataset's RNG in file order."""
        arr = np.empty((len(self.files), self.num_points, 3), np.float32)
        for i, entry in enumerate(self.files):
            try:
                arr[i] = self._resample(load_point_cloud(entry["path"]))
            except (ValueError, IOError) as e:
                raise IOError(f"failed to load {entry['path']!r} "
                              f"({self.split} split): {e}") from e
        return arr

    def _build_cache(self) -> None:
        with self._cache_lock:
            if self._cache is not None or not self.files:
                return
            paths = [e["path"] for e in self.files]
            if all(p.endswith((".txt", ".pts", ".ply")) for p in paths):
                # one draw seeds file i with seed + i (dataset.py:243-252)
                seed = int(self._rng.randint(1, 1 << 30))
                try:
                    self._cache = runtime.load_files_parallel(
                        paths, self.num_points, seed=seed,
                        workers=self.workers)
                    return
                except OSError:  # a file the C++ parser reads no rows from
                    pass
            self._cache = self._load_plain()

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        if self._cache is not None:
            pc = self._cache[idx]
        else:
            pc = self._resample(load_point_cloud(self.files[idx]["path"]))
        return {"complete_pc": pc,
                "category": self.files[idx]["category"],
                "model_id": self.files[idx]["model_id"]}

    def as_array(self) -> np.ndarray:
        """The whole split as one (S, num_points, 3) float32 array."""
        self._build_cache()
        if self._cache is None:
            raise ValueError(f"empty {self.split} split at {self.data_dir}")
        return self._cache


class BatchLoader:
    """Shuffled fixed-shape batches over a ShapeNetDataset
    (dataset.py:289-383). The last short batch wraps around to the front
    of the epoch's order, and ``pad`` marks the wrapped rows so losses can
    leave them out; ``drop_last`` drops it instead.

    ``shard_groups`` G > 1 gives the shard-aligned plan of a row-sharded
    resident split: slot group g of every batch draws only rows of
    dataset group g, both split contiguously into G equal parts, each
    group permuted by the same RNG stream. Sizes that G does not divide
    get the plain permutation."""

    def __init__(self, dataset: ShapeNetDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, shard_groups: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.shard_groups = shard_groups
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """One epoch's batch plan: (indices (S, B) int32, pad (S, B) f32)."""
        n, bs = len(self.dataset), self.batch_size
        if self.shard_groups > 1 and n % self.shard_groups == 0 \
                and bs % self.shard_groups == 0:
            return self._grouped_epoch_indices(n, bs)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // bs) * bs if self.drop_last else n
        return self._plan([order], stop, bs)

    def _grouped_epoch_indices(self, n: int, bs: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Group g's slots [g*bs/G, (g+1)*bs/G) draw only rows
        [g*n/G, (g+1)*n/G); the tail batch wraps within each group
        (dataset.py:349-377)."""
        groups = self.shard_groups
        m, spg = n // groups, bs // groups  # rows, slots per group
        perms = [g * m + (self._rng.permutation(m) if self.shuffle
                          else np.arange(m)) for g in range(groups)]
        stop = (m // spg) * spg if self.drop_last else m
        return self._plan(perms, stop, spg)

    def _plan(self, orders, stop: int, step: int
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Batches of ``step`` rows from each order side by side, the
        short tail of each order wrapped around to its front (np.resize
        tiles, so an order shorter than a batch still fills it)."""
        if stop <= 0:
            return (np.zeros((0, self.batch_size), np.int32),
                    np.zeros((0, self.batch_size), np.float32))
        all_idx, all_pad = [], []
        for start in range(0, stop, step):
            chunks, pads = [], []
            for order in orders:
                idx = order[start:start + step]
                pad = np.zeros((len(idx),), np.float32)
                if len(idx) < step:
                    extra = np.resize(order, step - len(idx))
                    idx = np.concatenate([idx, extra])
                    pad = np.concatenate(
                        [pad, np.ones((len(extra),), np.float32)])
                chunks.append(idx)
                pads.append(pad)
            all_idx.append(np.concatenate(chunks))
            all_pad.append(np.concatenate(pads))
        return np.stack(all_idx).astype(np.int32), np.stack(all_pad)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        data = self.dataset.as_array()
        for idx, pad in zip(*self.epoch_indices()):
            yield {"complete_pc": data[idx], "pad": pad}


def create_dataloader(data_dir: str, split: str = "train",
                      batch_size: int = 32, num_points: int = 2048,
                      shuffle: Optional[bool] = None, seed: int = 0,
                      drop_last: bool = False,
                      **dataset_kwargs) -> BatchLoader:
    """The reference API's loader factory (dataset.py:386-402): a
    ShapeNetDataset and its BatchLoader, shuffled for the train split
    unless ``shuffle`` says otherwise."""
    ds = ShapeNetDataset(data_dir, split=split, num_points=num_points,
                         seed=seed, **dataset_kwargs)
    if shuffle is None:
        shuffle = split == "train"
    return BatchLoader(ds, batch_size, shuffle=shuffle, seed=seed,
                       drop_last=drop_last)


def setup_dataset(data_dir: str, synthetic: bool = False,
                  samples_per_category: int = 100,
                  num_points: int = 2048) -> None:
    """Write the synthetic dataset (the JAX package's generator, same seed,
    same files); real ShapeNet is downloaded by hand, and without
    ``synthetic`` this prints how."""
    if synthetic:
        create_synthetic_dataset(data_dir,
                                 samples_per_category=samples_per_category,
                                 num_points=num_points)
    else:
        print(
            "Real ShapeNet (latent_3d_points) requires manual download:\n"
            "  1. visit https://github.com/optas/latent_3d_points\n"
            "  2. follow their instructions for the ShapeNet subset\n"
            f"  3. extract under {data_dir} as <split>/<category>/*.ply\n"
            "Or pass synthetic=True for generated data.")
