"""Alternate h5/synthetic dataset (gan_rl_3d_tpu/data/simple_dataset.py),
draw for draw: the same seed gives the same samples.

Serves ``{split}.h5`` files (key ``point_clouds``) or generates synthetic
sphere/cube/cylinder surfaces, and yields samples with the keys the RL
environment historically expected (``complete`` / ``incomplete`` /
``mask``). Incomplete clouds keep a fixed (N, 3) shape by the pad-by-repeat
convention, the mask marking the kept points.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from gan_rl_3d_tpu_torch.data.dataset import resample_with_mask


def _synthetic_cloud(rng: np.random.RandomState, shape_type: str,
                     num_points: int) -> np.ndarray:
    if shape_type == "sphere":
        theta = rng.rand(num_points) * 2 * np.pi
        phi = np.arccos(1 - 2 * rng.rand(num_points))
        pc = np.stack([np.sin(phi) * np.cos(theta),
                       np.sin(phi) * np.sin(theta),
                       np.cos(phi)], axis=1)
    elif shape_type == "cube":
        pc = rng.rand(num_points, 3) * 2 - 1
        pc = pc / np.abs(pc).max(axis=1, keepdims=True)
    else:  # cylinder
        theta = rng.rand(num_points) * 2 * np.pi
        pc = np.stack([np.cos(theta), np.sin(theta),
                       rng.rand(num_points) * 2 - 1], axis=1)
    return (pc + rng.randn(num_points, 3) * 0.02).astype(np.float32)


class PointCloudDataset:
    """h5-or-synthetic dataset of complete/incomplete/mask triples."""

    def __init__(self, data_path: str, split: str = "train",
                 num_points: int = 2048, augment: bool = True,
                 missing_ratio: float = 0.5, seed: int = 0,
                 n_synthetic: int = 1000):
        self.split = split
        self.num_points = num_points
        self.augment = augment
        self.missing_ratio = missing_ratio
        self._rng = np.random.RandomState(seed)

        h5_file = os.path.join(data_path, f"{split}.h5")
        if os.path.exists(h5_file):
            import h5py

            with h5py.File(h5_file, "r") as f:
                self.data = np.asarray(f["point_clouds"], np.float32)
        else:
            n = n_synthetic if split == "train" else n_synthetic // 5
            self.data = np.stack([
                _synthetic_cloud(self._rng,
                                 ["sphere", "cube", "cylinder"][i % 3],
                                 num_points)
                for i in range(n)])

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        pc = self.data[idx]
        n = self.num_points
        if len(pc) != n:
            pc, _ = resample_with_mask(pc, n, self._rng)
        # normalise to the unit sphere
        pc = pc - pc.mean(axis=0)
        scale = np.linalg.norm(pc, axis=1).max()
        if scale > 0:
            pc = pc / scale
        # cut a hole: drop missing_ratio points, move kept to the front,
        # repeat-pad the tail (fixed shapes + mask)
        n_keep = max(int(n * (1 - self.missing_ratio)), 1)
        keep = self._rng.choice(n, n_keep, replace=False)
        incomplete = np.concatenate(
            [pc[keep], pc[keep[self._rng.randint(0, n_keep, n - n_keep)]]])
        mask = np.zeros(n, np.float32)
        mask[:n_keep] = 1.0
        return {"complete": pc.astype(np.float32),
                "incomplete": incomplete.astype(np.float32),
                "mask": mask}


def collate_fn(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of samples (all fixed-shape already)."""
    return {k: np.stack([item[k] for item in batch]) for k in batch[0]}
