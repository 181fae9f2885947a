"""Synthetic ShapeNet-like data generator, a copy of
gan_rl_3d_tpu/data/synthetic.py: the same seed writes the same files.

Mirrors the reference's synthetic fixture (utils/dataset.py:307-390): 8
categories, category-shaped Gaussian blobs, written as
``{split}/{category}/{category}_{i:04d}.txt`` files of (2048, 3) clouds —
the same on-disk layout, so either implementation can consume the other's
synthetic data. Extra shapes (sphere/cube/cylinder surfaces from
utils/data_utils.py:269-307) are included for richer smoke data.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

CATEGORIES = ("airplane", "car", "chair", "lamp", "sofa", "table",
              "watercraft", "cabinet")


def generate_synthetic_cloud(category: str, num_points: int = 2048,
                             rng: Optional[np.random.RandomState] = None
                             ) -> np.ndarray:
    """One synthetic (num_points, 3) cloud shaped per category."""
    rng = rng or np.random.RandomState()
    if category == "airplane":
        body = rng.randn(num_points // 2, 3) * [2.0, 0.3, 0.3]
        wings = rng.randn(num_points - num_points // 2, 3) * [0.5, 2.0, 0.1]
        wings[:, 0] += 0.5
        pc = np.concatenate([body, wings])
    elif category == "car":
        pc = rng.randn(num_points, 3) * [2.0, 1.0, 0.8]
    elif category == "chair":
        seat = rng.randn(num_points // 2, 3) * [1.0, 1.0, 0.1]
        back = rng.randn(num_points - num_points // 2, 3) * [1.0, 0.1, 1.0]
        back[:, 1] += 0.5
        pc = np.concatenate([seat, back])
    elif category == "lamp":
        # pole + shade: surface-like structure exercises hole-cutting better
        t = rng.rand(num_points // 2)
        pole = np.stack([0.05 * rng.randn(num_points // 2),
                         0.05 * rng.randn(num_points // 2),
                         2.0 * t - 1.0], axis=1)
        theta = rng.rand(num_points - num_points // 2) * 2 * np.pi
        r = 0.4 + 0.2 * rng.rand(num_points - num_points // 2)
        shade = np.stack([r * np.cos(theta), r * np.sin(theta),
                          0.8 + 0.2 * rng.rand(len(theta))], axis=1)
        pc = np.concatenate([pole, shade])
    elif category == "sofa":
        pc = rng.randn(num_points, 3) * [1.5, 0.8, 0.6]
    elif category == "table":
        top = rng.randn(num_points // 2, 3) * [1.2, 1.2, 0.05]
        top[:, 2] += 0.5
        legs = rng.randn(num_points - num_points // 2, 3) * [0.8, 0.8, 0.5]
        pc = np.concatenate([top, legs])
    elif category == "watercraft":
        pc = rng.randn(num_points, 3) * [2.5, 0.6, 0.4]
    elif category == "cabinet":
        pc = (rng.rand(num_points, 3) * 2.0 - 1.0) * [0.8, 0.5, 1.0]
    else:
        pc = rng.randn(num_points, 3)
    if len(pc) > num_points:
        pc = pc[rng.choice(len(pc), num_points, replace=False)]
    return pc.astype(np.float32)


def create_synthetic_dataset(
    data_dir: str,
    samples_per_category: int = 100,
    num_points: int = 2048,
    seed: int = 0,
    categories=CATEGORIES,
) -> None:
    """Write the synthetic dataset tree (train: N, test/val: N//4 each,
    matching reference utils/dataset.py:335-359)."""
    rng = np.random.RandomState(seed)
    root = Path(data_dir)
    for split in ("train", "test", "val"):
        n = samples_per_category if split == "train" else max(
            samples_per_category // 4, 1)
        for category in categories:
            cat_dir = root / split / category
            cat_dir.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                pc = generate_synthetic_cloud(category, num_points, rng)
                # the bytes np.savetxt(fmt="%.6f") writes, one format call
                # a file instead of one a row
                rows = "%.6f %.6f %.6f\n" * len(pc)
                (cat_dir / f"{category}_{i:04d}.txt").write_text(
                    rows % tuple(pc.ravel().tolist()))
