"""Colored ASCII PLY export and the static results page
(gan_rl_3d_tpu/utils/ply.py), numpy only."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

COLOR_INCOMPLETE = (255, 100, 100)
COLOR_GROUND_TRUTH = (100, 255, 100)
COLOR_RECONSTRUCTED = (100, 100, 255)


def save_ply(path: str, points: np.ndarray,
             color: Tuple[int, int, int] = COLOR_RECONSTRUCTED) -> None:
    points = np.asarray(points, np.float32).reshape(-1, 3)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    r, g, b = color
    with open(p, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write("end_header\n")
        for x, y, z in points:
            f.write(f"{x:.6f} {y:.6f} {z:.6f} {r} {g} {b}\n")


def save_completion_sample(out_dir: str, index: int, category: str,
                           incomplete: np.ndarray, ground_truth: np.ndarray,
                           reconstructed: np.ndarray,
                           incomplete_mask: Optional[np.ndarray] = None
                           ) -> None:
    """The incomplete / ground-truth / reconstructed triple of one sample,
    named sample_01_lamp_ground_truth.ply and so on (ply.py:38-57); the
    incomplete cloud keeps only its valid points."""
    stem = f"sample_{index:02d}_{category}"
    if incomplete_mask is not None:
        incomplete = incomplete[np.asarray(incomplete_mask) > 0]
    save_ply(f"{out_dir}/{stem}_incomplete.ply", incomplete, COLOR_INCOMPLETE)
    save_ply(f"{out_dir}/{stem}_ground_truth.ply", ground_truth,
             COLOR_GROUND_TRUTH)
    save_ply(f"{out_dir}/{stem}_reconstructed.ply", reconstructed,
             COLOR_RECONSTRUCTED)


def write_results_html(path: str, stats: Dict[str, float],
                       samples: Sequence[str] = ()) -> None:
    """Static results report: the metric table and the exported samples
    (ply.py:60-86)."""
    rows = "\n".join(
        f"<tr><td>{k}</td><td>{v:.6g}</td></tr>" for k, v in stats.items())
    sample_list = "\n".join(f"<li><code>{s}</code></li>" for s in samples)
    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>RL-GAN-Net results</title>
<style>
body {{ font-family: sans-serif; margin: 2rem; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #999; padding: 0.4rem 0.8rem; }}
</style></head><body>
<h1>RL-GAN-Net — completion results</h1>
<table><tr><th>metric</th><th>value</th></tr>
{rows}
</table>
<h2>Exported point clouds</h2>
<ul>{sample_list}</ul>
<p>Colors: <span style="color:#ff6464">incomplete</span>,
<span style="color:#64ff64">ground truth</span>,
<span style="color:#6464ff">reconstructed</span>.</p>
</body></html>
"""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(html)
