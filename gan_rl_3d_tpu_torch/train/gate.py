"""The hybrid gate's calibration (gan_rl_3d_tpu/train/gate.py).

The gate routes a sample to the GAN path when D(clean GFV) > D(noisy
GFV) + bias. ``gate_statistics`` collects, per validation sample, the
Chamfer distance of both paths (K3 on the card) and the D-score margin;
``calibrate_gate`` sweeps the threshold over them (the two degenerate
thresholds trust one path outright) and returns the val-Chamfer-minimising
(gate_mode, gate_bias); ``save_gate_calibration`` writes it as
``gate_calibration.json`` beside the checkpoints, scoped to the
checkpoints it was measured for, and ``load_gate_calibration`` is the
serving side's read. The sweep is the JAX package's numpy float64 code,
copied, so both give the same report on the same statistics.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.ops import chamfer
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.parallel import collectives
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib

GATE_FILE = "gate_calibration.json"
STAT_KEYS = ("cd_rl", "cd_ae", "margin")


@torch.no_grad()
def gate_stats_step(model: dict, batch: Dict[str, torch.Tensor],
                    draws: Dict[str, torch.Tensor], *, cfg: rl.TD3Config,
                    spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                    bidirectional: bool = True,
                    mesh: Optional[mesh_lib.Mesh] = None
                    ) -> Dict[str, torch.Tensor]:
    """Per-sample gate inputs of one batch, holes from ``draws``, no
    augmentation (gate.py:39-57): the Chamfer distance of the GAN path and
    of the AE path against the complete cloud, and the margin D(clean) -
    D(noisy) the gate thresholds. Under ``mesh`` the batch is this rank's
    rows, ``draws`` the global batch's, and the statistics come back
    gathered whole, so every rank calibrates the same gate."""
    with mesh_lib.use(mesh):
        mesh = mesh_lib.active()
        complete, incomplete, mask = pc_ops.apply_training_batch(
            batch["complete_pc"],
            {k: mesh_lib.local_rows(mesh, v) for k, v in draws.items()},
            spec=spec, do_augment=False)
        out = net.complete(model, incomplete, mask, cfg=cfg,
                           gate_mode="discriminator")
        stats = {
            "cd_rl": chamfer.chamfer_distance(out["completed_pc"], complete,
                                              bidirectional=bidirectional),
            "cd_ae": chamfer.chamfer_distance(out["ae_reconstruction"],
                                              complete,
                                              bidirectional=bidirectional),
            "margin": (out["rl_gan_score"] - out["ae_score"]).reshape(-1),
            "pad": batch["pad"]}
        return {k: collectives.gather_rows(v, mesh)
                for k, v in stats.items()}


def gate_statistics(model: dict, batches: Iterable[Dict[str, np.ndarray]],
                    draw_fn: Callable[[int, int, int], Dict[str, torch.Tensor]],
                    *, cfg: rl.TD3Config, device: torch.device,
                    spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                    bidirectional: bool = True,
                    mesh: Optional[mesh_lib.Mesh] = None
                    ) -> Dict[str, np.ndarray]:
    """``gate_stats_step`` over a split (gate.py:60-76): batch i's holes
    are ``draw_fn(i, batch size, points)`` (fixed per batch), and the
    padded rows are dropped. Returns host arrays; under ``mesh`` each rank
    runs its rows and every rank returns the whole split's."""
    cols: Dict[str, list] = {name: [] for name in STAT_KEYS}
    for i, batch in enumerate(batches):
        n_points = batch["complete_pc"].shape[1]
        local = mesh_lib.shard_batch(mesh, batch)
        m = gate_stats_step(
            model, {k: v.to(device) for k, v in local.items()},
            draw_fn(i, len(batch["pad"]), n_points), cfg=cfg, spec=spec,
            bidirectional=bidirectional, mesh=mesh)
        keep = np.asarray(batch["pad"]) == 0
        for name in cols:
            cols[name].append(m[name].cpu().numpy()[keep])
    return {name: np.concatenate(vals) for name, vals in cols.items()}


def calibrate_gate(stats: Dict[str, np.ndarray],
                   max_candidates: int = 256) -> Dict[str, object]:
    """The Chamfer-minimising gate from ``gate_statistics`` (gate.py:79-134).

    Sweeps the threshold t (GAN path when margin > t) over the midpoints
    of the sorted margins, one below and one above them all, at most
    ``max_candidates`` quantile points of those; a threshold below every
    margin is gate_mode "rl", above every margin "ae" (bias 0 for both),
    otherwise "discriminator" with bias t."""
    cd_rl = stats["cd_rl"].astype(np.float64)
    cd_ae = stats["cd_ae"].astype(np.float64)
    margin = stats["margin"].astype(np.float64)
    n = len(margin)
    if n == 0:
        raise ValueError(
            "calibrate_gate: no validation samples (every row padded or "
            "empty loader) — cannot sweep the gate threshold")
    order = np.argsort(margin)
    sorted_margin = margin[order]
    mids = (sorted_margin[1:] + sorted_margin[:-1]) / 2.0
    lo = sorted_margin[0] - 1.0
    hi = sorted_margin[-1] + 1.0
    cands = np.concatenate([[lo], mids, [hi]])
    if len(cands) > max_candidates:
        idx = np.linspace(0, len(cands) - 1, max_candidates).astype(int)
        cands = cands[idx]
        cands = np.concatenate([[lo], cands, [hi]])
    means = np.array([
        np.mean(np.where(margin > t, cd_rl, cd_ae)) for t in cands])
    best_i = int(np.argmin(means))
    best_t = float(cands[best_i])
    best_cd = float(means[best_i])
    if best_t <= sorted_margin[0] - 0.5:
        mode, bias = "rl", 0.0
    elif best_t >= sorted_margin[-1] + 0.5:
        mode, bias = "ae", 0.0
    else:
        mode, bias = "discriminator", best_t
    return {
        "gate_mode": mode,
        "gate_bias": bias,
        "val_chamfer_calibrated": best_cd,
        "val_chamfer_raw_gate": float(
            np.mean(np.where(margin > 0.0, cd_rl, cd_ae))),
        "val_chamfer_rl": float(np.mean(cd_rl)),
        "val_chamfer_ae": float(np.mean(cd_ae)),
        "oracle_chamfer": float(np.mean(np.minimum(cd_rl, cd_ae))),
        "n_samples": int(n),
        "rl_route_fraction": float(np.mean(margin > best_t)),
    }


def save_gate_calibration(checkpoint_dir: str,
                          report: Dict[str, object]) -> Path:
    """Write ``report`` as ``<checkpoint_dir>/gate_calibration.json``
    (gate.py:137-143)."""
    path = Path(checkpoint_dir) / GATE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path


def descope_gate_calibration(checkpoint_dir: str, name: str) -> None:
    """Take ``name`` out of a sidecar's checkpoint scope, deleting the
    sidecar when none is left (gate.py:146-170). The trainer calls it
    before it overwrites a checkpoint without calibrating in the same run:
    the bias was measured against another discriminator."""
    path = Path(checkpoint_dir) / GATE_FILE
    if not path.exists():
        return
    try:
        with open(path) as f:
            report = json.load(f)
        applies_to = report.get("checkpoints")
        if applies_to is None or name not in applies_to:
            return
        applies_to = [c for c in applies_to if c != name]
        if applies_to:
            report["checkpoints"] = applies_to
            with open(path, "w") as f:
                json.dump(report, f, indent=2)
        else:
            path.unlink()
        print(f"gate calibration sidecar descoped from {name!r} "
              f"(checkpoint overwritten without re-calibration)")
    except (OSError, ValueError, TypeError):
        return


def load_gate_calibration(checkpoint_dir: str, *,
                          checkpoint: str | None = None,
                          default_mode: str = "discriminator",
                          default_bias: float = 0.0,
                          verbose: bool = False) -> Tuple[str, float]:
    """The calibrated (gate_mode, gate_bias) when a sidecar exists and
    applies to ``checkpoint``, otherwise the defaults (gate.py:172-208). A
    sidecar records the checkpoints it was measured for;
    ``checkpoint=None`` (engine serving, source unknown) and sidecars
    without that field always apply."""
    path = Path(checkpoint_dir) / GATE_FILE
    if not path.exists():
        return default_mode, default_bias
    try:
        with open(path) as f:
            report = json.load(f)
        applies_to = report.get("checkpoints")
        if (applies_to is not None and checkpoint is not None
                and checkpoint not in applies_to):
            if verbose:
                print(f"gate calibration sidecar present but scoped to "
                      f"{applies_to} — checkpoint {checkpoint!r} uses "
                      f"config defaults (mode={default_mode}, "
                      f"bias={default_bias:.4f})")
            return default_mode, default_bias
        return (str(report.get("gate_mode", default_mode)),
                float(report.get("gate_bias", default_bias)))
    except (OSError, ValueError, TypeError):
        return default_mode, default_bias
