"""Point-cloud transforms for training (gan_rl_3d_tpu/ops/pointcloud.py).

Hole cutting, augmentation and normalisation run on the device, batched,
inside the train step. The JAX package draws each transform's random
numbers from a key inside the transform; here the draws are split from
their use: ``draw_training_batch`` takes every random number of a batch
from a ``torch.Generator`` into a dict of tensors, and
``apply_training_batch`` is a pure function of the clouds and that dict.
A test can hand the port the numbers JAX drew.

Fixed shapes: "incomplete" clouds keep the full (N, 3) shape. The kept
points are sorted to the front, the tail repeats kept points cyclically,
and a validity mask marks the real points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

HOLE_METHODS = ("random", "sphere")


@dataclasses.dataclass(frozen=True)
class PreprocSpec:
    """Preprocessing knobs (pointcloud.py:28-55): ``rotation`` / ``jitter``
    / ``scale`` gate the augmentations (fired with probabilities 0.5 / 0.5
    / 0.3 when enabled); ``normalize`` is the master normalisation switch,
    ``center`` subtracts the (valid-point) centroid and ``unit_sphere``
    scales the max radius to 1; ``hole_min`` / ``hole_max`` bound the
    removed fraction."""

    rotation: bool = True
    jitter: bool = True
    scale: bool = True
    normalize: bool = True
    center: bool = True
    unit_sphere: bool = True
    hole_min: float = 0.2
    hole_max: float = 0.5


DEFAULT_PREPROC = PreprocSpec()


# ---------------------------------------------------------------------------
# Normalisation (pointcloud.py:66-107)
# ---------------------------------------------------------------------------


def _norm(x: Tensor) -> Tensor:
    """Euclidean norm over the last axis as jnp.linalg.norm forms it."""
    return torch.sqrt((x * x).sum(-1))


def _masked_centroid(pc: Tensor, mask: Optional[Tensor]) -> Tensor:
    if mask is None:
        return pc.mean(dim=-2, keepdim=True)
    w = mask[..., None]
    return (pc * w).sum(-2, keepdim=True) / torch.clamp(
        w.sum(-2, keepdim=True), min=1.0)


def _unit_scale(pc: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Scale so the max (valid-point) radius about the origin is 1."""
    norms = _norm(pc)
    if mask is not None:
        norms = norms * mask
    scale = norms.amax(dim=-1, keepdim=True)[..., None]
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.where(scale > 0, pc / safe, pc)


def normalize_unit_sphere(pc: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    return _unit_scale(pc - _masked_centroid(pc, mask), mask)


def apply_normalization(pc: Tensor, mask: Optional[Tensor] = None, *,
                        spec: PreprocSpec = DEFAULT_PREPROC) -> Tensor:
    if not spec.normalize:
        return pc
    if spec.center:
        pc = pc - _masked_centroid(pc, mask)
    if spec.unit_sphere:
        pc = _unit_scale(pc, mask)
    return pc


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------


def draw_training_batch(generator: torch.Generator, bsz: int, n: int, *,
                        spec: PreprocSpec = DEFAULT_PREPROC,
                        augment: bool = True,
                        methods: Sequence[str] = HOLE_METHODS,
                        input_points: Optional[int] = None
                        ) -> Dict[str, Tensor]:
    """Every random number one batch of ``make_training_batch`` uses, drawn
    from ``generator`` on its device, in this order:

    with ``input_points`` (PCN's input, drawn from an N-point target):
    ``subsample`` (B, N) U[0, 1), whose ``input_points`` lowest scores
    pick the input's rows; the hole draws below are then over those rows
    (N = ``input_points``), and nothing is drawn for augmentation;
    hole cutting (pointcloud.py:237-258): ``ratio`` (B,) U[hole_min,
    hole_max), ``method`` (B,) index into ``methods``, ``rand_scores``
    (B, N) U[0, 1), ``center`` (B,) index of the sphere centre, ``normal``
    (B, 3) standard normal (the plane's, normalised where used);
    augmentation (pointcloud.py:115-169), only with ``augment``:
    ``triggers`` (B, 3) U[0, 1) for rotate / jitter / scale, ``angles``
    (B, 3) U[0, 2 pi) Euler angles, ``jitter`` (B, N, 3) standard normal,
    ``scale`` (B,) U[0.8, 1.2)."""
    _check_ratios(spec.hole_min, spec.hole_max)
    kw = dict(generator=generator, device=generator.device)

    def uniform(*shape):
        return torch.rand(shape, **kw)

    draws = {}
    if input_points is not None:
        if not 1 <= input_points <= n:
            raise ValueError(f"input_points must lie in [1, {n}], got "
                             f"{input_points}")
        draws["subsample"] = uniform(bsz, n)
        n, augment = input_points, False
    draws.update({
        "ratio": spec.hole_min + (spec.hole_max - spec.hole_min)
        * uniform(bsz),
        "method": torch.randint(0, len(methods), (bsz,), **kw),
        "rand_scores": uniform(bsz, n),
        "center": torch.randint(0, n, (bsz,), **kw),
        "normal": torch.randn((bsz, 3), **kw),
    })
    if augment:
        draws.update(triggers=uniform(bsz, 3),
                     angles=(2.0 * math.pi) * uniform(bsz, 3),
                     jitter=torch.randn((bsz, n, 3), **kw),
                     scale=0.8 + 0.4 * uniform(bsz))
    return draws


# ---------------------------------------------------------------------------
# Augmentation (pointcloud.py:115-169)
# ---------------------------------------------------------------------------


def rotation_matrices(theta: Tensor) -> Tensor:
    """Euler angles (..., 3) -> Rz @ Ry @ Rx (..., 3, 3)."""
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(theta[..., 0]), torch.zeros_like(theta[..., 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cx, cy, cz = c.unbind(-1)
    sx, sy, sz = s.unbind(-1)
    rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return rz @ ry @ rx


def rotate(pc: Tensor, rotation: Tensor) -> Tensor:
    """pc (B, N, 3) @ R^T per cloud."""
    return torch.einsum("bnc,bdc->bnd", pc, rotation)


def augment(pc: Tensor, draws: Dict[str, Tensor], *,
            spec: PreprocSpec = DEFAULT_PREPROC) -> Tensor:
    """Rotate / jitter (sigma 0.01, clipped at 0.05) / scale each cloud
    when its trigger fires and the spec enables the transform."""
    trig = draws["triggers"]
    p = (0.5 if spec.rotation else 0.0, 0.5 if spec.jitter else 0.0,
         0.3 if spec.scale else 0.0)
    fire = [(trig[:, k] < p[k])[:, None, None] for k in range(3)]
    pc = torch.where(fire[0], rotate(pc, rotation_matrices(draws["angles"])),
                     pc)
    noise = torch.clamp(0.01 * draws["jitter"], -0.05, 0.05)
    pc = torch.where(fire[1], pc + noise, pc)
    return torch.where(fire[2], pc * draws["scale"][:, None, None], pc)


# ---------------------------------------------------------------------------
# Hole cutting with fixed output shapes (pointcloud.py:178-260)
# ---------------------------------------------------------------------------


def _check_ratios(min_ratio: float, max_ratio: float) -> None:
    if not 0.0 <= min_ratio <= max_ratio <= 0.95:
        raise ValueError(f"hole ratios must satisfy 0 <= min <= max <= 0.95, "
                         f"got ({min_ratio}, {max_ratio})")


def fill_passes_for(n: int, max_ratio: float) -> int:
    """Cyclic-fill passes that cover every slot at the smallest keep count
    floor(n (1 - max_ratio)) (pointcloud.py:229-236)."""
    n_keep_min = max(1, int(math.floor(n * (1.0 - max_ratio))))
    return int(math.ceil(n / n_keep_min)) - 1 or 1


def _keep_reorder(pc: Tensor, score: Tensor, n_keep: Tensor,
                  fill_passes: int) -> Tuple[Tensor, Tensor]:
    """Keep the n_keep lowest-score points of each cloud, sorted to the
    front (a stable sort, as lax.sort is); pass p of the tail fill makes
    slots i < (p + 1) n_keep equal sorted[i mod n_keep]. On the TPU this
    was a sort carrying the coordinates as payload; here a stable sort and
    a gather."""
    n = pc.shape[1]
    order = torch.sort(score, dim=-1, stable=True).indices
    sorted_pc = pc.gather(1, order[..., None].expand(-1, -1, 3))
    ranks = torch.arange(n, device=pc.device)[None, :]
    keep = ranks < n_keep[:, None]
    rolled = ((ranks - n_keep[:, None]) % n)[..., None].expand(-1, -1, 3)
    out = sorted_pc
    for _ in range(max(1, fill_passes)):
        out = torch.where(keep[..., None], sorted_pc, out.gather(1, rolled))
    return out, keep.to(pc.dtype)


def cut_holes(pc: Tensor, draws: Dict[str, Tensor], *,
              min_ratio: float = 0.2, max_ratio: float = 0.5,
              methods: Sequence[str] = HOLE_METHODS
              ) -> Tuple[Tensor, Tensor]:
    """Remove a drawn fraction of each (N, 3) cloud of ``pc`` (B, N, 3) by
    the drawn method: "random" drops uniform points, "sphere" the ball
    around a point, "plane" one side of a plane through the centroid.
    Returns (clouds (B, N, 3), masks (B, N))."""
    _check_ratios(min_ratio, max_ratio)
    bsz, n, _ = pc.shape
    n_keep = torch.floor(n * (1.0 - draws["ratio"])).to(torch.int64)
    scores = []
    for m in methods:
        if m == "random":
            scores.append(draws["rand_scores"])
        elif m == "sphere":
            centre = pc.gather(1, draws["center"].long()[:, None, None]
                               .expand(-1, 1, 3))
            scores.append(-_norm(pc - centre))  # keep the farthest points
        elif m == "plane":
            normal = draws["normal"]
            normal = normal / (_norm(normal)[:, None] + 1e-12)
            signed = torch.matmul(pc - pc.mean(dim=1, keepdim=True),
                                  normal[:, :, None])[..., 0]
            scores.append(-signed)
        else:
            raise ValueError(f"unknown hole method {m!r}")
    score = torch.stack(scores, dim=1)[torch.arange(bsz, device=pc.device),
                                       draws["method"].long()]
    return _keep_reorder(pc, score, n_keep, fill_passes_for(n, max_ratio))


def input_rows(complete: Tensor, draws: Dict[str, Tensor]) -> Tensor:
    """The rows the encoder sees of a whole cloud: with a ``subsample``
    (PCN's input) the ``input_points`` rows it picks, in a stable sort of
    its scores, before any hole is cut; otherwise ``complete`` itself.
    The clean GFV of a cloud encodes these rows."""
    if "subsample" not in draws:
        return complete
    rows = torch.sort(draws["subsample"], dim=-1, stable=True).indices[
        :, :draws["rand_scores"].shape[1]]
    return complete.gather(1, rows[..., None].expand(-1, -1, 3))


def apply_training_batch(complete: Tensor, draws: Dict[str, Tensor], *,
                         spec: PreprocSpec = DEFAULT_PREPROC,
                         do_augment: bool = True,
                         methods: Sequence[str] = HOLE_METHODS
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Cut holes, augment the complete and the incomplete cloud with the
    same draws (one augmentation key, pointcloud.py:286-290: the same
    triggers, rotation, jitter noise and scale), normalise per ``spec``.
    Draws with a ``subsample`` (PCN's input) cut the holes from the
    subsampled rows, in a stable sort of its scores, and leave both clouds
    in the complete cloud's frame: no augmentation, no normalisation.
    Returns (complete, incomplete, incomplete_mask)."""
    if "subsample" in draws:
        incomplete, mask = cut_holes(input_rows(complete, draws), draws,
                                     min_ratio=spec.hole_min,
                                     max_ratio=spec.hole_max, methods=methods)
        return complete, incomplete, mask
    incomplete, mask = cut_holes(complete, draws, min_ratio=spec.hole_min,
                                 max_ratio=spec.hole_max, methods=methods)
    if do_augment:
        complete = augment(complete, draws, spec=spec)
        incomplete = augment(incomplete, draws, spec=spec)
    complete = apply_normalization(complete, spec=spec)
    incomplete = apply_normalization(incomplete, mask, spec=spec)
    return complete, incomplete, mask


def make_training_batch(generator: torch.Generator, complete: Tensor, *,
                        spec: PreprocSpec = DEFAULT_PREPROC,
                        do_augment: bool = True,
                        input_points: Optional[int] = None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Draw from ``generator`` and apply: complete (B, N, 3) ->
    (complete, incomplete, incomplete_mask); with ``input_points`` the
    incomplete cloud is cut from that many rows of each (PCN's input)."""
    draws = draw_training_batch(generator, complete.shape[0],
                                complete.shape[1], spec=spec,
                                augment=do_augment, input_points=input_points)
    return apply_training_batch(complete, draws, spec=spec,
                                do_augment=do_augment)


def make_training_pair(generator: torch.Generator, complete: Tensor, *,
                       spec: PreprocSpec = DEFAULT_PREPROC,
                       do_augment: bool = True
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """One (N, 3) cloud -> (complete, incomplete, incomplete_mask)."""
    out = make_training_batch(generator, complete[None], spec=spec,
                              do_augment=do_augment)
    return tuple(x[0] for x in out)
