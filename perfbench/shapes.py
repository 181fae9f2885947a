"""Seeded synthetic point clouds, made on the device in bulk.

The eight categories of the repository's synthetic ShapeNet stand-in
(``data/synthetic.py``: category-shaped Gaussian blobs, a lamp's pole and
shade, a cabinet's box), rewritten as batched torch so that a split of
thousands of clouds is made in a few launches. Cloud ``i`` is of category
``i % 8``. Each cloud is normalised to the unit sphere (centroid at the
origin, largest radius 1), as the training data and served scans are.
"""

import math

import torch

Tensor = torch.Tensor
CATEGORIES = ("airplane", "car", "chair", "lamp", "sofa", "table",
              "watercraft", "cabinet")


def _blob(g, k: int, n: int, scale, shift=(0.0, 0.0, 0.0)) -> Tensor:
    kw = dict(generator=g, device=g.device)
    return (torch.randn((k, n, 3), **kw)
            * torch.tensor(scale, device=g.device)
            + torch.tensor(shift, device=g.device))


def _category(g, name: str, k: int, n: int) -> Tensor:
    h = n // 2
    kw = dict(generator=g, device=g.device)
    if name == "airplane":
        return torch.cat([_blob(g, k, h, (2.0, 0.3, 0.3)),
                          _blob(g, k, n - h, (0.5, 2.0, 0.1), (0.5, 0, 0))], 1)
    if name == "car":
        return _blob(g, k, n, (2.0, 1.0, 0.8))
    if name == "chair":
        return torch.cat([_blob(g, k, h, (1.0, 1.0, 0.1)),
                          _blob(g, k, n - h, (1.0, 0.1, 1.0), (0, 0.5, 0))], 1)
    if name == "lamp":
        pole = torch.randn((k, h, 3), **kw) * 0.05
        pole[..., 2] = 2.0 * torch.rand((k, h), **kw) - 1.0
        theta = 2.0 * math.pi * torch.rand((k, n - h), **kw)
        r = 0.4 + 0.2 * torch.rand((k, n - h), **kw)
        shade = torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                             0.8 + 0.2 * torch.rand((k, n - h), **kw)], -1)
        return torch.cat([pole, shade], 1)
    if name == "sofa":
        return _blob(g, k, n, (1.5, 0.8, 0.6))
    if name == "table":
        return torch.cat([_blob(g, k, h, (1.2, 1.2, 0.05), (0, 0, 0.5)),
                          _blob(g, k, n - h, (0.8, 0.8, 0.5))], 1)
    if name == "watercraft":
        return _blob(g, k, n, (2.5, 0.6, 0.4))
    return (torch.rand((k, n, 3), **kw) * 2.0 - 1.0) \
        * torch.tensor((0.8, 0.5, 1.0), device=g.device)


def clouds(g: torch.Generator, count: int, n: int) -> Tensor:
    """(count, n, 3) float32 clouds on ``g``'s device."""
    out = torch.empty((count, n, 3), device=g.device)
    for c, name in enumerate(CATEGORIES):
        k = len(range(c, count, len(CATEGORIES)))
        if k:
            out[c::len(CATEGORIES)] = _category(g, name, k, n)
    out -= out.mean(dim=1, keepdim=True)
    out /= out.norm(dim=-1).amax(dim=1)[:, None, None]
    return out


def partial_scans(g: torch.Generator, complete: Tensor, hole_min: float,
                  hole_max: float):
    """Served inputs: from each cloud a hole removes a share drawn from
    [hole_min, hole_max) - the points nearest a random point of the cloud,
    or, for every other cloud, points at random - and the rows it leaves
    are repeat-padded back to N from random kept points with mask 0, as
    the data loader's resample_with_mask pads a short scan. Returns
    (clouds (B, N, 3), mask (B, N))."""
    bsz, n, _ = complete.shape
    kw = dict(generator=g, device=g.device)
    ratio = hole_min + (hole_max - hole_min) * torch.rand(bsz, **kw)
    keep = torch.floor(n * (1.0 - ratio)).long()
    centre = complete[torch.arange(bsz, device=g.device),
                      torch.randint(0, n, (bsz,), **kw)][:, None]
    far = (complete - centre).norm(dim=-1)
    score = torch.where(torch.arange(bsz, device=g.device)[:, None] % 2 == 0,
                        -far, torch.rand((bsz, n), **kw))
    kept = torch.sort(score, dim=1).indices
    slot = torch.arange(n, device=g.device)[None]
    pick = (torch.rand((bsz, n), **kw) * keep[:, None]).long()
    src = kept.gather(1, torch.where(slot < keep[:, None], slot, pick))
    pc = complete.gather(1, src[..., None].expand(-1, -1, 3))
    return pc.contiguous(), (slot < keep[:, None]).float()
