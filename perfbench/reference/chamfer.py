"""Chamfer distance: unsquared Euclidean distance from each point to its
nearest neighbour in the other cloud, averaged per cloud, both ways."""

import torch

Tensor = torch.Tensor


@torch.no_grad()
def nearest_index(a: Tensor, b: Tensor, block: int = 16) -> Tensor:
    """Index into ``b`` (B, M, 3) of the nearest point of each point of
    ``a`` (B, N, 3), the first among equal distances. Squared distances in
    float64, so that rounding picks no other neighbour than the exact
    arithmetic would, short of a tie closer than float64 resolves."""
    out = []
    for i in range(0, a.shape[0], block):
        a64, b64 = a[i:i + block].double(), b[i:i + block].double()
        d2 = ((a64 * a64).sum(-1)[:, :, None] + (b64 * b64).sum(-1)[:, None]
              - 2.0 * torch.bmm(a64, b64.transpose(1, 2)))
        out.append(d2.argmin(dim=-1))
    return torch.cat(out)


def nearest_dist(a: Tensor, b: Tensor) -> Tensor:
    """(B, N) distances to the nearest neighbour, differentiable through
    the selected neighbour; clamped at 1e-12 before the square root."""
    idx = nearest_index(a, b)
    near = torch.gather(b, 1, idx[..., None].expand(-1, -1, 3))
    return torch.sqrt(torch.clamp((a - near).square().sum(-1), min=1e-12))


def chamfer(a: Tensor, b: Tensor) -> Tensor:
    """Per-cloud bidirectional Chamfer distance (B,)."""
    return (nearest_dist(a, b).mean(dim=1) + nearest_dist(b, a).mean(dim=1)) \
        / 2.0
