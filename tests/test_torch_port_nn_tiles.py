"""K3/K2's register-tiled design on the CPU.

The kernel (csrc/nn_dist.cu) reduces each sub-tile of C distances with a
NaN-dropping min, compares that once with the running best by a strict <,
and after the scan goes back to the sub-tile where the best last dropped
to find the first index whose distance equals it. ``tiled_scan`` mirrors
that in torch on a given distance matrix; it is held to a scan of j in
increasing order with a strict < (ties, NaN, infinities, signed zeros) and
to the plain K3 bit for bit on clouds with exact duplicates across the
sub-tile and tile boundaries. Then: first-copy ties of the plain K3
against the JAX package's Pallas kernel (interpret mode), K2's plain
distances against K3's, a mask of ones, the CPU wrappers, and the
geometry card_checks.nn_geometry reads from the source."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import card_checks
from gan_rl_3d_tpu.ops import chamfer as jchamfer
from gan_rl_3d_tpu_torch.ops import chamfer


def _geometry():
    src = (Path(chamfer.__file__).resolve().parent.parent / "csrc"
           / "nn_dist.cu").read_text()
    return {k: int(re.search(rf"constexpr int k{k} = (\d+);", src).group(1))
            for k in ("Threads", "R", "C", "TileM")}


GEOMETRY = _geometry()
SUB, TILE = GEOMETRY["C"], GEOMETRY["TileM"]


def tiled_scan(d2):
    """(best d2, first argmin) of d2 (B, N, M) as the kernel finds them:
    tiles of TILE points padded to whole sub-tiles with +inf, a sub-tile's
    SUB values reduced by fmin (which drops a NaN), one strict < against
    the running best, and the first equal index of the sub-tile where the
    best last dropped (0 where it never dropped)."""
    m = d2.shape[-1]
    best = torch.full(d2.shape[:-1], float("inf"))
    sub = torch.full(d2.shape[:-1], -1, dtype=torch.long)
    for j0 in range(0, m, TILE):
        count = min(TILE, m - j0)
        padded = -(-count // SUB) * SUB
        tile = torch.full(d2.shape[:-1] + (padded,), float("inf"))
        tile[..., :count] = d2[..., j0:j0 + count]
        for c0 in range(0, padded, SUB):
            mn = tile[..., c0]
            for c in range(1, SUB):
                mn = torch.fmin(mn, tile[..., c0 + c])
            sub = torch.where(mn < best, j0 + c0, sub)
            best = torch.fmin(best, mn)
    arg = torch.zeros_like(sub)
    found = sub < 0
    for c in range(SUB):
        j = (sub + c).clamp(0, m - 1)
        hit = ~found & (sub + c < m) & (d2.gather(-1, j[..., None])[..., 0]
                                         == best)
        arg = torch.where(hit, j, arg)
        found |= hit
    return best, arg.to(torch.int32)


def strict_scan(d2):
    """A scan of j in increasing order that keeps d2[j] where d2[j] < best:
    the first index among equal minima, as jnp.argmin and the TPU kernel's
    tile carry return."""
    best = torch.full(d2.shape[:-1], float("inf"))
    arg = torch.zeros(d2.shape[:-1], dtype=torch.int32)
    for j in range(d2.shape[-1]):
        better = d2[..., j] < best
        best = torch.where(better, d2[..., j], best)
        arg = torch.where(better, torch.tensor(j, dtype=torch.int32), arg)
    return best, arg


def _dist(best):
    return torch.sqrt(torch.clamp(best, min=1e-12))


def _clouds(seed, bsz, n, m):
    rng = np.random.RandomState(seed)
    a = rng.rand(bsz, n, 3).astype(np.float32)
    b = rng.rand(bsz, m, 3).astype(np.float32)
    return a, b


def _ties(a, b, pairs):
    """b[j'] = b[j] for each (j, j') of ``pairs``, and query point 2 t of a
    on pair t's point; returns the query indices."""
    queries = [min(2 * t, a.shape[1] - 1) for t in range(len(pairs))]
    for q, (j, dup) in zip(queries, pairs):
        b[:, dup] = b[:, j]
        a[:, q] = b[:, j]
    return queries


@pytest.mark.parametrize("m", [1, 7, 8, 9, 63, 2 * TILE + 5])
@pytest.mark.parametrize("values", ["ties", "nan_inf_zeros"])
def test_tiled_scan_equals_a_strict_scan(m, values):
    """Distances drawn from a few values, so that most minima are tied
    across sub-tiles and tiles; with NaN, +inf, -0 and +0 among them the
    index is still the strict scan's and the clamped distance its bits."""
    rng = np.random.RandomState(m)
    pool = np.array([3.0, 1.5, 0.25, 2.0, 0.25], np.float32)
    if values == "nan_inf_zeros":
        pool = np.array([np.nan, np.inf, -0.0, 0.0, 0.5, np.nan], np.float32)
    d2 = torch.from_numpy(pool[rng.randint(0, len(pool), (3, 17, m))])
    d2[0, 0] = float("nan")  # a row of NaN: no drop, index 0
    d2[0, 1] = float("inf")
    best, arg = tiled_scan(d2)
    ref_best, ref_arg = strict_scan(d2)
    assert torch.equal(arg, ref_arg)
    assert torch.equal(_dist(best), _dist(ref_best))
    assert int(arg[0, 0]) == 0 and int(arg[0, 1]) == 0


@pytest.mark.parametrize("n,m", [(1, 1), (7, 300), (60, 7 * TILE + 40),
                                 (33, TILE + 1)])
@pytest.mark.parametrize("masked", [False, True])
def test_tiled_scan_equals_the_plain_k3(n, m, masked):
    """On clouds with exact duplicates in one sub-tile and across the
    sub-tile and tile boundaries, the kernel's scan of the plain version's
    distance matrix gives the plain K3's dist and idx bit for bit, and the
    first copy of each duplicate; masked with a fully masked cloud."""
    a, b = _clouds(n + m, 3, n, m)
    edges = [e for e in (SUB, TILE, 2 * TILE, 4 * TILE) if e + 1 < m]
    pairs = [(e - 1, e + 1) for e in edges] + [(0, m - 1), (2, 3)]
    pairs = [(j, d) for j, d in pairs if j < d < m]
    queries = _ties(a, b, pairs)
    b_mask = None
    if masked:
        b_mask = torch.from_numpy(
            (np.random.RandomState(1).rand(3, m) > 0.2).astype(np.float32))
        b_mask[:, [p for pair in pairs for p in pair]] = 1.0
        b_mask[2] = 0.0
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    rd, ri = chamfer.nearest_distances_plain(a, b, b_mask)
    best, arg = tiled_scan(chamfer._sqdist(a, b, b_mask))
    assert torch.equal(_dist(best), rd) and torch.equal(arg, ri)
    live = slice(0, 2) if masked else slice(None)
    firsts = torch.tensor([j for j, _ in pairs], dtype=torch.int32)
    assert torch.equal(arg[live][:, queries],
                       firsts.expand_as(arg[live][:, queries]))
    if masked:
        assert bool((arg[2] == 0).all())  # all d2 equal: the first index


@pytest.mark.parametrize("masked", [False, True])
def test_first_copy_against_jax_across_a_tile(masked):
    """The plain K3 and the JAX package's Pallas K3 (interpret mode,
    tile_m=256) both return the first copy of a b point duplicated on both
    sides of the JAX tile boundary, and agree elsewhere."""
    a, b = _clouds(3, 2, 128, 512)
    pairs = [(200, 300), (255, 256), (10, 500), (0, 257)]
    queries = _ties(a, b, pairs)
    b_mask = None
    if masked:
        b_mask = (np.random.RandomState(4).rand(2, 512) > 0.3).astype(
            np.float32)
        b_mask[:, [p for pair in pairs for p in pair]] = 1.0
    ref_d, ref_i = jchamfer.nearest_distances(
        jnp.asarray(a), jnp.asarray(b), tile_n=128, tile_m=256,
        b_mask=None if b_mask is None else jnp.asarray(b_mask) > 0)
    d, i = chamfer.nearest_distances_plain(
        torch.from_numpy(a), torch.from_numpy(b),
        None if b_mask is None else torch.from_numpy(b_mask))
    firsts = np.array([j for j, _ in pairs])
    ref_i = np.asarray(ref_i)
    np.testing.assert_array_equal(ref_i[:, queries], np.tile(firsts, (2, 1)))
    np.testing.assert_array_equal(i.numpy()[:, queries],
                                  np.tile(firsts, (2, 1)))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-5)


@pytest.mark.parametrize("n,m", card_checks.NN_RAGGED[:3])
def test_plain_k2_equals_plain_k3_distances(n, m):
    """The check the card tests make of the kernels, on the plain versions:
    K2's distances are K3's unmasked ones bit for bit."""
    a, b = _clouds(6, 3, n, m)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(chamfer.nearest_min_distances_plain(a, b),
                       chamfer.nearest_distances_plain(a, b)[0])


def test_plain_k3_mask_of_ones_equals_no_mask():
    a, b = _clouds(7, 2, 50, 600)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    d, i = chamfer.nearest_distances_plain(a, b)
    dm, im = chamfer.nearest_distances_plain(a, b, torch.ones(2, 600))
    assert torch.equal(d, dm) and torch.equal(i, im)


def test_cpu_tensors_run_the_plain_versions():
    a, b = _clouds(5, 2, 30, 600)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    rd, ri = chamfer.nearest_distances_plain(a, b, None)
    d, i = chamfer.nearest_distances(a, b)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    assert torch.equal(chamfer.nearest_min_distances(a, b),
                       chamfer.nearest_min_distances_plain(a, b))


def test_geometry_is_the_sources():
    """card_checks.nn_geometry reads the R and C that csrc/nn_dist.cu fixes, and a
    shared-memory tile holds whole sub-tiles."""
    assert card_checks.nn_geometry() == {"R": GEOMETRY["R"],
                                        "C": GEOMETRY["C"]}
    assert TILE % SUB == 0 and GEOMETRY["Threads"] % 32 == 0
