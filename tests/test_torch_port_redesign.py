"""The CPU side of the redesigned K5 (Chamfer scatter as a counting sort)
and K1 (register-tiled fused encoder + pool).

K5's plain version sums each target's points in increasing i from +0 in
float32, as the kernel does: it is held bit for bit against a plain Python
loop, within 1e-6 of scatter_add_ and of the JAX package's Pallas kernel
(interpret mode). K1's wrapper picks its instance by ``encoder_tile``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu.ops import chamfer as jchamfer
from gan_rl_3d_tpu_torch.ops import chamfer as tchamfer
from gan_rl_3d_tpu_torch.ops import encoder_kernel as tek

FLAGSHIP = (3, 64, 128, 128, 256, 128)


def _loop(idx, da, m):
    """db_j = 0 - (((0 + da_i0) + da_i1) + ...) over increasing i, float32."""
    out = np.zeros((idx.shape[0], m, 3), np.float32)
    for b in range(idx.shape[0]):
        for i in range(idx.shape[1]):
            j = idx[b, i]
            if 0 <= j < m:
                out[b, j] = out[b, j] + da[b, i]
    return np.float32(0) - out


def _targets(kind, bsz, n, m, rng):
    if kind == "one target":
        return np.zeros((bsz, n), np.int32)
    if kind == "distinct":
        return np.stack([rng.permutation(m)[:n] for _ in range(bsz)])
    return rng.randint(0, m, (bsz, n)).astype(np.int32)


def _da(rng, bsz, n):
    """Values over six decades, so the order of the adds shows in the bits."""
    scale = np.float32(10.0) ** rng.randint(-3, 3, (bsz, n, 1))
    return (rng.randn(bsz, n, 3) * scale).astype(np.float32)


@pytest.mark.parametrize("kind,bsz,n,m", [
    ("one target", 2, 300, 40),
    ("distinct", 2, 60, 90),       # M > N: targets nothing picks
    ("random", 3, 500, 70),        # N > M: long segments
    ("random", 2, 50, 400),        # M > N
])
def test_scatter_plain_equals_ordered_loop(kind, bsz, n, m):
    rng = np.random.RandomState(n + m)
    idx = _targets(kind, bsz, n, m, rng)
    da = _da(rng, bsz, n)
    out = tchamfer.nearest_grad_b_plain(torch.from_numpy(idx),
                                        torch.from_numpy(da), m).numpy()
    ref = _loop(idx, da, m)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    unpicked = np.ones((bsz, m), bool)
    unpicked[np.arange(bsz)[:, None], idx] = False
    if unpicked.any():
        # +0.0, not -0.0, where nothing picked the target
        assert not np.signbit(out[unpicked]).any()
        assert (out[unpicked] == 0).all()


def test_scatter_plain_skips_indices_outside_m():
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 20, (2, 64)).astype(np.int32)
    idx[0, ::7] = -1
    idx[1, ::5] = 20
    da = _da(rng, 2, 64)
    out = tchamfer.nearest_grad_b_plain(torch.from_numpy(idx),
                                        torch.from_numpy(da), 20).numpy()
    np.testing.assert_array_equal(out.view(np.int32),
                                  _loop(idx, da, 20).view(np.int32))


@pytest.mark.parametrize("kind", ["one target", "random"])
def test_scatter_plain_agrees_with_scatter_add_and_pallas(kind):
    rng = np.random.RandomState(7)
    bsz, n, m = 2, 256, 256
    idx = _targets(kind, bsz, n, m, rng)
    da = rng.randn(bsz, n, 3).astype(np.float32)
    out = tchamfer.nearest_grad_b_plain(torch.from_numpy(idx),
                                        torch.from_numpy(da), m)
    add = torch.zeros(bsz, m, 3).scatter_add_(
        1, torch.from_numpy(idx).long()[..., None].expand(-1, -1, 3),
        -torch.from_numpy(da))
    pallas = np.asarray(jchamfer._scatter_db(jnp.asarray(idx),
                                             jnp.asarray(da), m, 128, 128,
                                             interpret=True))
    for ref in (add.numpy(), pallas):
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(out.numpy() - ref).max()) <= 1e-6 * scale


@pytest.mark.parametrize("dims", [
    FLAGSHIP,
    (3, 24, 40, 72, 200, 8),
    (3, 17, 255, 129, 3),
    (3, 256, 160, 256, 160, 256),
    (3, 100),
])
def test_encoder_tile_picks_the_flagship_tile_up_to_256(dims):
    assert tek.encoder_tile(dims) == 128


def test_encoder_tile_takes_the_32_point_tile_for_256_wide_pairs():
    dims = (3, 256, 256, 256, 256, 256)
    assert tek.encoder_smem(dims, 128) > 232448
    assert tek.encoder_tile(dims) == 32


def test_encoder_smem_at_the_flagship_widths():
    # (256 + 128 + 1) x 128 x 4 activation and flag bytes, two 8 KB slabs
    assert tek.encoder_smem(FLAGSHIP, 128) == 385 * 512 + 16384


@pytest.mark.parametrize("dims", [
    (3, 64, 512, 128),
    (3, 512, 512, 128),
    (3, 64, 908, 128),
    (3, 907, 907, 8),
])
def test_encoder_tile_fits_wide_layers(dims):
    tile = tek.encoder_tile(dims)
    assert tile == 32
    assert tek.encoder_smem(dims, 32) <= 232448
    assert tek.encoder_smem(dims, 128) > 232448


@pytest.mark.parametrize("dims", [(3, 908, 908, 8), (3, 1024, 1024, 128),
                                  (3, 64, 2048, 2048, 8)])
def test_encoder_tile_refuses_what_no_tile_fits(dims):
    with pytest.raises(ValueError, match="exceed K1's shared memory"):
        tek.encoder_tile(dims)
