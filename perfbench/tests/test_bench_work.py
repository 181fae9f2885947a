"""The benchmark's counts of work against hand arithmetic at both
configurations' widths."""

import json
from pathlib import Path

from perfbench import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
POINTNET = json.loads((CONFIGS / "rlgan-pointnet.json").read_text())["model"]
VARIANT = json.loads((CONFIGS / "rlgan-attn-adaptive.json").read_text())[
    "model"]

# 3*64 + 64*128 + 128*128 + 128*256 + 256*128 multiply-adds a point
POINT_MLP = 2 * (192 + 8192 + 16384 + 32768 + 32768)
HEAD = 2 * 128 * 128
ACTOR = 2 * (128 * 400 + 400 * 400 + 400 * 300 + 300 * 300 + 300 * 8)
GENERATOR = 2 * (8 * 256 + 256 * 512 + 512 * 512 + 512 * 256 + 256 * 128)
MLP_DECODER = 2 * (128 * 256 + 256 * 256 + 256 * 6144)
DISCRIMINATOR = 2 * (128 * 128 + 128 * 256 + 256 * 512 + 512 * 256 + 256 * 1)
ATTENTION = 2 * (128 * 32 + 32 * 1)
ADAPTIVE = 2 * (128 * 256 + 256 * 512 + 512 * 1024 + 1024 * 6144) \
    + 2 * (3 * 64 + 64 * 3) * 2048


def test_point_mlp_is_180608_flops_a_point():
    assert POINT_MLP == 180_608
    assert work.point_mlp_flops(POINTNET["autoencoder"]) == POINT_MLP
    assert work.point_mlp_flops(VARIANT["autoencoder"]) == POINT_MLP


def test_served_flops_a_batch():
    kept, clouds = 1_000_003, 7
    per_cloud = HEAD + ACTOR + GENERATOR + 2 * MLP_DECODER \
        + 2 * DISCRIMINATOR
    assert per_cloud == 9_929_056
    assert work.serve_flops(POINTNET, kept, clouds) \
        == POINT_MLP * kept + per_cloud * clouds


def test_variant_training_flops_a_step():
    kept, clouds = 1_234_567, 3
    forward = (POINT_MLP + ATTENTION) * kept + (HEAD + ADAPTIVE) * clouds
    assert work.train_flops(VARIANT["autoencoder"], kept, clouds) \
        == 3 * forward - 2 * 3 * 64 * kept
    # about 800 MFLOP a cloud at the mean kept share of 0.65
    per_cloud = work.train_flops(VARIANT["autoencoder"], 1331, 1)
    assert 7.9e8 < per_cloud < 8.1e8


def test_k1_f32_operations_and_bytes():
    weights = 4 * 64 + 65 * 128 + 129 * 128 + 129 * 256 + 257 * 128
    flops, nbytes = work.k1_f32(POINTNET["autoencoder"], 4096, 2048, 5_000_000)
    assert flops == POINT_MLP * 5_000_000
    assert nbytes == 4 * (4096 * 2048 * 3 + 4096 * 2048 + weights
                          + 4096 * 128)


def test_k3_operations_and_bytes_and_bound():
    flops, nbytes = work.k3(1024, 2048, 2048)
    assert flops == 8 * 1024 * 2048 * 2048
    assert nbytes == 4 * 2 * 1024 * 2048 * 3 + 8 * 1024 * 2048
    assert work.bound_seconds(flops, nbytes) == flops / 67e12
