"""PyTorch/CUDA port of gan_rl_3d_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``data/``, ``runtime/``, ``utils/``, ``train/``) so each counterpart is
easy to find, and
keeps its public layouts: channels-last (B, N, C) clouds and (B, N) masks.
It imports torch and numpy only; the hand-written CUDA kernels live in
``csrc/`` and are built with nvcc at first use (``ops/_cuda.py``); the
host data loader's C++ source, ``runtime/cpp/``, with g++.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""
