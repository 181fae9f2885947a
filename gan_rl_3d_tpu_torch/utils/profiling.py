"""Profiling and step timing (gan_rl_3d_tpu/utils/profiling.py).

* ``trace(logdir)``: a context manager that runs ``torch.profiler`` over
  whatever runs inside it, host and (where a GPU is visible) device
  activity, and writes one Chrome trace, ``*.pt.trace.json``, under
  ``logdir`` (TensorBoard's profile plugin or Perfetto read it). The
  kernels launched through ``ops._cuda`` show by their own names. The
  profiler holds every event in host memory until the end: trace a short
  run.
* ``sync(tree)``: wait for the device work behind a tree of tensors.
* ``StepTimer``: an exponential moving average of step wall time, synced
  at the end of each step.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch

from gan_rl_3d_tpu_torch.utils.tree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """Profile the block into a Chrome trace under ``logdir``; with
    ``enabled=False`` run it untouched and write nothing."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def sync(tree) -> None:
    """Wait for the device work that produces any tensor of ``tree``: a
    ``torch.cuda.synchronize`` when a leaf lies on the card, nothing for
    host tensors (their values are ready when returned)."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda
           for x in tree_leaves(tree)):
        torch.cuda.synchronize()


class StepTimer:
    """Exponential-moving-average step timer.

    Usage:
        timer = StepTimer()
        with timer.step():      # sync boundary at exit
            out = train_step(...)
            timer.observe(out)  # out is ready before the clock stops
    """

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema_s: Optional[float] = None
        self.last_s: Optional[float] = None
        self._out = None

    def observe(self, tree) -> None:
        self._out = tree

    @contextlib.contextmanager
    def step(self) -> Iterator["StepTimer"]:
        t0 = time.perf_counter()
        yield self
        if self._out is not None:
            sync(self._out)
            self._out = None
        dt = time.perf_counter() - t0
        self.last_s = dt
        self.ema_s = dt if self.ema_s is None else (
            self.alpha * dt + (1 - self.alpha) * self.ema_s)
