"""Device-resident ring replay buffer (gan_rl_3d_tpu/train/replay_buffer.py).

Fixed-size tensors on the device and a write pointer. The pointer and the
fill level are Python ints: the host knows them without reading the
device, so the RL step decides whether to update without a sync. Sampling
is uniform with replacement; the caller draws the row indices, so a test
can feed the ones JAX drew.
"""

from __future__ import annotations

import torch

from gan_rl_3d_tpu_torch.models.rl_agent import TransitionBatch

Tensor = torch.Tensor
FIELDS = TransitionBatch._fields


class ReplayBuffer:
    """``states`` (capacity, state_dim), ``actions`` (capacity,
    action_dim), ``rewards``, ``dones`` (capacity, 1), ``next_states``;
    ``ptr`` the next write position, ``size`` the valid rows."""

    def __init__(self, capacity: int, state_dim: int = 128,
                 action_dim: int = 1,
                 device: "str | torch.device" = "cpu"):
        widths = {"states": state_dim, "actions": action_dim, "rewards": 1,
                  "next_states": state_dim, "dones": 1}
        for name in FIELDS:
            setattr(self, name, torch.zeros((capacity, widths[name]),
                                            dtype=torch.float32,
                                            device=device))
        self.capacity = capacity
        self.ptr = 0
        self.size = 0

    def add_batch(self, batch: TransitionBatch) -> None:
        """Write a batch of transitions at the ring pointer
        (replay_buffer.py:52-66)."""
        n = batch.states.shape[0]
        idx = (self.ptr + torch.arange(n, device=self.states.device)
               ) % self.capacity
        for name in FIELDS:
            getattr(self, name)[idx] = getattr(batch, name)
        self.ptr = (self.ptr + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def sample(self, indices: Tensor) -> TransitionBatch:
        """The rows ``indices``, which the caller draws uniform over
        [0, max(size, 1)) (replay_buffer.py:69-82;
        ``train.steps.draw_rl_step``)."""
        return TransitionBatch(*(getattr(self, name)[indices]
                                 for name in FIELDS))

