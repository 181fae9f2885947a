"""Train and eval steps of the autoencoder phase (gan_rl_3d_tpu/train/steps.py:42-330).

PyTorch runs eagerly, so a step is a plain function: the data transforms
on the device, the AE forward with training BatchNorm, the Chamfer loss
(kernels K3 forward, K4/K5 backward on the card), backward and Adam. The
JAX step is pure and returns new parameters; here the optimizer updates
the parameter tensors in place, and the step returns the new BatchNorm
state. The step takes the draws of ``ops.pointcloud.draw_training_batch``
instead of a key, so a test can feed it the numbers JAX drew.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from gan_rl_3d_tpu_torch.config import AETrainConfig
from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.ops import chamfer
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map

Tensor = torch.Tensor


def _masked_mean(per_sample: Tensor, pad: Tensor) -> Tensor:
    """Mean over real rows, leaving out the wrap-around padded rows."""
    w = 1.0 - pad
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)


def _recon_loss(recon: Tensor, complete: Tensor, *, recon_loss: str,
                bidirectional: bool) -> Tensor:
    """Per-sample loss per loss.{reconstruction_loss, chamfer_loss}."""
    if recon_loss == "mse":
        return ((recon - complete) ** 2).mean(dim=(-2, -1))
    return chamfer.chamfer_distance(recon, complete,
                                    bidirectional=bidirectional)


def make_ae_optimizer(params: dict, cfg: AETrainConfig, steps_per_epoch: int
                      ) -> Tuple[torch.optim.Adam,
                                 torch.optim.lr_scheduler.LambdaLR]:
    """Adam with L2 weight decay added to the gradient before the moments
    (torch semantics, as the JAX chain add_decayed_weights -> scale_by_adam
    builds them), and a per-step schedule: call ``scheduler.step()`` after
    every ``optimizer.step()``. "step": lr * gamma^((count // spe) //
    scheduler_step); "cosine": optax's cosine decay to 0 over epochs * spe
    updates. ``count`` is the number of updates before this one, 0 at the
    first (steps.py:65-84)."""
    opt = torch.optim.Adam(tree_leaves(params), lr=cfg.lr,
                           weight_decay=cfg.weight_decay)
    spe = max(steps_per_epoch, 1)
    if cfg.lr_schedule == "cosine":
        decay = max(cfg.epochs * steps_per_epoch, 1)

        def factor(count):
            return 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))
    else:
        def factor(count):
            return cfg.scheduler_gamma ** ((count // spe) // cfg.scheduler_step)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def _policy_cast(tree, dtype):
    """The compute-dtype copy of a params tree; the cast is differentiable,
    so gradients come back to the f32 master tensors."""
    return tree_map(lambda v: v.to(dtype), tree)


def _policy_cast_ae_selective(tree, dtype):
    """bf16 everywhere except the decoder's last (coordinate) layer and the
    encoder's last point-MLP layer (the GFV bottleneck), which stay f32
    (steps.py:93-117)."""
    cast = _policy_cast(tree, dtype)
    dec = list(cast["decoder"]["mlp"])
    dec[-1] = tree["decoder"]["mlp"][-1]
    enc = list(cast["encoder"]["point_mlp"])
    enc[-1] = tree["encoder"]["point_mlp"][-1]
    return {**cast, "decoder": {**cast["decoder"], "mlp": dec},
            "encoder": {**cast["encoder"], "point_mlp": enc}}


def compute_dtype_of(precision: str) -> Tuple[Optional[torch.dtype], bool]:
    """training.precision -> (compute dtype or None for f32, selective)."""
    bf16 = precision.startswith(("bfloat16", "bf16"))
    return (torch.bfloat16 if bf16 else None,
            precision.endswith("_selective"))


def ae_train_step(params: dict, bn_state: dict, optimizer: torch.optim.Adam,
                  batch: Dict[str, Tensor], draws: Dict[str, Tensor], *,
                  scheduler=None, augment: bool = True,
                  compute_dtype: Optional[torch.dtype] = None,
                  spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                  recon_loss: str = "chamfer", bidirectional: bool = True,
                  selective: bool = False, bn_stats: str = "centered"
                  ) -> Tuple[dict, Dict[str, Tensor]]:
    """One AE step (steps.py:124-166): hole cutting and augmentation ->
    forward with training BN -> Chamfer(recon, complete) averaged over the
    rows ``batch["pad"]`` does not mark -> Adam. ``batch["complete_pc"]``
    is (B, N, 3). Updates ``params`` in place; returns (new BN state,
    {"loss": 0-d tensor}). ``compute_dtype=torch.bfloat16`` rounds the
    matmul operands and activations to bf16 (f32 master weights, BN
    statistics and loss)."""
    complete, incomplete, mask = pc_ops.apply_training_batch(
        batch["complete_pc"], draws, spec=spec, do_augment=augment)
    p, x_in = params, incomplete
    if compute_dtype is not None:
        p = (_policy_cast_ae_selective(p, compute_dtype) if selective
             else _policy_cast(p, compute_dtype))
        x_in = incomplete.to(compute_dtype)
    optimizer.zero_grad(set_to_none=True)
    (recon, _gfv), new_state = ae.autoencoder_apply(
        p, bn_state, x_in, mask, training=True, bn_stats=bn_stats)
    per = _recon_loss(recon, complete, recon_loss=recon_loss,
                      bidirectional=bidirectional)
    loss = _masked_mean(per, batch["pad"])
    loss.backward()
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return new_state, {"loss": loss.detach()}


@torch.no_grad()
def ae_eval_step(params: dict, bn_state: dict, batch: Dict[str, Tensor],
                 draws: Dict[str, Tensor], *,
                 spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                 recon_loss: str = "chamfer", bidirectional: bool = True
                 ) -> Dict[str, Tensor]:
    """Validation (steps.py:169-184): holes from ``draws``, no
    augmentation, eval-mode BN."""
    complete, incomplete, mask = pc_ops.apply_training_batch(
        batch["complete_pc"], draws, spec=spec, do_augment=False)
    (recon, _), _ = ae.autoencoder_apply(params, bn_state, incomplete, mask,
                                         training=False)
    per = _recon_loss(recon, complete, recon_loss=recon_loss,
                      bidirectional=bidirectional)
    return {"loss": _masked_mean(per, batch["pad"])}


def ae_train_epoch(params: dict, bn_state: dict, optimizer, scheduler,
                   data: Tensor, order: Tensor, pads: Tensor,
                   generator: torch.Generator, *,
                   spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                   **step_kw) -> Tuple[dict, Dict[str, Tensor]]:
    """One epoch over a device-resident train split (the Python-loop form
    of ae_train_epoch_resident, steps.py:282-330): ``data`` (D, N, 3) on
    the device, ``order`` (S, B) row indices and ``pads`` (S, B). Each step
    gathers its batch on the device and draws its transforms from
    ``generator``. Returns (BN state, {"losses": (S,) tensor})."""
    losses = []
    for idx, pad in zip(order, pads):
        complete = data[idx]
        draws = pc_ops.draw_training_batch(generator, complete.shape[0],
                                           complete.shape[1], spec=spec)
        bn_state, m = ae_train_step(
            params, bn_state, optimizer,
            {"complete_pc": complete, "pad": pad}, draws,
            scheduler=scheduler, spec=spec, **step_kw)
        losses.append(m["loss"])
    return bn_state, {"losses": torch.stack(losses) if losses
                      else torch.zeros(0)}
