"""GAN losses, the WGAN-GP penalty and the RL reward
(gan_rl_3d_tpu/ops/losses.py:44-156).

The penalty's double backward is ``torch.autograd.grad(...,
create_graph=True)`` through the discriminator. The reward's Chamfer
distance is ``ops.chamfer.chamfer_distance``: K3 on the card, its plain
version on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gan_rl_3d_tpu_torch.ops.chamfer import chamfer_distance

Tensor = torch.Tensor


def chamfer_loss(pred: Tensor, target: Tensor, *,
                 bidirectional: bool = True) -> Tensor:
    """Scalar batch-mean Chamfer distance (losses.py:27-41)."""
    return chamfer_distance(pred, target, bidirectional=bidirectional).mean()


def gfv_loss(pred_gfv: Tensor, target_gfv: Tensor) -> Tensor:
    """MSE in latent space (losses.py:44-46)."""
    return (pred_gfv - target_gfv).square().mean()


def discriminator_loss(real_logits: Tensor, fake_logits: Tensor,
                       loss_type: str = "wgan-gp") -> Tensor:
    """(losses.py:65-75)"""
    if loss_type == "wgan-gp":
        return fake_logits.mean() - real_logits.mean()
    if loss_type == "lsgan":
        return ((real_logits - 1.0).square().mean()
                + fake_logits.square().mean()) / 2.0
    return (F.softplus(-real_logits).mean()
            + F.softplus(fake_logits).mean()) / 2.0


def generator_loss(fake_logits: Tensor, loss_type: str = "wgan-gp"
                   ) -> Tensor:
    """(losses.py:78-83)"""
    if loss_type == "wgan-gp":
        return -fake_logits.mean()
    if loss_type == "lsgan":
        return (fake_logits - 1.0).square().mean()
    return F.softplus(-fake_logits).mean()


def gradient_penalty(disc_fn: Callable[[Tensor], Tensor], alpha: Tensor,
                     real: Tensor, fake: Tensor, *,
                     lambda_gp: float = 10.0) -> Tensor:
    """lambda * E[(||grad_x D(x_hat)||_2 - 1)^2] at the interpolates x_hat
    = alpha * real + (1 - alpha) * fake, ``alpha`` (B, 1) the U[0, 1) draw
    (losses.py:86-113). The input gradient keeps its graph, so the
    penalty's gradient w.r.t. the weights ``disc_fn`` closes over is the
    double backward."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(
        True)
    (grads,) = torch.autograd.grad(disc_fn(interp).sum(), interp,
                                   create_graph=True)
    norms = torch.linalg.vector_norm(grads.reshape(grads.shape[0], -1),
                                     dim=1)
    return lambda_gp * (norms - 1.0).square().mean()


def completion_reward(pred_pc: Tensor, target_pc: Tensor, pred_gfv: Tensor,
                      target_gfv: Tensor, discriminator_output: Tensor, *,
                      w_chamfer: float = 100.0, w_gfv: float = 10.0,
                      w_discriminator: float = 0.01) -> Tensor:
    """Scalar reward -(w_ch * CD + w_gfv * MSE + w_d * (-E[D]))
    (losses.py:121-140)."""
    ch = chamfer_loss(pred_pc, target_pc)
    gl = gfv_loss(pred_gfv, target_gfv)
    dl = -discriminator_output.mean()
    return -(w_chamfer * ch + w_gfv * gl + w_discriminator * dl)


def completion_reward_batched(pred_pc: Tensor, target_pc: Tensor,
                              pred_gfv: Tensor, target_gfv: Tensor,
                              discriminator_output: Tensor, *,
                              w_chamfer: float = 100.0, w_gfv: float = 10.0,
                              w_discriminator: float = 0.01) -> Tensor:
    """Per-sample rewards (B,) (losses.py:143-156)."""
    ch = chamfer_distance(pred_pc, target_pc)
    gl = (pred_gfv - target_gfv).square().mean(dim=-1)
    dl = -discriminator_output.reshape(-1)
    return -(w_chamfer * ch + w_gfv * gl + w_discriminator * dl)
