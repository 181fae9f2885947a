"""Train and eval steps of phases 1-5 (gan_rl_3d_tpu/train/steps.py:42-879).

PyTorch runs eagerly, so a step is a plain function. Phase 1: the data
transforms on the device, the AE forward with training BatchNorm, the
Chamfer loss (kernels K3 forward, K4/K5 backward on the card), backward
and Adam. Phase 2 encodes clean and holed clouds with the frozen encoder;
phase 3 is the latent WGAN-GP (D steps with the gradient penalty's double
backward, then a G step); phase 4 collects transitions from B parallel
environments (the reward's Chamfer distance is K3 on the card) into the
replay ring and runs TD3 updates. Phase 5 fine-tunes the encoder, the
decoder and the generator together against the frozen actor (two
Chamfer losses when the AE path trains too: K3 forward, K4/K5 backward on
the card). The JAX steps are pure and return new
parameters; here the optimizers update the parameter tensors in place,
and a step returns the new BatchNorm and spectral-norm state. Each step
takes its random numbers as arguments (``draw_*`` draws them from a
device generator), so a test can feed it the numbers JAX drew. Phases
3-4 run BatchNorm with the centered statistics, as the JAX trainer does
whatever training.bn_stats says.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch.config import (AETrainConfig, JointTrainConfig,
                                        LGANTrainConfig)
from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.models import latent_gan as lg
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.models.common import grad_step
from gan_rl_3d_tpu_torch.ops import chamfer
from gan_rl_3d_tpu_torch.ops import losses as losses_ops
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.train.replay_buffer import ReplayBuffer
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map

Tensor = torch.Tensor


def _check_finite(value: Tensor, what: str) -> None:
    """Under torch's anomaly mode (``train_rl_gan_net --debug-nans``, the
    JAX CLI's jax_debug_nans) raise FloatingPointError where ``value``, a
    step's loss before its backward pass, holds a NaN or an inf: a host
    sync. Anomaly mode itself names a backward op that makes one.
    Nothing otherwise."""
    if torch.is_anomaly_enabled() and not bool(torch.isfinite(value).all()):
        raise FloatingPointError(f"non-finite {what}: {value.detach().cpu()}")


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
    """bf16 everywhere except the MLP decoder's last (coordinate) layer and
    the encoder's last point-MLP layer (the GFV bottleneck), which stay f32
    (steps.py:93-117). The adaptive decoder has no ``mlp`` and is cast
    whole; the attention encoder keeps its last point-MLP layer f32."""
    cast = _policy_cast(tree, dtype)
    if "decoder" in tree and "mlp" in tree["decoder"]:
        dec = list(cast["decoder"]["mlp"])
        dec[-1] = tree["decoder"]["mlp"][-1]
        cast = {**cast, "decoder": {**cast["decoder"], "mlp": dec}}
    if "encoder" in tree and "point_mlp" in tree["encoder"]:
        enc = list(cast["encoder"]["point_mlp"])
        enc[-1] = tree["encoder"]["point_mlp"][-1]
        cast = {**cast, "encoder": {**cast["encoder"], "point_mlp": enc}}
    return cast


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
    _check_finite(loss, "AE loss")
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


# ---------------------------------------------------------------------------
# Phase 2: GFV extraction
# ---------------------------------------------------------------------------


@torch.no_grad()
def gfv_extract_step(params: dict, bn_state: dict, batch: Dict[str, Tensor],
                     draws: Dict[str, Tensor], *,
                     spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC
                     ) -> Tuple[Tensor, Tensor]:
    """(clean GFV, noisy GFV) of one batch with the frozen eval-mode
    encoder; holes from ``draws`` (draw_training_batch with
    augment=False), no augmentation (steps.py:339-352)."""
    complete, incomplete, mask = pc_ops.apply_training_batch(
        batch["complete_pc"], draws, spec=spec, do_augment=False)
    enc_p, enc_s = params["encoder"], bn_state["encoder"]
    return (ae.any_encoder_apply(enc_p, enc_s, complete)[0],
            ae.any_encoder_apply(enc_p, enc_s, incomplete, mask)[0])


# ---------------------------------------------------------------------------
# Phase 3: latent WGAN-GP
# ---------------------------------------------------------------------------


def make_gan_optimizer(params, lr: float, cfg: LGANTrainConfig
                       ) -> torch.optim.Adam:
    """optax.adam(lr, b1=beta1, b2=beta2) (steps.py:360-361)."""
    return torch.optim.Adam(tree_leaves(params), lr=lr,
                            betas=(cfg.beta1, cfg.beta2))


def draw_lgan_d(generator: torch.Generator, bsz: int, z_dim: int,
                d_dims: Sequence[int]) -> Dict[str, object]:
    """The draws of one D step (steps.py:383-384): ``z`` (B, z_dim)
    standard normal, ``alpha`` (B, 1) U[0, 1), and the dropout keep masks
    of the real, fake and interpolate calls."""
    kw = dict(generator=generator, device=generator.device)
    return {"z": torch.randn((bsz, z_dim), **kw),
            "keep_real": lg.draw_dropout_masks(generator, bsz, d_dims),
            "keep_fake": lg.draw_dropout_masks(generator, bsz, d_dims),
            "alpha": torch.rand((bsz, 1), **kw),
            "keep_gp": lg.draw_dropout_masks(generator, bsz, d_dims)}


def draw_lgan_g(generator: torch.Generator, bsz: int, z_dim: int,
                d_dims: Sequence[int]) -> Dict[str, object]:
    """The draws of one G step (steps.py:437-438): ``z`` and ``keep``."""
    return {"z": torch.randn((bsz, z_dim), generator=generator,
                             device=generator.device),
            "keep": lg.draw_dropout_masks(generator, bsz, d_dims)}


def draw_lgan_combined(generator: torch.Generator, bsz: int, z_dim: int,
                       d_dims: Sequence[int], d_steps: int
                       ) -> Dict[str, object]:
    return {"d": [draw_lgan_d(generator, bsz, z_dim, d_dims)
                  for _ in range(d_steps)],
            "g": draw_lgan_g(generator, bsz, z_dim, d_dims)}


def lgan_d_step(lgan_params: dict, lgan_state: dict, d_opt: torch.optim.Adam,
                real_gfv: Tensor, draws: Dict[str, object], *,
                lambda_gp: float = 10.0) -> Tuple[dict, Dict[str, Tensor]]:
    """One discriminator step: WGAN loss + gradient penalty, Adam on D's
    parameters in place (steps.py:364-420). The fakes come from the
    training-mode generator without a gradient, so its BN statistics
    advance; D runs on the real, fake and interpolated batches, each call
    starting from the previous call's spectral-norm state, and the state
    kept is the fake call's. Returns (new state, {"d_loss", "wasserstein",
    "gp"})."""
    with torch.no_grad():
        fake, gen_state = lg.generator_apply(
            lgan_params["generator"], lgan_state["generator"], draws["z"],
            training=True)
    d_params = lgan_params["discriminator"]
    real_scores, d_s1 = lg.discriminator_apply(
        d_params, lgan_state["discriminator"], real_gfv, training=True,
        keep_masks=draws["keep_real"])
    fake_scores, d_s2 = lg.discriminator_apply(
        d_params, d_s1, fake, training=True, keep_masks=draws["keep_fake"])
    gp = losses_ops.gradient_penalty(
        lambda x: lg.discriminator_apply(d_params, d_s2, x, training=True,
                                         keep_masks=draws["keep_gp"])[0],
        draws["alpha"], real_gfv, fake, lambda_gp=lambda_gp)
    w_loss = losses_ops.discriminator_loss(real_scores, fake_scores)
    d_loss = w_loss + gp
    _check_finite(d_loss, "D loss")
    grad_step(d_opt, d_loss, d_params)
    return ({"generator": gen_state, "discriminator": d_s2},
            {"d_loss": d_loss.detach(), "wasserstein": -w_loss.detach(),
             "gp": gp.detach()})


def lgan_generator_step(lgan_params: dict, lgan_state: dict,
                        g_opt: torch.optim.Adam, draws: Dict[str, object]
                        ) -> Tuple[dict, Dict[str, Tensor]]:
    """One generator step against the training-mode discriminator, Adam on
    G's parameters in place; both states advance (steps.py:423-455)."""
    fake, g_state = lg.generator_apply(
        lgan_params["generator"], lgan_state["generator"], draws["z"],
        training=True)
    scores, d_state = lg.discriminator_apply(
        lgan_params["discriminator"], lgan_state["discriminator"], fake,
        training=True, keep_masks=draws["keep"])
    g_loss = losses_ops.generator_loss(scores)
    _check_finite(g_loss, "G loss")
    grad_step(g_opt, g_loss, lgan_params["generator"])
    return ({"generator": g_state, "discriminator": d_state},
            {"g_loss": g_loss.detach()})


def _d_steps(lgan_params, lgan_state, d_opt, real_gfvs, d_draws, lambda_gp
             ) -> Tuple[dict, List[Tensor]]:
    losses = []
    for real, draws in zip(real_gfvs, d_draws):
        lgan_state, m = lgan_d_step(lgan_params, lgan_state, d_opt, real,
                                    draws, lambda_gp=lambda_gp)
        losses.append(m["d_loss"])
    return lgan_state, losses


def lgan_combined_step(lgan_params: dict, lgan_state: dict,
                       d_opt: torch.optim.Adam, g_opt: torch.optim.Adam,
                       real_gfvs: Tensor, draws: Dict[str, object], *,
                       lambda_gp: float = 10.0
                       ) -> Tuple[dict, Dict[str, Tensor]]:
    """``real_gfvs`` (d_steps, B, latent): one D step per real batch, then
    one G step (steps.py:458-506). Returns (new state, {"d_loss" (their
    mean), "g_loss"})."""
    lgan_state, d_losses = _d_steps(lgan_params, lgan_state, d_opt,
                                    real_gfvs, draws["d"], lambda_gp)
    lgan_state, gm = lgan_generator_step(lgan_params, lgan_state, g_opt,
                                         draws["g"])
    return lgan_state, {"d_loss": torch.stack(d_losses).mean(),
                        "g_loss": gm["g_loss"]}


def lgan_d_refresh(lgan_params: dict, lgan_state: dict,
                   d_opt: torch.optim.Adam, real_gfvs: Tensor,
                   d_draws: Sequence[Dict[str, object]], *,
                   lambda_gp: float = 10.0
                   ) -> Tuple[dict, Dict[str, Tensor]]:
    """K D steps with the generator frozen, ``real_gfvs`` (K, B, latent)
    (steps.py:509-545). Returns (new state, {"d_losses" (K,)})."""
    lgan_state, losses = _d_steps(lgan_params, lgan_state, d_opt, real_gfvs,
                                  d_draws, lambda_gp)
    return lgan_state, {"d_losses": torch.stack(losses)}


# ---------------------------------------------------------------------------
# Phase 4: RL (batched environments, replay ring, TD3 updates)
# ---------------------------------------------------------------------------


def draw_rl_step(generator: torch.Generator, bsz: int, n: int, *,
                 cfg: rl.TD3Config, buffer_size: int,
                 steps_per_episode: int = 1, updates_per_step: int = 1,
                 spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC
                 ) -> Dict[str, object]:
    """The draws of one ``rl_step`` over ``bsz`` environments: ``holes``
    (draw_training_batch without augmentation), ``ou`` (S, B, action_dim)
    standard normals, one per environment step; per TD3 update ``sample``
    (U, batch_size) buffer rows uniform over the ``buffer_size`` valid
    rows after this step's push, and ``noise`` (U, batch_size,
    action_dim), the target-policy smoothing's standard normal."""
    kw = dict(generator=generator, device=generator.device)
    u = updates_per_step
    return {
        "holes": pc_ops.draw_training_batch(generator, bsz, n, spec=spec,
                                            augment=False),
        "ou": torch.randn((steps_per_episode, bsz, cfg.action_dim), **kw),
        "sample": torch.randint(0, max(buffer_size, 1),
                                (u, cfg.batch_size), **kw),
        "noise": torch.randn((u, cfg.batch_size, cfg.action_dim), **kw),
    }


def rl_step(model: dict, buffer: ReplayBuffer, ou_states: Tensor,
            batch: Dict[str, Tensor], draws: Dict[str, object], *,
            cfg: rl.TD3Config, w_chamfer: float = 100.0, w_gfv: float = 10.0,
            w_discriminator: float = 0.01, start_training_size: int = 64,
            steps_per_episode: int = 1, updates_per_step: int = 1,
            spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC
            ) -> Tuple[dict, ReplayBuffer, Tensor, Dict[str, Tensor]]:
    """One RL iteration over B parallel episodes of ``steps_per_episode``
    environment steps (steps.py:554-648): cut holes -> env_reset ->
    [actor + OU -> env_step] per step -> push B * S transitions (step
    major) -> ``updates_per_step`` TD3 updates once the buffer holds
    max(start_training_size, batch_size). Updates the agent and the
    buffer in place; returns (model, buffer, new OU state, {"critic_loss",
    "actor_loss" (the last update's, 0 without updates), "reward" (the
    mean episode reward over the rows ``batch["pad"]`` does not mark)})."""
    with torch.no_grad():
        complete, incomplete, mask = pc_ops.apply_training_batch(
            batch["complete_pc"], draws["holes"], spec=spec,
            do_augment=False)
        env = net.env_reset(model, incomplete, complete, mask)
        ou, transitions, rewards = ou_states, [], []
        for i in range(steps_per_episode):
            action, ou = rl.select_action(model["agent"], env.state, cfg,
                                          ou_state=ou, add_noise=True,
                                          normal=draws["ou"][i])
            env_next, r, _, _ = net.env_step(
                model, env, action, w_chamfer=w_chamfer, w_gfv=w_gfv,
                w_discriminator=w_discriminator)
            done = torch.full_like(r, float(i == steps_per_episode - 1))
            transitions.append((env.state, action, r[:, None],
                                env_next.state, done[:, None]))
            rewards.append(r)
            env = env_next
        _check_finite(torch.stack(rewards), "RL reward")
        buffer.add_batch(rl.TransitionBatch(
            *(torch.cat(f) for f in zip(*transitions))))
    zero = torch.zeros((), device=ou.device)
    metrics = {"critic_loss": zero, "actor_loss": zero}
    if buffer.size >= max(start_training_size, cfg.batch_size):
        for u in range(updates_per_step):
            _, metrics = rl.agent_update(
                model["agent"], buffer.sample(draws["sample"][u]),
                draws["noise"][u], cfg)
            _check_finite(metrics["critic_loss"], "critic loss")
    metrics = dict(metrics, reward=_masked_mean(torch.stack(rewards).sum(0),
                                                batch["pad"]))
    return model, buffer, ou, metrics


@torch.no_grad()
def rl_eval_reward(model: dict, batch: Dict[str, Tensor],
                   draws: Dict[str, Tensor], *, cfg: rl.TD3Config,
                   w_chamfer: float = 100.0, w_gfv: float = 10.0,
                   w_discriminator: float = 0.01,
                   spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC
                   ) -> Dict[str, Tensor]:
    """Greedy single-step reward and Chamfer distance of the completions on
    a fixed batch with fixed holes ``draws`` (steps.py:651-685)."""
    complete, incomplete, mask = pc_ops.apply_training_batch(
        batch["complete_pc"], draws, spec=spec, do_augment=False)
    env0 = net.env_reset(model, incomplete, complete, mask)
    action, _ = rl.select_action(model["agent"], env0.state, cfg)
    _, rewards, _, info = net.env_step(
        model, env0, action, w_chamfer=w_chamfer, w_gfv=w_gfv,
        w_discriminator=w_discriminator)
    per_cd = chamfer.chamfer_distance(info["completed_pc"], env0.target_pc)
    return {"reward": _masked_mean(rewards, batch["pad"]),
            "chamfer": _masked_mean(per_cd, batch["pad"])}


# ---------------------------------------------------------------------------
# Phase 5: joint fine-tune
# ---------------------------------------------------------------------------


def joint_trainable(model: dict, freeze_generator: bool = False) -> dict:
    """The joint phase's trainable parameters: ``ae``, and ``gen`` (the
    generator) unless it is frozen (trainer.py:520-523)."""
    trainable = {"ae": model["ae"]["params"]}
    if not freeze_generator:
        trainable["gen"] = model["lgan"]["params"]["generator"]
    return trainable


def make_joint_optimizer(params, cfg: JointTrainConfig) -> torch.optim.Adam:
    """optax.chain(add_decayed_weights(wd), scale_by_adam(), lr)
    (steps.py:687-692): the decay joins the gradient before the moments,
    which is torch's Adam(weight_decay=wd), not AdamW. ``params`` is the
    trainable tree (``joint_trainable``)."""
    return torch.optim.Adam(tree_leaves(params), lr=cfg.lr,
                            weight_decay=cfg.weight_decay)


def joint_train_step(model: dict, optimizer: torch.optim.Optimizer,
                     batch: Dict[str, Tensor], draws: Dict[str, Tensor], *,
                     cfg: rl.TD3Config,
                     compute_dtype: Optional[torch.dtype] = None,
                     spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                     bidirectional: bool = True, w_ae_recon: float = 0.0,
                     selective: bool = False, bn_stats: str = "centered",
                     freeze_generator: bool = False
                     ) -> Tuple[dict, Dict[str, Tensor]]:
    """One joint fine-tune step (steps.py:695-809): holes with
    augmentation -> encoder in training mode -> z from the actor in eval
    mode with no gradient -> G (training mode, or eval mode when
    ``freeze_generator``) -> decoder in training mode -> loss =
    Chamfer(decode(G(z)), complete) + 0.1 * MSE(clean GFV, noisy GFV),
    whose MSE gradient reaches both GFVs. With ``w_ae_recon`` > 0 both GFVs
    go through one (2B, .) decoder pass and w * Chamfer(decode(noisy GFV),
    complete) joins the loss. ``optimizer`` holds the trainable leaves
    (``joint_trainable``) and updates them in place. Returns (the model
    with the new BN states of the encoder, decoder and generator, {"loss",
    "chamfer", "gfv"}); a frozen G keeps its parameters and state."""
    complete, incomplete, mask = pc_ops.apply_training_batch(
        batch["complete_pc"], draws, spec=spec, do_augment=True)
    ae_p = model["ae"]["params"]
    gen_p = model["lgan"]["params"]["generator"]
    if freeze_generator:
        gen_p = tree_map(lambda v: v.detach(), gen_p)
    x_in = incomplete
    if compute_dtype is not None:
        ae_p = (_policy_cast_ae_selective(ae_p, compute_dtype) if selective
                else _policy_cast(ae_p, compute_dtype))
        gen_p = _policy_cast(gen_p, compute_dtype)
        x_in = incomplete.to(compute_dtype)
    ae_s, gen_s = model["ae"]["state"], model["lgan"]["state"]["generator"]
    actor = model["agent"]["actor"]
    optimizer.zero_grad(set_to_none=True)
    noisy_gfv, enc_s = ae.any_encoder_apply(
        ae_p["encoder"], ae_s["encoder"], x_in, mask, training=True,
        bn_stats=bn_stats)
    with torch.no_grad():
        z, _ = rl.actor_apply(actor["params"], actor["state"], noisy_gfv,
                              cfg=cfg, training=False)
    clean_gfv, new_gen_s = lg.generator_apply(
        gen_p, gen_s, z, training=not freeze_generator, bn_stats=bn_stats)
    if w_ae_recon > 0.0:
        bsz = clean_gfv.shape[0]
        both, dec_s = ae.any_decoder_apply(
            ae_p["decoder"], ae_s["decoder"],
            torch.cat([clean_gfv, noisy_gfv], dim=0), training=True,
            bn_stats=bn_stats)
        completed, ae_recon = both[:bsz], both[bsz:]
    else:
        completed, dec_s = ae.any_decoder_apply(
            ae_p["decoder"], ae_s["decoder"], clean_gfv, training=True,
            bn_stats=bn_stats)
    ch = _masked_mean(chamfer.chamfer_distance(
        completed, complete, bidirectional=bidirectional), batch["pad"])
    gl = losses_ops.gfv_loss(clean_gfv, noisy_gfv)
    loss = ch + 0.1 * gl
    if w_ae_recon > 0.0:
        loss = loss + w_ae_recon * _masked_mean(chamfer.chamfer_distance(
            ae_recon, complete, bidirectional=bidirectional), batch["pad"])
    _check_finite(loss, "joint loss")
    loss.backward()
    optimizer.step()
    lgan = model["lgan"]
    new_model = dict(model)
    new_model["ae"] = {"params": model["ae"]["params"],
                       "state": {"encoder": enc_s, "decoder": dec_s}}
    new_model["lgan"] = {
        "params": lgan["params"],
        "state": {"generator": gen_s if freeze_generator else new_gen_s,
                  "discriminator": lgan["state"]["discriminator"]}}
    return new_model, {"loss": loss.detach(), "chamfer": ch.detach(),
                       "gfv": gl.detach()}


def joint_train_epoch(model: dict, optimizer: torch.optim.Optimizer,
                      data: Tensor, order: Tensor, pads: Tensor,
                      generator: torch.Generator, *,
                      spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                      **step_kw) -> Tuple[dict, Dict[str, Tensor]]:
    """One joint epoch over a device-resident train split (the loop form
    of joint_train_epoch_resident, steps.py:812-857), as ae_train_epoch:
    each step gathers its batch on the device and draws its transforms
    from ``generator``. Returns (model, {"losses": (S,) tensor})."""
    losses = []
    for idx, pad in zip(order, pads):
        complete = data[idx]
        draws = pc_ops.draw_training_batch(generator, complete.shape[0],
                                           complete.shape[1], spec=spec)
        model, m = joint_train_step(
            model, optimizer, {"complete_pc": complete, "pad": pad}, draws,
            spec=spec, **step_kw)
        losses.append(m["loss"])
    return model, {"losses": torch.stack(losses) if losses
                   else torch.zeros(0)}


@torch.no_grad()
def joint_eval_step(model: dict, batch: Dict[str, Tensor],
                    draws: Dict[str, Tensor], *, cfg: rl.TD3Config,
                    spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                    bidirectional: bool = True,
                    gate_mode: str = "discriminator",
                    gate_bias: float = 0.0) -> Dict[str, Tensor]:
    """Validation through ``complete`` with the hybrid gate, holes from
    ``draws``, no augmentation: the masked mean Chamfer distance of the
    hybrid output (steps.py:860-879)."""
    complete, incomplete, mask = pc_ops.apply_training_batch(
        batch["complete_pc"], draws, spec=spec, do_augment=False)
    out = net.complete(model, incomplete, mask, cfg=cfg, gate_mode=gate_mode,
                       gate_bias=gate_bias)
    per = chamfer.chamfer_distance(out["hybrid_output"], complete,
                                   bidirectional=bidirectional)
    return {"loss": _masked_mean(per, batch["pad"])}
