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

Every step takes ``mesh=`` (``parallel.mesh``; None is one device, the
path the port always took). Under a mesh a step's batch is this rank's
rows of the global batch (``mesh.shard_batch``) and its draws are the
GLOBAL batch's: every rank draws the same numbers from the same seeded
generator and keeps its own rows, which is what lets a data-parallel run
follow the single-device trajectory. A loss is then this rank's term of
the global loss (its rows' sum over the global count), training BatchNorm
takes its statistics over the data group, the gradients are summed over
it in one flat bucket before the optimizer steps, and the metrics a step
returns are the global ones. The RL step gathers its transitions into a
ring every rank holds whole and runs the TD3 update replicated.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch.config import (AETrainConfig, JointTrainConfig,
                                        LGANTrainConfig)
from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.models import latent_gan as lg
from gan_rl_3d_tpu_torch.models import pcn
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.models.common import grad_step
from gan_rl_3d_tpu_torch.ops import chamfer
from gan_rl_3d_tpu_torch.ops import losses as losses_ops
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.parallel import collectives
from gan_rl_3d_tpu_torch.parallel import mesh as mesh_lib
from gan_rl_3d_tpu_torch.train.replay_buffer import ReplayBuffer
from gan_rl_3d_tpu_torch.utils.profiling import backward_spans, span
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
    """Mean over real rows, leaving out the wrap-around padded rows. Under
    a mesh the rows are this rank's and the count is the data group's:
    the result is this rank's term of the global mean."""
    w = 1.0 - pad
    count = w.sum()
    mesh = mesh_lib.active()
    if mesh is not None:
        count = collectives.sum_values(count, mesh)
    return (per_sample * w).sum() / torch.clamp(count, min=1.0)


def _share(batch_mean: Tensor) -> Tensor:
    """This rank's term of a global batch mean from the mean over its own
    rows (the data group's shards are equal)."""
    shards = mesh_lib.data_shards()
    return batch_mean if shards == 1 else batch_mean / shards


def _total(term: Tensor) -> Tensor:
    """A detached loss term summed over the data group: the global
    value."""
    mesh = mesh_lib.active()
    if mesh is None:
        return term.detach()
    return collectives.sum_values(term, mesh)


def _local(draws):
    """This rank's rows of draws made for the global batch (every leaf's
    leading axis is the batch)."""
    mesh = mesh_lib.active()
    if mesh is None:
        return draws
    return tree_map(lambda x: mesh_lib.local_rows(mesh, x), draws)


def _sync_grads(optimizer: torch.optim.Optimizer) -> None:
    """Sum the optimizer's gradients over the data group (one bucket)."""
    mesh = mesh_lib.active()
    if mesh is not None:
        collectives.all_reduce_grads(
            [p for g in optimizer.param_groups for p in g["params"]], mesh)


def _resident_batch(data: Tensor, idx: Tensor, data_sharded: bool
                    ) -> Tensor:
    """This rank's batch of the device-resident split (steps.py:248-281):
    ``idx`` are its rows of the global plan. Under sharded residency
    ``data`` is this rank's row block and the plan's rows must lie in it
    (the grouped plan guarantees it): they are taken at ``idx - offset``,
    and a row outside the block raises instead of being clamped."""
    if not data_sharded:
        return data[idx]
    mesh = mesh_lib.active()
    rows = data.shape[0]
    local = idx - (mesh.data_rank * rows if mesh is not None else 0)
    if bool(((local < 0) | (local >= rows)).any()):
        raise ValueError(
            "sharded residency: a batch row lies outside this rank's "
            f"block of {rows} rows; the plan must be shard-aligned "
            "(BatchLoader(shard_groups=DATA_SHARD_GROUPS))")
    return data[local]


def _recon_loss(recon: Tensor, complete: Tensor, *, recon_loss: str,
                bidirectional: bool) -> Tensor:
    """Per-sample loss per loss.{reconstruction_loss, chamfer_loss}."""
    if recon_loss == "mse":
        return ((recon - complete) ** 2).mean(dim=(-2, -1))
    return chamfer.chamfer_distance(recon, complete,
                                    bidirectional=bidirectional)


def _decode_train(params: dict, state: dict, gfv: Tensor, bn_stats: str
                  ) -> Tuple[Tensor, Optional[Tensor], dict]:
    """(cloud, coarse cloud or None, new state) of a decoder in training
    mode: the folding decoder's fine and coarse clouds (its state, the
    grid, unchanged), any other decoder's cloud and None."""
    if pcn.is_folding(params):
        coarse, fine = pcn.folding_decoder_outputs(params, state, gfv)
        return fine, coarse, state
    recon, new_state = ae.any_decoder_apply(params, state, gfv,
                                            training=True, bn_stats=bn_stats)
    return recon, None, new_state


def _recon_terms(recon: Tensor, coarse: Optional[Tensor], complete: Tensor,
                 fine_weight: float, *, recon_loss: str, bidirectional: bool
                 ) -> Tensor:
    """The per-sample reconstruction loss; with a coarse cloud PCN's
    loss(coarse) + fine_weight * loss(recon)."""
    per = _recon_loss(recon, complete, recon_loss=recon_loss,
                      bidirectional=bidirectional)
    if coarse is None:
        return per
    return _recon_loss(coarse, complete, recon_loss=recon_loss,
                       bidirectional=bidirectional) + fine_weight * per


def make_ae_optimizer(params: dict, cfg: AETrainConfig, steps_per_epoch: int
                      ) -> Tuple[torch.optim.Adam,
                                 torch.optim.lr_scheduler.LambdaLR]:
    """Adam with L2 weight decay added to the gradient before the moments
    (torch semantics, as the JAX chain add_decayed_weights -> scale_by_adam
    builds them), and a per-step schedule: call ``scheduler.step()`` after
    every ``optimizer.step()``. "step": lr * gamma^((count // spe) //
    scheduler_step); "cosine": optax's cosine decay to 0 over epochs * spe
    updates; "staircase": max(lr * gamma^(count // decay_steps), lr_floor)
    (tf.train.exponential_decay with staircase, then PCN's clip).
    ``count`` is the number of updates before this one, 0 at the
    first (steps.py:65-84). The span ``setup.optimizer`` times it: the
    process's first ``torch.optim`` optimizer imports ``torch._dynamo``."""
    with span("setup.optimizer"):
        opt = torch.optim.Adam(tree_leaves(params), lr=cfg.lr,
                               weight_decay=cfg.weight_decay)
        spe = max(steps_per_epoch, 1)
        if cfg.lr_schedule == "cosine":
            decay = max(cfg.epochs * steps_per_epoch, 1)

            def factor(count):
                return 0.5 * (1.0 + math.cos(math.pi * min(count, decay)
                                             / decay))
        elif cfg.lr_schedule == "staircase":
            def factor(count):
                return max(cfg.scheduler_gamma ** (count // cfg.decay_steps),
                           cfg.lr_floor / cfg.lr)
        else:
            def factor(count):
                return cfg.scheduler_gamma ** ((count // spe)
                                               // cfg.scheduler_step)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def _policy_cast(tree, dtype):
    """The compute-dtype copy of a params tree; the cast is differentiable,
    so gradients come back to the f32 master tensors. Column-sharded
    leaves stay marked."""
    return tree_map(lambda v: mesh_lib.keep_mark(v, v.to(dtype)), tree)


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
                  selective: bool = False, bn_stats: str = "centered",
                  alpha: Optional[Callable[[int], float]] = None,
                  mesh: Optional[mesh_lib.Mesh] = None
                  ) -> Tuple[dict, Dict[str, Tensor]]:
    """One AE step (steps.py:124-166): hole cutting and augmentation ->
    forward with training BN -> Chamfer(recon, complete) averaged over the
    rows ``batch["pad"]`` does not mark -> Adam. ``batch["complete_pc"]``
    is (B, N, 3). Updates ``params`` in place; returns (new BN state,
    {"loss": 0-d tensor}). ``compute_dtype=torch.bfloat16`` rounds the
    matmul operands and activations to bf16 (f32 master weights, BN
    statistics and loss). The folding decoder's loss is PCN's,
    CD(coarse, complete) + alpha(count) CD(fine, complete), with
    ``count`` the updates before this one (the scheduler's count; alpha
    1 without ``alpha``). Under ``mesh`` the batch is this rank's rows
    and ``draws`` the global batch's."""
    with mesh_lib.use(mesh):
        return _ae_train_step(params, bn_state, optimizer, batch,
                              _local(draws), scheduler=scheduler,
                              augment=augment, compute_dtype=compute_dtype,
                              spec=spec, recon_loss=recon_loss,
                              bidirectional=bidirectional,
                              selective=selective, bn_stats=bn_stats,
                              alpha=alpha)


def _ae_train_step(params, bn_state, optimizer, batch, draws, *, scheduler,
                   augment, compute_dtype, spec, recon_loss, bidirectional,
                   selective, bn_stats, alpha):
    """The step in spans (``utils.profiling``): ae.preprocess, ae.encoder,
    ae.decoder (with ae.folding inside it for the folding decoder),
    ae.chamfer, ae.backward (its device time split back onto the chamfer,
    the folding, the decoder and the encoder at the gradients of
    ``recon``, ``coarse`` and ``gfv``) and ae.optimizer."""
    with span("ae.preprocess"):
        complete, incomplete, mask = pc_ops.apply_training_batch(
            batch["complete_pc"], draws, spec=spec, do_augment=augment)
        p, x_in = params, incomplete
        if compute_dtype is not None:
            p = (_policy_cast_ae_selective(p, compute_dtype) if selective
                 else _policy_cast(p, compute_dtype))
            x_in = incomplete.to(compute_dtype)
    optimizer.zero_grad(set_to_none=True)
    # ae.autoencoder_apply, in its two halves
    with span("ae.encoder"):
        gfv, enc_state = ae.any_encoder_apply(
            p["encoder"], bn_state["encoder"], x_in, mask, training=True,
            bn_stats=bn_stats)
    with span("ae.decoder"):
        recon, coarse, dec_state = _decode_train(
            p["decoder"], bn_state["decoder"], gfv, bn_stats)
    with span("ae.chamfer"):
        weight = 1.0 if alpha is None or coarse is None else alpha(
            scheduler.last_epoch if scheduler is not None else 0)
        per = _recon_terms(recon, coarse, complete, weight,
                           recon_loss=recon_loss, bidirectional=bidirectional)
        bounds = ((("ae.chamfer", recon), ("ae.decoder", gfv))
                  if coarse is None else
                  (("ae.chamfer", recon), ("ae.folding", coarse),
                   ("ae.decoder", gfv)))
        loss = _masked_mean(per, batch["pad"])
        _check_finite(loss, "AE loss")
    with span("ae.backward"):
        with backward_spans(bounds, "ae.encoder"):
            loss.backward()
        _sync_grads(optimizer)
    with span("ae.optimizer"):
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    return ({"encoder": enc_state, "decoder": dec_state},
            {"loss": _total(loss)})


@torch.no_grad()
def ae_eval_step(params: dict, bn_state: dict, batch: Dict[str, Tensor],
                 draws: Dict[str, Tensor], *,
                 spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                 recon_loss: str = "chamfer", bidirectional: bool = True,
                 mesh: Optional[mesh_lib.Mesh] = None) -> Dict[str, Tensor]:
    """Validation (steps.py:169-184): holes from ``draws``, no
    augmentation, eval-mode BN."""
    with mesh_lib.use(mesh):
        complete, incomplete, mask = pc_ops.apply_training_batch(
            batch["complete_pc"], _local(draws), spec=spec,
            do_augment=False)
        (recon, _), _ = ae.autoencoder_apply(params, bn_state, incomplete,
                                             mask, training=False)
        per = _recon_loss(recon, complete, recon_loss=recon_loss,
                          bidirectional=bidirectional)
        return {"loss": _total(_masked_mean(per, batch["pad"]))}


def ae_train_epoch(params: dict, bn_state: dict, optimizer, scheduler,
                   data: Tensor, order: Tensor, pads: Tensor,
                   generator: torch.Generator, *,
                   spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                   data_sharded: bool = False,
                   mesh: Optional[mesh_lib.Mesh] = None,
                   input_points: Optional[int] = None,
                   **step_kw) -> Tuple[dict, Dict[str, Tensor]]:
    """One epoch over a device-resident train split (the Python-loop form
    of ae_train_epoch_resident, steps.py:282-330): ``data`` (D, N, 3) on
    the device, ``order`` (S, B) row indices and ``pads`` (S, B). Each step
    gathers its batch on the device and draws its transforms from
    ``generator`` (``draw_training_batch``; with ``input_points`` the
    input is that many rows of each target, PCN's). Returns (BN state,
    {"losses": (S,) tensor}). Under ``mesh`` the plan is the global one
    and each rank takes its slots; with ``data_sharded`` ``data`` is this
    rank's row block (``mesh.row_sharding``)."""
    losses = []
    for idx, pad in zip(order, pads):
        with span("ae.step"):
            with span("ae.batch"):
                # the global batch's draws; the step keeps this rank's rows
                draws = pc_ops.draw_training_batch(
                    generator, idx.shape[0], data.shape[1], spec=spec,
                    input_points=input_points)
                with mesh_lib.use(mesh):
                    complete = _resident_batch(data, _local(idx),
                                               data_sharded)
            bn_state, m = ae_train_step(
                params, bn_state, optimizer,
                {"complete_pc": complete,
                 "pad": mesh_lib.local_rows(mesh, pad)},
                draws, scheduler=scheduler, spec=spec, mesh=mesh, **step_kw)
        losses.append(m["loss"])
    return bn_state, {"losses": torch.stack(losses) if losses
                      else torch.zeros(0)}


# ---------------------------------------------------------------------------
# Phase 2: GFV extraction
# ---------------------------------------------------------------------------


@torch.no_grad()
def gfv_extract_step(params: dict, bn_state: dict, batch: Dict[str, Tensor],
                     draws: Dict[str, Tensor], *,
                     spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                     mesh: Optional[mesh_lib.Mesh] = None
                     ) -> Tuple[Tensor, Tensor]:
    """(clean GFV, noisy GFV) of one batch with the frozen eval-mode
    encoder; holes from ``draws`` (draw_training_batch with
    augment=False), no augmentation (steps.py:339-352). With PCN's
    ``subsample`` draws the clean GFV encodes the input's rows before the
    hole (``pc_ops.input_rows``). Under ``mesh``
    each rank encodes its rows and the GFVs are gathered whole."""
    with mesh_lib.use(mesh):
        complete, incomplete, mask = pc_ops.apply_training_batch(
            batch["complete_pc"], _local(draws), spec=spec,
            do_augment=False)
        enc_p, enc_s = params["encoder"], bn_state["encoder"]
        clean_in = pc_ops.input_rows(complete, _local(draws))
        mesh = mesh_lib.active()
        return (collectives.gather_rows(
                    ae.any_encoder_apply(enc_p, enc_s, clean_in)[0], mesh),
                collectives.gather_rows(
                    ae.any_encoder_apply(enc_p, enc_s, incomplete, mask)[0],
                    mesh))


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
                lambda_gp: float = 10.0,
                mesh: Optional[mesh_lib.Mesh] = None
                ) -> Tuple[dict, Dict[str, Tensor]]:
    """One discriminator step: WGAN loss + gradient penalty, Adam on D's
    parameters in place (steps.py:364-420). The fakes come from the
    training-mode generator without a gradient, so its BN statistics
    advance; D runs on the real, fake and interpolated batches, each call
    starting from the previous call's spectral-norm state, and the state
    kept is the fake call's. Returns (new state, {"d_loss", "wasserstein",
    "gp"}). Under ``mesh`` ``real_gfv`` is this rank's rows and ``draws``
    the global batch's; the generator's BN statistics cross the data group
    under no_grad, so the penalty's double backward crosses nothing."""
    with mesh_lib.use(mesh):
        return _lgan_d_step(lgan_params, lgan_state, d_opt, real_gfv,
                            _local(draws), lambda_gp)


def _lgan_d_step(lgan_params, lgan_state, d_opt, real_gfv, draws, lambda_gp):
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
    w_loss = _share(losses_ops.discriminator_loss(real_scores, fake_scores))
    gp = _share(gp)
    d_loss = w_loss + gp
    _check_finite(d_loss, "D loss")
    grad_step(d_opt, d_loss, d_params)
    return ({"generator": gen_state, "discriminator": d_s2},
            {"d_loss": _total(d_loss), "wasserstein": -_total(w_loss),
             "gp": _total(gp)})


def lgan_generator_step(lgan_params: dict, lgan_state: dict,
                        g_opt: torch.optim.Adam, draws: Dict[str, object],
                        *, mesh: Optional[mesh_lib.Mesh] = None
                        ) -> Tuple[dict, Dict[str, Tensor]]:
    """One generator step against the training-mode discriminator, Adam on
    G's parameters in place; both states advance (steps.py:423-455)."""
    with mesh_lib.use(mesh):
        return _lgan_generator_step(lgan_params, lgan_state, g_opt,
                                    _local(draws))


def _lgan_generator_step(lgan_params, lgan_state, g_opt, draws):
    fake, g_state = lg.generator_apply(
        lgan_params["generator"], lgan_state["generator"], draws["z"],
        training=True)
    scores, d_state = lg.discriminator_apply(
        lgan_params["discriminator"], lgan_state["discriminator"], fake,
        training=True, keep_masks=draws["keep"])
    g_loss = _share(losses_ops.generator_loss(scores))
    _check_finite(g_loss, "G loss")
    grad_step(g_opt, g_loss, lgan_params["generator"])
    return ({"generator": g_state, "discriminator": d_state},
            {"g_loss": _total(g_loss)})


def _d_steps(lgan_params, lgan_state, d_opt, real_gfvs, d_draws, lambda_gp,
             mesh) -> Tuple[dict, List[Tensor]]:
    losses = []
    for real, draws in zip(real_gfvs, d_draws):
        lgan_state, m = lgan_d_step(lgan_params, lgan_state, d_opt, real,
                                    draws, lambda_gp=lambda_gp, mesh=mesh)
        losses.append(m["d_loss"])
    return lgan_state, losses


def lgan_combined_step(lgan_params: dict, lgan_state: dict,
                       d_opt: torch.optim.Adam, g_opt: torch.optim.Adam,
                       real_gfvs: Tensor, draws: Dict[str, object], *,
                       lambda_gp: float = 10.0,
                       mesh: Optional[mesh_lib.Mesh] = None
                       ) -> Tuple[dict, Dict[str, Tensor]]:
    """``real_gfvs`` (d_steps, B, latent): one D step per real batch, then
    one G step (steps.py:458-506). Returns (new state, {"d_loss" (their
    mean), "g_loss"}). Under ``mesh`` ``real_gfvs`` holds this rank's rows
    along axis 1 and ``draws`` the global batch's."""
    lgan_state, d_losses = _d_steps(lgan_params, lgan_state, d_opt,
                                    real_gfvs, draws["d"], lambda_gp, mesh)
    lgan_state, gm = lgan_generator_step(lgan_params, lgan_state, g_opt,
                                         draws["g"], mesh=mesh)
    return lgan_state, {"d_loss": torch.stack(d_losses).mean(),
                        "g_loss": gm["g_loss"]}


def lgan_d_refresh(lgan_params: dict, lgan_state: dict,
                   d_opt: torch.optim.Adam, real_gfvs: Tensor,
                   d_draws: Sequence[Dict[str, object]], *,
                   lambda_gp: float = 10.0,
                   mesh: Optional[mesh_lib.Mesh] = None
                   ) -> Tuple[dict, Dict[str, Tensor]]:
    """K D steps with the generator frozen, ``real_gfvs`` (K, B, latent)
    (steps.py:509-545). Returns (new state, {"d_losses" (K,)})."""
    lgan_state, losses = _d_steps(lgan_params, lgan_state, d_opt, real_gfvs,
                                  d_draws, lambda_gp, mesh)
    return lgan_state, {"d_losses": torch.stack(losses)}


# ---------------------------------------------------------------------------
# Phase 4: RL (batched environments, replay ring, TD3 updates)
# ---------------------------------------------------------------------------


def draw_rl_step(generator: torch.Generator, bsz: int, n: int, *,
                 cfg: rl.TD3Config, buffer_size: int,
                 steps_per_episode: int = 1, updates_per_step: int = 1,
                 spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                 input_points: Optional[int] = None
                 ) -> Dict[str, object]:
    """The draws of one ``rl_step`` over ``bsz`` environments: ``holes``
    (draw_training_batch without augmentation, with ``input_points`` if
    given), ``ou`` (S, B, action_dim)
    standard normals, one per environment step; per TD3 update ``sample``
    (U, batch_size) buffer rows uniform over the ``buffer_size`` valid
    rows after this step's push, and ``noise`` (U, batch_size,
    action_dim), the target-policy smoothing's standard normal."""
    kw = dict(generator=generator, device=generator.device)
    u = updates_per_step
    return {
        "holes": pc_ops.draw_training_batch(generator, bsz, n, spec=spec,
                                            augment=False,
                                            input_points=input_points),
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
            spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
            mesh: Optional[mesh_lib.Mesh] = None
            ) -> Tuple[dict, ReplayBuffer, Tensor, Dict[str, Tensor]]:
    """One RL iteration over B parallel episodes of ``steps_per_episode``
    environment steps (steps.py:554-648): cut holes -> env_reset ->
    [actor + OU -> env_step] per step -> push B * S transitions (step
    major) -> ``updates_per_step`` TD3 updates once the buffer holds
    max(start_training_size, batch_size). Updates the agent and the
    buffer in place; returns (model, buffer, new OU state, {"critic_loss",
    "actor_loss" (the last update's, 0 without updates), "reward" (the
    mean episode reward over the rows ``batch["pad"]`` does not mark)}).
    Under ``mesh`` the environments are sharded: ``batch`` is this rank's
    rows, ``draws`` and ``ou_states`` the global batch's. Each step's
    transitions are gathered in rank order, so every rank pushes the
    single-device ring's rows, and the TD3 updates, drawn alike, run
    replicated on every rank; the OU state comes back whole."""
    with torch.no_grad(), mesh_lib.use(mesh):
        holes = _local(draws["holes"])
        complete, incomplete, mask = pc_ops.apply_training_batch(
            batch["complete_pc"], holes, spec=spec, do_augment=False)
        ou_normal = mesh_lib.local_rows(mesh, draws["ou"], axis=1)
        env = net.env_reset(model, incomplete, complete, mask,
                            target_input=pc_ops.input_rows(complete, holes))
        ou, transitions, rewards = _local(ou_states), [], []
        for i in range(steps_per_episode):
            action, ou = rl.select_action(model["agent"], env.state, cfg,
                                          ou_state=ou, add_noise=True,
                                          normal=ou_normal[i])
            env_next, r, _, _ = net.env_step(
                model, env, action, w_chamfer=w_chamfer, w_gfv=w_gfv,
                w_discriminator=w_discriminator)
            done = torch.full_like(r, float(i == steps_per_episode - 1))
            transitions.append(tuple(
                collectives.gather_rows(f, mesh)
                for f in (env.state, action, r[:, None], env_next.state,
                          done[:, None])))
            rewards.append(r)
            env = env_next
        _check_finite(torch.stack(rewards), "RL reward")
        buffer.add_batch(rl.TransitionBatch(
            *(torch.cat(f) for f in zip(*transitions))))
        ou = collectives.gather_rows(ou, mesh)
        reward = _total(_masked_mean(torch.stack(rewards).sum(0),
                                     batch["pad"]))
    zero = torch.zeros((), device=ou.device)
    metrics = {"critic_loss": zero, "actor_loss": zero}
    with mesh_lib.use(None):  # the TD3 update is replicated
        for u in range(updates_per_step
                       if buffer.size >= max(start_training_size,
                                             cfg.batch_size) else 0):
            _, metrics = rl.agent_update(
                model["agent"], buffer.sample(draws["sample"][u]),
                draws["noise"][u], cfg)
            _check_finite(metrics["critic_loss"], "critic loss")
    metrics = dict(metrics, reward=reward)
    return model, buffer, ou, metrics


@torch.no_grad()
def rl_eval_reward(model: dict, batch: Dict[str, Tensor],
                   draws: Dict[str, Tensor], *, cfg: rl.TD3Config,
                   w_chamfer: float = 100.0, w_gfv: float = 10.0,
                   w_discriminator: float = 0.01,
                   spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                   mesh: Optional[mesh_lib.Mesh] = None
                   ) -> Dict[str, Tensor]:
    """Greedy single-step reward and Chamfer distance of the completions on
    a fixed batch with fixed holes ``draws`` (steps.py:651-685)."""
    with mesh_lib.use(mesh):
        holes = _local(draws)
        complete, incomplete, mask = pc_ops.apply_training_batch(
            batch["complete_pc"], holes, spec=spec, do_augment=False)
        env0 = net.env_reset(model, incomplete, complete, mask,
                             target_input=pc_ops.input_rows(complete, holes))
        action, _ = rl.select_action(model["agent"], env0.state, cfg)
        _, rewards, _, info = net.env_step(
            model, env0, action, w_chamfer=w_chamfer, w_gfv=w_gfv,
            w_discriminator=w_discriminator)
        per_cd = chamfer.chamfer_distance(info["completed_pc"],
                                          env0.target_pc)
        return {"reward": _total(_masked_mean(rewards, batch["pad"])),
                "chamfer": _total(_masked_mean(per_cd, batch["pad"]))}


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
                     freeze_generator: bool = False,
                     fine_weight: float = 1.0,
                     mesh: Optional[mesh_lib.Mesh] = None
                     ) -> Tuple[dict, Dict[str, Tensor]]:
    """One joint fine-tune step (steps.py:695-809): holes with
    augmentation -> encoder in training mode -> z from the actor in eval
    mode with no gradient -> G (training mode, or eval mode when
    ``freeze_generator``) -> decoder in training mode -> loss =
    Chamfer(decode(G(z)), complete) + 0.1 * MSE(clean GFV, noisy GFV),
    whose MSE gradient reaches both GFVs. With ``w_ae_recon`` > 0 both GFVs
    go through one (2B, .) decoder pass and w * Chamfer(decode(noisy GFV),
    complete) joins the loss. The folding decoder's Chamfer terms are
    PCN's, Chamfer(coarse) + ``fine_weight`` * Chamfer(fine), and its
    input PCN's (``subsample`` draws). ``optimizer`` holds the trainable
    leaves
    (``joint_trainable``) and updates them in place. Returns (the model
    with the new BN states of the encoder, decoder and generator, {"loss",
    "chamfer", "gfv"}); a frozen G keeps its parameters and state. Under
    ``mesh`` the batch is this rank's rows and ``draws`` the global
    batch's; the (2B, .) decoder pass concatenates two sharded batches
    (``mesh.segments``)."""
    with mesh_lib.use(mesh):
        return _joint_train_step(
            model, optimizer, batch, _local(draws), cfg=cfg,
            compute_dtype=compute_dtype, spec=spec,
            bidirectional=bidirectional, w_ae_recon=w_ae_recon,
            selective=selective, bn_stats=bn_stats,
            freeze_generator=freeze_generator, fine_weight=fine_weight)


def _joint_train_step(model, optimizer, batch, draws, *, cfg, compute_dtype,
                      spec, bidirectional, w_ae_recon, selective, bn_stats,
                      freeze_generator, fine_weight):
    complete, incomplete, mask = pc_ops.apply_training_batch(
        batch["complete_pc"], draws, spec=spec, do_augment=True)
    ae_p = model["ae"]["params"]
    gen_p = model["lgan"]["params"]["generator"]
    if freeze_generator:
        gen_p = tree_map(lambda v: mesh_lib.keep_mark(v, v.detach()), gen_p)
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
        with mesh_lib.segments(2):
            both, both_coarse, dec_s = _decode_train(
                ae_p["decoder"], ae_s["decoder"],
                torch.cat([clean_gfv, noisy_gfv], dim=0), bn_stats)
        completed, ae_recon = both[:bsz], both[bsz:]
        coarse, ae_coarse = ((None, None) if both_coarse is None else
                             (both_coarse[:bsz], both_coarse[bsz:]))
    else:
        completed, coarse, dec_s = _decode_train(
            ae_p["decoder"], ae_s["decoder"], clean_gfv, bn_stats)

    def recon_term(recon, recon_coarse):
        return _masked_mean(_recon_terms(
            recon, recon_coarse, complete, fine_weight, recon_loss="chamfer",
            bidirectional=bidirectional), batch["pad"])

    ch = recon_term(completed, coarse)
    gl = _share(losses_ops.gfv_loss(clean_gfv, noisy_gfv))
    loss = ch + 0.1 * gl
    if w_ae_recon > 0.0:
        loss = loss + w_ae_recon * recon_term(ae_recon, ae_coarse)
    _check_finite(loss, "joint loss")
    loss.backward()
    _sync_grads(optimizer)
    optimizer.step()
    lgan = model["lgan"]
    new_model = dict(model)
    new_model["ae"] = {"params": model["ae"]["params"],
                       "state": {"encoder": enc_s, "decoder": dec_s}}
    new_model["lgan"] = {
        "params": lgan["params"],
        "state": {"generator": gen_s if freeze_generator else new_gen_s,
                  "discriminator": lgan["state"]["discriminator"]}}
    return new_model, {"loss": _total(loss), "chamfer": _total(ch),
                       "gfv": _total(gl)}


def joint_train_epoch(model: dict, optimizer: torch.optim.Optimizer,
                      data: Tensor, order: Tensor, pads: Tensor,
                      generator: torch.Generator, *,
                      spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                      data_sharded: bool = False,
                      mesh: Optional[mesh_lib.Mesh] = None,
                      input_points: Optional[int] = None,
                      **step_kw) -> Tuple[dict, Dict[str, Tensor]]:
    """One joint epoch over a device-resident train split (the loop form
    of joint_train_epoch_resident, steps.py:812-857), as ae_train_epoch:
    each step gathers its batch on the device and draws its transforms
    from ``generator`` (with ``input_points``, PCN's input). Returns
    (model, {"losses": (S,) tensor})."""
    losses = []
    for idx, pad in zip(order, pads):
        # the global batch's draws; the step keeps this rank's rows
        draws = pc_ops.draw_training_batch(generator, idx.shape[0],
                                           data.shape[1], spec=spec,
                                           input_points=input_points)
        with mesh_lib.use(mesh):
            complete = _resident_batch(data, _local(idx), data_sharded)
        model, m = joint_train_step(
            model, optimizer,
            {"complete_pc": complete, "pad": mesh_lib.local_rows(mesh, pad)},
            draws, spec=spec, mesh=mesh, **step_kw)
        losses.append(m["loss"])
    return model, {"losses": torch.stack(losses) if losses
                   else torch.zeros(0)}


@torch.no_grad()
def joint_eval_step(model: dict, batch: Dict[str, Tensor],
                    draws: Dict[str, Tensor], *, cfg: rl.TD3Config,
                    spec: pc_ops.PreprocSpec = pc_ops.DEFAULT_PREPROC,
                    bidirectional: bool = True,
                    gate_mode: str = "discriminator",
                    gate_bias: float = 0.0,
                    mesh: Optional[mesh_lib.Mesh] = None
                    ) -> Dict[str, Tensor]:
    """Validation through ``complete`` with the hybrid gate, holes from
    ``draws``, no augmentation: the masked mean Chamfer distance of the
    hybrid output (steps.py:860-879)."""
    with mesh_lib.use(mesh):
        complete, incomplete, mask = pc_ops.apply_training_batch(
            batch["complete_pc"], _local(draws), spec=spec,
            do_augment=False)
        out = net.complete(model, incomplete, mask, cfg=cfg,
                           gate_mode=gate_mode, gate_bias=gate_bias)
        per = chamfer.chamfer_distance(out["hybrid_output"], complete,
                                       bidirectional=bidirectional)
        return {"loss": _total(_masked_mean(per, batch["pad"]))}
