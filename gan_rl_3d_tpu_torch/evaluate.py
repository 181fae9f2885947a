"""Evaluate a trained model on the test split (the port of the root
``evaluate.py``): the configured metrics (chamfer / hausdorff / completion
ratio / f-score / EMD), colored PLY exports of the first batch, a static
results page and, on request, the folded f32 deployment engine and the
reference implementation's ``.pth`` pair (``utils.torch_convert``).

  python -m gan_rl_3d_tpu_torch.evaluate --config configs/config.yaml \
      --checkpoint joint_best [--num-export 6] [--export-engine engine.pkl] \
      [--export-pth model.pth] [--device cuda|cpu]

The attention encoder / adaptive decoder family evaluates through the
unfolded ``complete`` like the other; it has neither an engine nor a
``.pth`` layout, so ``--export-engine`` and ``--export-pth`` refuse it
before the evaluation runs.

Holes are cut by ``make_training_batch(do_augment=False)`` with draws from
one generator seeded 123, batch after batch, so a run is repeatable; the
padded rows of the last batch are left out of every mean.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gan_rl_3d_tpu_torch.config import (EvaluationConfig, flagship_config,
                                        load_config)
from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch.models import inference
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.models.rl_agent import TD3Config
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.ops.metrics import evaluate_completion
from gan_rl_3d_tpu_torch.train.gate import load_gate_calibration
from gan_rl_3d_tpu_torch.utils import ply, torch_convert

Tensor = torch.Tensor
HOLE_SEED = 123
ABLATIONS = ("hybrid", "rl", "zero", "random", "ae_only")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate RL-GAN-Net (PyTorch "
                                            "port)")
    p.add_argument("--config", type=str, default=None,
                   help="YAML (or JSON) config; default: the flagship recipe")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint name under training.checkpoint_dir")
    p.add_argument("--num-export", type=int, default=6,
                   help="how many samples to export as PLY")
    p.add_argument("--output", type=str, default="hybrid_output",
                   choices=["hybrid_output", "completed_pc",
                            "ae_reconstruction"])
    p.add_argument("--export-engine", type=str, default=None,
                   help="also fold the model into an f32 deployment engine "
                        "and save it at this path")
    p.add_argument("--export-pth", type=str, default=None,
                   help="also write the model as the reference "
                        "implementation's .pth pair at this path (and "
                        "*_rl_agent.pth)")
    p.add_argument("--ablate-z", action="store_true",
                   help="also report completion chamfer for the z policies "
                        "rl / zero / random / ae-only / hybrid")
    p.add_argument("--metrics", type=str, default=None,
                   help="comma-separated metric override; default: "
                        "evaluation.metrics from the config")
    p.add_argument("--gate-mode", type=str, default=None,
                   choices=["discriminator", "rl", "ae", "union"],
                   help="force a gate mode over the config and the "
                        "calibration sidecar")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


@torch.no_grad()
def batch_metrics(model: dict, complete_pc: Tensor, incomplete: Tensor,
                  mask: Tensor, *, td3: TD3Config, gate_mode: str,
                  gate_bias: float, output: str, metrics: Sequence[str],
                  eval_cfg: EvaluationConfig) -> tuple:
    """(prediction, per-sample metrics) of one batch: the unfolded
    ``complete`` scored against the complete clouds (evaluate.py:86-133)."""
    pred = net.complete(model, incomplete, mask, cfg=td3,
                        gate_mode=gate_mode, gate_bias=gate_bias)[output]
    return pred, evaluate_completion(
        pred, complete_pc, tuple(metrics),
        fscore_threshold=eval_cfg.fscore_threshold,
        fscore_thresholds=eval_cfg.fscore_thresholds,
        completion_threshold=eval_cfg.completion_threshold, reduce=False)


@torch.no_grad()
def ablation_outputs(model: dict, incomplete: Tensor, mask: Tensor, *,
                     td3: TD3Config, gate_mode: str, gate_bias: float,
                     generator: torch.Generator) -> Dict[str, Tensor]:
    """Completions under five z policies (evaluate.py:91-110): the agent's
    z, zero, uniform random in the action bound (drawn from
    ``generator``), the plain AE path, and the gated hybrid."""
    noisy_gfv = net.encode(model, incomplete, mask)
    z_rl = net.select_z(model, noisy_gfv, td3)
    z_rand = (torch.rand(z_rl.shape, generator=generator,
                         device=z_rl.device) * 2.0 - 1.0) * td3.action_bound
    outs = {name: net.gan_decode(model, net.gan_generate(model, z))
            for name, z in (("rl", z_rl), ("zero", torch.zeros_like(z_rl)),
                            ("random", z_rand))}
    outs["ae_only"] = net.decode(model, noisy_gfv)
    outs["hybrid"] = net.complete(model, incomplete, mask, cfg=td3,
                                  gate_mode=gate_mode,
                                  gate_bias=gate_bias)["hybrid_output"]
    return outs


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = _parser().parse_args(argv)
    from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer

    config = load_config(args.config) if args.config else flagship_config()
    device = resolve_device(args.device)
    trainer = RLGANNetTrainer(config, device=device)
    if args.checkpoint:
        trainer.load_checkpoint(args.checkpoint)
    model = trainer.model
    if args.export_pth:
        torch_convert.check_reference_layout(model["ae"]["params"])
    if args.export_engine:
        inference.check_foldable(model["ae"]["params"])
    td3 = config.td3_config()

    gate_mode, gate_bias = load_gate_calibration(
        config.training.checkpoint_dir, checkpoint=args.checkpoint,
        default_mode=config.model.gate_mode,
        default_bias=config.model.gate_bias, verbose=True)
    if (gate_mode, gate_bias) != (config.model.gate_mode,
                                  config.model.gate_bias):
        print(f"using calibrated gate: mode={gate_mode} bias={gate_bias:.4f}")
    if args.gate_mode is not None:
        gate_mode = args.gate_mode
        print(f"gate mode forced by --gate-mode: {gate_mode}")
    gate = dict(td3=td3, gate_mode=gate_mode, gate_bias=gate_bias)

    metric_names = (tuple(m.strip() for m in args.metrics.split(","))
                    if args.metrics else tuple(config.evaluation.metrics))
    holes = torch.Generator(device).manual_seed(HOLE_SEED)
    z_draws = torch.Generator(device).manual_seed(HOLE_SEED + 7)
    sums: Dict[str, float] = {}
    ablate_sums: Dict[str, float] = {}
    n_samples = 0
    exported = []
    results_dir = Path(config.training.results_dir)

    for i, batch in enumerate(trainer.test_loader):
        complete_pc, incomplete, mask = pc_ops.make_training_batch(
            holes, torch.from_numpy(batch["complete_pc"]).to(device),
            do_augment=False)
        pred, metrics = batch_metrics(
            model, complete_pc, incomplete, mask, output=args.output,
            metrics=metric_names, eval_cfg=config.evaluation, **gate)
        keep = np.asarray(batch["pad"]) == 0
        for m, v in metrics.items():
            sums[m] = sums.get(m, 0.0) + float(v.cpu().numpy()[keep].sum())
        n_samples += int(keep.sum())

        if args.ablate_z:
            outs = ablation_outputs(model, incomplete, mask,
                                    generator=z_draws, **gate)
            for name, pred_ab in outs.items():
                cd = evaluate_completion(pred_ab, complete_pc,
                                         ("chamfer_distance",),
                                         reduce=False)["chamfer_distance"]
                ablate_sums[name] = (ablate_sums.get(name, 0.0)
                                     + float(cd.cpu().numpy()[keep].sum()))

        if i == 0 and config.evaluation.save_visualizations:
            files = trainer.test_loader.dataset.files
            for j in range(min(args.num_export, int(keep.sum()))):
                category = files[j]["category"] if j < len(files) \
                    else "unknown"
                ply.save_completion_sample(
                    str(results_dir / "point_clouds"), j + 1, category,
                    incomplete[j].cpu().numpy(), complete_pc[j].cpu().numpy(),
                    pred[j].float().cpu().numpy(),
                    incomplete_mask=mask[j].cpu().numpy())
                exported.append(f"sample_{j + 1:02d}_{category}")

    stats = {m: v / max(n_samples, 1) for m, v in sums.items()}
    print("\n=== evaluation ===")
    for m, v in stats.items():
        print(f"{m}: {v:.6f}")
    if args.ablate_z:
        print("\n=== z-policy ablation (completion chamfer, lower=better) ===")
        for name in ABLATIONS:
            print(f"{name:>8s}: {ablate_sums[name] / max(n_samples, 1):.6f}")

    html = results_dir / "results_viewer.html"
    ply.write_results_html(str(html), stats, exported)
    print(f"report: {html}")
    if args.export_engine:
        inference.save_engine(args.export_engine,
                              inference.prepare_inference_engine(model))
        print(f"deployment engine: {args.export_engine}")
    if args.export_pth:
        rl_path = torch_convert.export_reference_checkpoint(
            model, args.export_pth, epoch=trainer.epoch or 0, phase="joint")
        print(f"reference .pth pair: {args.export_pth} (+ {rl_path})")
    trainer.close()
    return stats


if __name__ == "__main__":
    main()
