"""PCN's training over a split that stays on the card: epochs of
``ae_train_epoch`` with the folding decoder's loss, each over a fresh
shuffled plan, as the trainer runs phase 1 for ``configs/config_pcn.yaml``.

The run is ``train_ae_epochs``'s (its set-up order, the three checked
steps, the window, the traced passes), with PCN's inputs: Glorot-uniform
weights and zero biases drawn from the seed, a split of ``split`` synthetic
clouds of ``gt_points`` points, each step's input ``input_points`` rows
drawn from its targets with a hole cut from them, and the staircase
learning rate with the alpha schedule. The traffic gives the decoder's
``num_coarse``, so that the CPU tests can cut it with ``gt_points``.

The reference (``reference/pcn.py``) replays the program's draws:
``draw_training_batch``'s order and shapes with ``input_points`` are a
contract that a change to the program keeps.
"""

import math
import sys
import time
from typing import Dict

import torch

from perfbench import shapes, weights
from perfbench.modes import train_ae_epochs as base
from perfbench.reference import nets, set_tf32
from perfbench.reference import pcn as ref_pcn
from perfbench.trace import Phases, reset_peak, traced

Tensor = torch.Tensor


def pcn_spec(ae: dict) -> weights.Spec:
    """Leaves of PCN under ("ae", "params", ...): Glorot-uniform weights
    (+-sqrt(6 / (fan_in + fan_out))) and zero biases."""
    spec: weights.Spec = []

    def stack(path, d_in, dims):
        for i, d_out in enumerate(dims):
            bound = math.sqrt(6.0 / (d_in + d_out))
            spec.append((path + (i, "w"), (d_in, d_out), -bound, bound))
            spec.append((path + (i, "b"), (d_out,), 0.0, 0.0))
            d_in = d_out

    p = ("ae", "params")
    dims = ae["encoder_dims"]
    stack(p + ("encoder", "stage0"), ae["input_dim"], dims[:2])
    stack(p + ("encoder", "stage1"), 2 * dims[1], dims[2:])
    coarse = list(ae["decoder_dims"][:-1]) + [3 * ae["num_coarse"]]
    stack(p + ("decoder", "coarse"), ae["latent_dim"], coarse)
    stack(p + ("decoder", "folding"), 5 + ae["latent_dim"],
          list(ae["folding_dims"]) + [3])
    return spec


class Run(base.Run):
    def __init__(self, cell, device: torch.device):
        self.phases = Phases(device)
        # first, so that a program without PCN fails at once
        from gan_rl_3d_tpu_torch.models import pcn
        from gan_rl_3d_tpu_torch.config import AETrainConfig
        from gan_rl_3d_tpu_torch.device import resolve_device
        from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
        from gan_rl_3d_tpu_torch.train import steps

        resolve_device(device)
        self.phases("program import")
        self.steps, self.device, self.cell = steps, device, cell
        cfg, tr = cell.config, cell.traffic
        opt, data = cfg["training"]["autoencoder"], cfg["data"]
        self.ae = dict(cfg["model"]["autoencoder"],
                       num_coarse=tr["num_coarse"])
        self.batch, self.split = tr["batch"], tr["split"]
        self.spe = self.split // self.batch
        self.points, self.input_points = tr["gt_points"], tr["input_points"]
        self.trace_steps = tr["trace_steps"]
        tree = weights.build(pcn_spec(self.ae), weights.generator(
            device, cell.seed_for("weights")))
        grid = pcn.folding_grid(self.ae["grid_size"],
                                self.ae["grid_scale"]).to(device)
        self.start = {"params": tree["ae"]["params"],
                      "state": {"encoder": {}, "decoder": {"grid": grid}}}
        self.phases("weights")
        self.data = shapes.clouds(
            weights.generator(device, cell.seed_for("data")), self.split,
            self.points)
        self.phases("split")
        self.plan_gen = torch.Generator().manual_seed(cell.seed_for("plan"))
        reset_peak(device)
        self.params = weights.tree_map(
            lambda v: v.clone().requires_grad_(True), self.start["params"])
        self.state = weights.tree_map(Tensor.clone, self.start["state"])
        self.recipe = AETrainConfig(
            batch_size=self.batch, lr=opt["lr"],
            weight_decay=opt["weight_decay"], lr_schedule=opt["lr_schedule"],
            scheduler_gamma=opt["scheduler_gamma"],
            decay_steps=opt["decay_steps"], lr_floor=opt["lr_floor"],
            alpha_boundaries=tuple(opt["alpha_boundaries"]),
            alpha_values=tuple(opt["alpha_values"]))
        self.opt, self.sched = steps.make_ae_optimizer(
            self.params, self.recipe, self.spe)
        self.step_kw = dict(
            spec=pc_ops.PreprocSpec(
                rotation=False, jitter=False, scale=False, normalize=False,
                center=False, unit_sphere=False,
                hole_min=data["hole_min_ratio"],
                hole_max=data["hole_max_ratio"]),
            compute_dtype=None, selective=False, recon_loss="chamfer",
            bidirectional=True, input_points=self.input_points,
            alpha=self.recipe.alpha)
        self.draws = weights.generator(device, cell.seed_for("draws"))
        self.order = self._plan()
        self.pads = torch.zeros(self.order.shape, device=device)
        self.first_rows = self.order[:base.CHECKED_STEPS]
        self.count = 0
        self.phases("optimizer")
        hook = self._take_first_gradient()
        losses = [self._epoch(self.order[:1])]
        hook.remove()
        self.phases("first step")
        missing = sorted(set(k for k, _ in nets.leaves(self.params))
                         - set(self.first_grad))
        if missing:
            raise RuntimeError(f"no gradient reached the optimizer for "
                               f"{missing}")
        losses.append(self._epoch(self.order[1:base.CHECKED_STEPS]))
        self.losses = torch.cat(losses).to(device)
        self.after = {k: v.detach().clone()
                      for k, v in nets.leaves(self.params)}
        self.after_state = {}
        self.next = base.CHECKED_STEPS
        self.phases("steps 2-3")

    def trace(self) -> dict:
        """``trace_steps`` steps to warm up, as many on the host clock
        alone, then as many more traced (``trace.traced``)."""
        t_first = time.time()
        n = self.trace_steps
        replay = torch.Generator(device=self.device)
        replay.set_state(self.draws.get_state())
        hole = self.step_kw["spec"]
        kept = []
        for _ in range(3 * n):
            d = ref_pcn.draw_step(replay, self.batch, self.points,
                                  self.input_points, hole.hole_min,
                                  hole.hole_max)
            kept.append(int(torch.floor(self.input_points
                                        * (1.0 - d["ratio"])).sum()))
        tr = traced(lambda: self._steps(n), self.device)
        return {"t_first": t_first, "attempted": 3 * n, "failed": 0,
                "trace": tr, "steps": n, "clouds": n * self.batch,
                "points": self.input_points,
                "timed_kept_points": kept[n:2 * n],
                "kept_points": kept[2 * n:]}

    def reference(self, tf32: bool) -> dict:
        set_tf32(tf32)
        try:
            cfg = dict(self.cell.config,
                       model={"autoencoder": self.ae})
            return ref_pcn.train_steps(
                self.start["params"],
                [self.data[rows] for rows in self.first_rows],
                weights.generator(self.device, self.cell.seed_for("draws")),
                cfg, self.input_points) | {
                    "start": self.start, "lr": [self._schedule_lr()]}
        finally:
            set_tf32(False)

    def _schedule_lr(self) -> float:
        """The configured rate after the steps this run took."""
        return ref_pcn.learning_rate(
            self.count, self.cell.config["training"]["autoencoder"])


def numbers(got: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``, ``loss1_gap``, ``grad_gap``, ``update_gap`` and
    ``lr_gap`` as ``train_ae_epochs.numbers`` reads them (PCN has no
    BatchNorm state)."""
    start_p = dict(nets.leaves(ref["start"]["params"]))
    loss_gaps = ((got["losses"].double() - ref["losses"].double()).abs()
                 / ref["losses"].double().abs())
    grad_gap, grad_leaf, grad_median = base._worst(
        base._norms(got["first_grad"]), base._norms(ref["first_grad"]))
    raw = base._norms(ref["first_grad"])
    median = sorted(raw.values())[len(raw) // 2]
    moved = [k for k, v in raw.items() if v >= base.NOUGHT * median]
    update_gap, update_leaf, update_median = base._worst(
        base._norms({k: got["params"][k] - start_p[k] for k in moved}),
        base._norms({k: ref["params"][k] - start_p[k] for k in moved}))
    lr_gap = max(abs(x / ref["lr"][0] - 1.0) for x in got["lr"])
    print(f"train gaps: learning rate {got['lr']} against {ref['lr']}; "
          f"losses {got['losses'].tolist()} against "
          f"{ref['losses'].tolist()}; worst leaves: gradient {grad_leaf}, "
          f"update {update_leaf}; {len(raw) - len(moved)} leaves nought to "
          f"rounding: {sorted(set(raw) - set(moved))}", file=sys.stderr)
    return {"loss_gap": float(loss_gaps.max()),
            "loss1_gap": float(loss_gaps[0]), "grad_gap": grad_gap,
            "update_gap": update_gap, "lr_gap": lr_gap,
            "grad_gap_median": grad_median,
            "update_gap_median": update_median}
