"""Autoencoder training over a split that stays on the card: epochs of
``ae_train_epoch``, each over a fresh shuffled plan, as the trainer runs
phase 1.

Set-up makes the weights (at their initial values) and the split of
synthetic clouds from the seed, on the card, builds the optimizer and its
schedule, and drives the first three steps of the first epoch through
``ae_train_epoch`` itself: one step, then two. From them it keeps each
step's loss, the first gradient as the optimizer gets it (read from the
parameters' ``.grad`` by a step pre-hook, which any ``torch.optim``
optimizer runs), and the parameters and BatchNorm state after the third
step. The window goes on with the same objects from the fourth step;
each epoch ends as the trainer's does, with its losses read on the host.
After the window it keeps the optimizer's learning rate and the number of
steps run, and the reference runs the same three steps from the same
weights, batches and draws, and works out the schedule's rate after as
many steps.

The reference replays the program's draws: ``draw_training_batch``'s
order and shapes of draws from the step's generator are a contract that a
change to the program keeps (``reference/train.py::draw_step``).
"""

import sys
import time
from typing import Dict

import torch

from perfbench import shapes, weights
from perfbench.reference import nets, set_tf32
from perfbench.reference import train as ref_train
from perfbench.trace import Phases, reset_peak, sync, traced

Tensor = torch.Tensor
CHECKED_STEPS = 3
# leaves whose reference gradient is under this share of the median
# leaf's are nought to rounding (a dense bias ahead of a training
# BatchNorm): Adam moves them by round-off alone, so their change is not
# compared
NOUGHT = 1e-3


class Run:
    def __init__(self, cell, device: torch.device):
        self.phases = Phases(device)
        from gan_rl_3d_tpu_torch.config import AETrainConfig
        from gan_rl_3d_tpu_torch.device import resolve_device
        from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
        from gan_rl_3d_tpu_torch.train import steps

        resolve_device(device)
        self.phases("program import")
        self.steps, self.device, self.cell = steps, device, cell
        cfg, tr = cell.config, cell.traffic
        ae, opt, data = (cfg["model"]["autoencoder"],
                         cfg["training"]["autoencoder"], cfg["data"])
        self.batch, self.split = tr["batch"], tr["split"]
        self.spe = self.split // self.batch
        self.points = ae["num_points"]
        self.trace_steps = tr["trace_steps"]
        tree = weights.build(weights.ae_spec(ae, fresh=True),
                             weights.generator(device,
                                               cell.seed_for("weights")))
        self.start = tree["ae"]
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
        self.opt, self.sched = steps.make_ae_optimizer(
            self.params, AETrainConfig(
                epochs=opt["epochs"], batch_size=self.batch, lr=opt["lr"],
                weight_decay=opt["weight_decay"],
                scheduler_step=opt["scheduler_step"],
                scheduler_gamma=opt["scheduler_gamma"],
                lr_schedule=opt["lr_schedule"]), self.spe)
        aug = data["augmentation"]
        self.step_kw = dict(
            spec=pc_ops.PreprocSpec(
                rotation=aug["rotation"], jitter=aug["jitter"],
                scale=aug["scale"], normalize=data["normalize"],
                center=data["center"], unit_sphere=data["unit_sphere"],
                hole_min=data["hole_min_ratio"],
                hole_max=data["hole_max_ratio"]),
            bn_stats=cfg["training"]["bn_stats"], compute_dtype=None,
            selective=False, recon_loss="chamfer", bidirectional=True)
        self.draws = weights.generator(device, cell.seed_for("draws"))
        self.order = self._plan()
        self.pads = torch.zeros(self.order.shape, device=device)
        self.first_rows = self.order[:CHECKED_STEPS]
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
        losses.append(self._epoch(self.order[1:CHECKED_STEPS]))
        self.losses = torch.cat(losses).to(device)
        self.after = {k: v.detach().clone()
                      for k, v in nets.leaves(self.params)}
        self.after_state = {k: v.clone() for k, v in nets.leaves(self.state)}
        self.next = CHECKED_STEPS
        self.phases("steps 2-3")

    def _take_first_gradient(self):
        """Keep each leaf's ``.grad`` as the optimizer's next step finds
        it; returns the hook's handle."""
        names = {id(v): k for k, v in nets.leaves(self.params)}
        self.first_grad: Dict[str, Tensor] = {}

        def take(opt, args, kwargs):
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None and id(p) in names:
                        self.first_grad[names[id(p)]] = p.grad.detach() \
                            .clone()

        return self.opt.register_step_pre_hook(take)

    def _plan(self) -> Tensor:
        """One epoch's shuffled plan (steps, batch) of split rows."""
        perm = torch.randperm(self.split, generator=self.plan_gen)
        return perm[:self.spe * self.batch].view(self.spe, self.batch) \
            .to(self.device)

    def _epoch(self, order: Tensor) -> Tensor:
        """``ae_train_epoch`` over ``order``'s steps; the losses read on
        the host, as the trainer reads them."""
        self.state, m = self.steps.ae_train_epoch(
            self.params, self.state, self.opt, self.sched, self.data, order,
            self.pads[:len(order)], self.draws, **self.step_kw)
        self.count += len(order)
        return m["losses"].cpu()

    def _steps(self, count: int) -> int:
        """Run ``count`` more steps, epoch by epoch; returns steps run."""
        done = 0
        while done < count:
            if self.next == self.spe:
                self.order, self.next = self._plan(), 0
            take = min(count - done, self.spe - self.next)
            self._epoch(self.order[self.next:self.next + take])
            self.next += take
            done += take
        return done

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t_first = time.time()
        t0 = time.perf_counter()
        steps = 0
        while True:
            # the rest of the epoch under way, or a whole one
            steps += self._steps(self.spe - self.next or self.spe)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        window_s = time.perf_counter() - t0
        return {"t_first": t_first, "attempted": steps, "failed": 0,
                "metrics": {"ae_train_throughput":
                            steps * self.batch / window_s}}

    def trace(self) -> dict:
        """``trace_steps`` steps to warm up, as many on the host clock
        alone, then as many more traced (``trace.traced``)."""
        t_first = time.time()
        n = self.trace_steps
        # each pass's kept points: the hole ratios of its steps' draws,
        # replayed from a copy of the generator
        replay = torch.Generator(device=self.device)
        replay.set_state(self.draws.get_state())
        kept = []
        for _ in range(3 * n):
            d = ref_train.draw_step(replay, self.batch, self.points,
                                    self.step_kw["spec"].hole_min,
                                    self.step_kw["spec"].hole_max)
            kept.append(int(torch.floor(self.points
                                        * (1.0 - d["ratio"])).sum()))
        tr = traced(lambda: self._steps(n), self.device)
        return {"t_first": t_first, "attempted": 3 * n, "failed": 0,
                "trace": tr, "steps": n, "clouds": n * self.batch,
                "points": self.points, "timed_kept_points": kept[n:2 * n],
                "kept_points": kept[2 * n:]}

    def answers(self) -> dict:
        """The three checked steps' readings, and the learning rate of
        each parameter group after the last step; the program's
        parameters, optimizer and state are freed."""
        lr = [float(g["lr"]) for g in self.opt.param_groups]
        self.params = self.state = self.opt = self.sched = None
        return {"losses": self.losses, "first_grad": self.first_grad,
                "params": self.after, "state": self.after_state, "lr": lr}

    def reference(self, tf32: bool) -> dict:
        set_tf32(tf32)
        try:
            return ref_train.train_steps(
                self.start["params"], self.start["state"],
                [self.data[rows] for rows in self.first_rows],
                weights.generator(self.device, self.cell.seed_for("draws")),
                self.cell.config, self.spe) | {
                    "start": self.start, "lr": [self._schedule_lr()]}
        finally:
            set_tf32(False)

    def _schedule_lr(self) -> float:
        """The configured rate after the steps this run took."""
        opt = self.cell.config["training"]["autoencoder"]
        return opt["lr"] * ref_train.lr_factor(self.count, self.spe, opt)


def _norms(flat: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in flat.items()}


def _gaps(got: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap between the two norms, against the larger of that
    leaf's reference norm and the median leaf's."""
    median = sorted(ref.values())[len(ref) // 2]
    return {k: abs(got[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in ref}


def _worst(got: Dict[str, float], ref: Dict[str, float]) -> tuple:
    """(the worst leaf's gap, that leaf, the median leaf's gap)."""
    gaps = _gaps(got, ref)
    k = max(gaps, key=gaps.get)
    return gaps[k], k, sorted(gaps.values())[len(gaps) // 2]


def numbers(got: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``: the widest relative gap of a checked step's loss;
    ``loss1_gap``: the first step's alone.
    ``grad_gap``: the first gradient's norm, by the worst leaf.
    ``lr_gap``: the widest relative gap between a parameter group's
    learning rate after the run and the schedule's.
    ``update_gap``: the norm of the parameters' change over the checked
    steps, by the worst leaf, leaves nought to rounding left out.
    ``bn_gap``: the norm of the BatchNorm running statistics' change, by
    the worst leaf. The ``*_median`` readings are the median leaf's gap."""
    start_p = dict(nets.leaves(ref["start"]["params"]))
    start_s = dict(nets.leaves(ref["start"]["state"]))
    loss_gaps = ((got["losses"].double() - ref["losses"].double()).abs()
                 / ref["losses"].double().abs())
    grad_gap, grad_leaf, grad_median = _worst(_norms(got["first_grad"]),
                                              _norms(ref["first_grad"]))
    raw = _norms(ref["first_grad"])
    median = sorted(raw.values())[len(raw) // 2]
    moved = [k for k, v in raw.items() if v >= NOUGHT * median]
    update_gap, update_leaf, update_median = _worst(
        _norms({k: got["params"][k] - start_p[k] for k in moved}),
        _norms({k: ref["params"][k] - start_p[k] for k in moved}))
    bn_gap, bn_leaf, bn_median = _worst(
        _norms({k: got["state"][k] - start_s[k] for k in start_s}),
        _norms({k: ref["state"][k] - start_s[k] for k in start_s}))
    lr_gap = max(abs(x / ref["lr"][0] - 1.0) for x in got["lr"])
    print(f"train gaps: learning rate {got['lr']} against {ref['lr']}; "
          f"losses {got['losses'].tolist()} against "
          f"{ref['losses'].tolist()}; worst leaves: gradient {grad_leaf}, "
          f"update {update_leaf}, BatchNorm {bn_leaf}; "
          f"{len(raw) - len(moved)} leaves nought to rounding: "
          f"{sorted(set(raw) - set(moved))}", file=sys.stderr)
    return {"loss_gap": float(loss_gaps.max()),
            "loss1_gap": float(loss_gaps[0]), "grad_gap": grad_gap,
            "update_gap": update_gap, "bn_gap": bn_gap, "lr_gap": lr_gap,
            "grad_gap_median": grad_median,
            "update_gap_median": update_median, "bn_gap_median": bn_median}
