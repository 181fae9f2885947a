"""Bulk serving by one synchronous caller: ``complete_fast`` on the folded
engine, one batch at a time, each call timed from submission until its
outputs are ready on the card.

Set-up makes the model's weights and a pool of distinct batches of
partial scans from the seed, on the card, folds the engine
(``prepare_inference_engine``) and warms it up. The window cycles
through the pool. The outputs of the last call on each batch of the pool
are kept, and after the window the reference completes the same batches
from the same weights.
"""

import sys
import time
from statistics import quantiles
from typing import Dict

import torch

from perfbench import shapes, weights
from perfbench.reference import serve, set_tf32
from perfbench.trace import Phases, reset_peak, sync, traced

Tensor = torch.Tensor
OUTPUTS = ("noisy_gfv", "z_vector", "clean_gfv", "completed_pc",
           "ae_reconstruction", "rl_gan_score", "ae_score")
# A cloud whose reference scores lie within this share of max(1, |score|)
# of the gate's threshold may go either way; its hybrid output is not
# compared (its two candidates are).
TIE = 1e-4
REF_BLOCK = 512


class Run:
    def __init__(self, cell, device: torch.device):
        self.phases = Phases(device)
        from gan_rl_3d_tpu_torch.device import resolve_device
        from gan_rl_3d_tpu_torch.models import inference

        resolve_device(device)
        self.phases("program import")
        self.inference, self.device = inference, device
        cfg, tr = cell.config, cell.traffic
        self.serving = cfg["serving"]
        self.action_bound = cfg["model"]["rl_agent"]["action_bound"]
        self.model = weights.build(
            weights.serving_spec(cfg["model"]),
            weights.generator(device, cell.seed_for("weights")))
        self.phases("weights")
        g = weights.generator(device, cell.seed_for("inputs"))
        self.pool_size, self.batch = tr["pool"], tr["batch"]
        n = cfg["model"]["autoencoder"]["num_points"]
        pc, mask = shapes.partial_scans(
            g, shapes.clouds(g, self.pool_size * self.batch, n),
            cfg["data"]["hole_min_ratio"], cfg["data"]["hole_max_ratio"])
        self.pc = pc.view(self.pool_size, self.batch, n, 3)
        self.mask = mask.view(self.pool_size, self.batch, n)
        self.kept = self.mask.sum(dim=(1, 2)).long().tolist()
        self.phases("scans")
        reset_peak(device)
        prog = weights.tree_map(Tensor.clone, self.model)
        self.engine = inference.prepare_inference_engine(
            {"ae": prog["ae"], "lgan": prog["lgan"],
             "agent": {"actor": prog["actor"]}}, dtype=torch.float32)
        self.phases("engine")
        self.points = n
        self.trace_calls = tr["trace_calls"]
        self.last: Dict[int, dict] = {}
        for i in range(tr["warmup_calls"]):
            self._call(i % self.pool_size)
        self.phases("warm-up calls")

    def _call(self, i: int) -> dict:
        return self.inference.complete_fast(
            self.engine, self.pc[i], self.mask[i], hybrid=True,
            gate_mode=self.serving["gate_mode"],
            gate_bias=self.serving["gate_bias"])

    def _served(self, i: int) -> None:
        """One closed-loop call: submit, wait for the outputs, keep them."""
        k = i % self.pool_size
        self.last[k] = self._call(k)
        sync(self.device)

    def window(self, seconds: float) -> dict:
        latencies = []
        sync(self.device)
        t_first = time.time()
        t0 = time.perf_counter()
        calls = 0
        while True:
            t = time.perf_counter()
            self._served(calls)
            now = time.perf_counter()
            latencies.append(now - t)
            calls += 1
            if now - t0 >= seconds:
                break
        window_s = now - t0
        p95 = (quantiles(latencies, n=100)[94] if len(latencies) > 1
               else latencies[0])
        return {"t_first": t_first, "attempted": calls, "failed": 0,
                "metrics": {
                    "completion_throughput": calls * self.batch / window_s,
                    "completion_p95_ms": 1e3 * p95}}

    def trace(self) -> dict:
        """The same calls three times: to warm up, timed without the
        profiler, then traced (``trace.traced``); every pass serves the
        same batches."""
        t_first = time.time()
        calls = self.trace_calls
        tr = traced(lambda: [self._served(i) for i in range(calls)],
                    self.device)
        kept = [self.kept[i % self.pool_size] for i in range(calls)]
        return {"t_first": t_first, "attempted": 3 * calls, "failed": 0,
                "trace": tr, "steps": calls, "clouds": calls * self.batch,
                "points": self.points, "kept_points": kept,
                "timed_kept_points": kept}

    def answers(self) -> Dict[int, dict]:
        """The kept outputs; the engine is freed."""
        got, self.last, self.engine = self.last, None, None
        self.served = sorted(got)
        return got

    def reference(self, tf32: bool) -> Dict[int, dict]:
        set_tf32(tf32)
        try:
            return {i: serve.complete(self.model, self.pc[i], self.mask[i],
                                      action_bound=self.action_bound,
                                      gate_bias=self.serving["gate_bias"],
                                      block=REF_BLOCK)
                    for i in self.served}
        finally:
            set_tf32(False)


def _gap(x: Tensor, ref: Tensor) -> float:
    return float((x.float() - ref).abs().max() / ref.abs().max())


def numbers(got: Dict[int, dict], ref: Dict[int, dict]) -> Dict[str, float]:
    """``serve_gap``: the widest gap between an output and the
    reference's, as a share of the reference's largest magnitude in that
    output, over every output of every compared batch; the hybrid output
    counts on the clouds whose gate is not a near tie."""
    gaps = {k: 0.0 for k in OUTPUTS + ("hybrid_output",)}
    ties = 0
    for i, r in ref.items():
        g = got[i]
        for k in OUTPUTS:
            gaps[k] = max(gaps[k], _gap(g[k], r[k]))
        scale = torch.clamp(torch.maximum(r["rl_gan_score"].abs(),
                                          r["ae_score"].abs()), min=1.0)
        margin = (r["rl_gan_score"] - r["ae_score"]).abs()
        clear = (margin > TIE * scale)[:, 0]
        ties += int((~clear).sum())
        if clear.any():
            gaps["hybrid_output"] = max(
                gaps["hybrid_output"],
                _gap(g["hybrid_output"][clear], r["hybrid_output"][clear]))
    clouds = sum(len(r["z_vector"]) for r in ref.values())
    print("serve gaps: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f"; {ties} near-tie gates of {clouds}", file=sys.stderr)
    return {"serve_gap": max(gaps.values())}
