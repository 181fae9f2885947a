"""One run of one cell, from the names in BENCHMARK.json to the result line.

The harness finds everything by name: the cell in ``BENCHMARK.json``, its
configuration's file, its traffic file ``traffic/<traffic>.json`` (whose
``mode`` names the driver, ``modes/<mode>.py``), the cell's own file
``workloads/<cell>.json`` (the limits of its correctness check, with the
readings they were set from, the faults it can have and the sizes its CPU
tests run at), and for a traced run each per-layer metric's reader
``metrics/<metric>.py``. A later cell or metric is a set of new
files and entries; no file here needs an edit for it.
"""

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gan_rl_3d_tpu")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux: from
    /proc, to the kernel's clock tick), so that set-up time includes the
    interpreter's own start."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + start


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic,
    limits and the run's seed."""

    def __init__(self, name: str, seed: int):
        bench = read_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(cells)}")
        self.name, self.seed, self.bench = name, seed, bench
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = read_json(ROOT / configs[self.workload["config"]]
                                ["file"])
        self.traffic = read_json(HERE / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.spec = read_json(HERE / "workloads" / f"{name}.json")
        self.limits = self.spec["limits"]
        self.chips = self.workload["chips"]

    def metrics(self, kind: str) -> list:
        """The end-to-end or per-layer metrics this cell reports: those that
        list it, and end-to-end ones that list no cell. Every per-layer
        metric lists its cells."""
        out = []
        for m in self.bench[kind]:
            if kind == "per_layer" and "workloads" not in m:
                raise SystemExit(f"per-layer metric {m['name']!r} lists "
                                 f"no workloads")
            if self.name in m.get("workloads", (self.name,)):
                out.append(m)
        return out

    def mode(self) -> ModuleType:
        return importlib.import_module(
            f"perfbench.modes.{self.traffic['mode']}")

    def seed_for(self, what: str) -> int:
        """A 63-bit seed for one stream of draws (weights, data, draws,
        plan), fixed by the run's seed."""
        import hashlib

        digest = hashlib.sha256(f"{self.seed}:{what}".encode()).digest()
        return int.from_bytes(digest[:8], "little") >> 1


def reader(name: str) -> ModuleType:
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, checks): every number that has a limit at or under it; a
    number that is not finite fails, and so does a limit without its
    number. Numbers without a limit are readings only."""
    checks = {k: {"value": numbers.get(k, math.nan), "limit": lim["limit"]}
              for k, lim in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


def run(cell: Cell, seconds: float, trace: bool, device, t_start: float
        ) -> dict:
    """Set up, measure (or trace), read the peak memory, free the
    program's state, compare with the reference. Returns the result."""
    import torch

    mode = cell.mode()
    t_run = time.time()
    bench = mode.Run(cell, device)
    print(f"setup: {t_run - t_start:.3f} s to the cell's set-up, then "
          f"{bench.phases.text()}", file=sys.stderr)
    if trace:
        measured = bench.trace()
        ctx = dict(measured, cell=cell)
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = bench.window(seconds)
        setup_s = measured["t_first"] - t_start
        values = dict(measured["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    got = bench.answers()
    numbers = mode.numbers(got, bench.reference(tf32=False))
    correct, checks = judge(numbers, cell.limits)
    for k in sorted(set(numbers) - set(checks)):
        print(f"{k} {numbers[k]!r} (a reading, not compared)",
              file=sys.stderr)
    result = {"correct": correct, "attempted": measured["attempted"],
              "failed": measured["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": peak}}
    if trace:
        tr = measured["trace"]
        print(f"trace: busy {tr.busy_s():.6f} s in the profiled pass of "
              f"{tr.traced_s:.6f} s; the same work untraced "
              f"{tr.window_s:.6f} s", file=sys.stderr)
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = process_start()
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, args.seed)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run(cell, args.seconds, bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
