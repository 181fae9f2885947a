"""The readings that a cell's correctness limits are set from, on the card
at the cell's own sizes, many seeds in one process:

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault half_batch --fault-seeds 4,5,6] \\
        [--seconds 1]

For each seed the program runs as a benchmark run does (set-up, a short
window, the comparison with the reference) and prints every number of the
comparison. On a control seed it also prints the numbers of the control:
the reference computed with TF32 (the nearest precision below float32
with TF32 off), put in the program's place and compared in the same way.
With ``--fault`` the program runs with that fault planted
(``faults.py``). One JSON line a reading.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from perfbench import faults, harness  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda", 0)
    print(json.dumps({"card": torch.cuda.get_device_name(device)}))
    control = set(_seeds(args.control_seeds))
    jobs = [(s, None) for s in _seeds(args.seeds)]
    jobs += [(s, args.fault) for s in _seeds(args.fault_seeds)]
    for seed, fault in jobs:
        cell = harness.Cell(args.workload, seed)
        mode = cell.mode()
        t0 = time.perf_counter()
        with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
            run = mode.Run(cell, device)
            run.window(args.seconds)
        got = run.answers()
        ref = run.reference(tf32=False)
        line = {"seed": seed, "kind": fault or "program",
                **mode.numbers(got, ref)}
        print(json.dumps(line), flush=True)
        if seed in control and not fault:
            print(json.dumps({"seed": seed, "kind": "control_tf32",
                              **mode.numbers(run.reference(tf32=True),
                                             ref)}), flush=True)
        print(f"seed {seed} took {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        del run, got, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
