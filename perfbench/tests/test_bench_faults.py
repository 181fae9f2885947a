"""The correctness check against faults planted under the timed path.

Every cell of BENCHMARK.json is covered, with the faults and the CPU sizes
that its own file ``workloads/<cell>.json`` names. On the CPU at those
sizes, past the harness's look for a card: each fault makes the run's
``correct`` false, by a number that the same run without the fault reads
at least ten times lower. On the card (the ``card`` marker) at the cells'
own sizes: the control, the reference computed with TF32 put in the
program's place, fails the cell's limits on three seeds, and the program
passes them.
"""

import contextlib
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import faults, harness

BENCH = json.loads((Path(harness.ROOT) / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CASES = [(cell, fault) for cell in CELLS
         for fault in harness.Cell(cell, 1).spec["faults"]]


def _small(name, seed):
    cell = harness.Cell(name, seed)
    cell.traffic.update(cell.spec["small"])
    return cell


def _readings(cell, device, fault=None, control=False):
    """The program's numbers (with ``fault`` planted), and with
    ``control`` also the control's on the same inputs."""
    mode = cell.mode()
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        run = mode.Run(cell, device)
        run.window(0.05)
    got = run.answers()
    ref = run.reference(tf32=False)
    numbers = mode.numbers(got, ref)
    if control:
        return numbers, mode.numbers(run.reference(tf32=True), ref)
    return numbers


def test_every_named_fault_exists():
    assert all(fault in faults.FAULTS for _, fault in CASES)


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_fails_the_check(name, fault):
    cpu = torch.device("cpu")
    seed = 2**31 + 21
    sound = _readings(_small(name, seed), cpu)
    broken = _readings(_small(name, seed), cpu, fault)
    cell = _small(name, seed)
    assert harness.judge(sound, cell.limits)[0], sound
    assert not harness.judge(broken, cell.limits)[0]
    assert any(broken[k] >= 10 * max(sound[k], 1e-12) and
               broken[k] > cell.limits[k]["limit"] for k in cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_a_whole_run_with_a_fault_reads_incorrect(name):
    cell = _small(name, 2**31 + 22)
    with faults.FAULTS[cell.spec["faults"][0]]():
        result = harness.run(cell, 0.05, False, torch.device("cpu"),
                             time.time())
    assert result["correct"] is False
    assert list(result)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(card, name):
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        cell = harness.Cell(name, seed)
        program, control = _readings(cell, card, control=True)
        assert harness.judge(program, cell.limits)[0], (seed, program)
        assert not harness.judge(control, cell.limits)[0], (seed, control)
