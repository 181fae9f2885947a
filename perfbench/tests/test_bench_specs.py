"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name: configurations, traffic mixes, cells' limits,
per-layer metric readers, traffic modes."""

import json
import re
from pathlib import Path

import pytest

from perfbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.startswith("/") \
            and ".." not in p.split("/")
    cmd = BENCH["command"]
    assert len(cmd) <= 32
    named = [w for w in cmd if (ROOT / w).exists() and "/" in w]
    assert all(any(w.startswith(p + "/") for p in BENCH["paths"])
               for w in named)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                            "higher")
        for cell in e.get("workloads", []) if section != "workloads" else []:
            assert cell in CELLS


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = harness.Cell(cell, 1)
    e2e = [m["name"] for m in c.metrics("end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.metrics("per_layer")


def test_cells_and_configurations():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] \
            == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    c = harness.Cell(cell, 2**31 + 7)
    assert c.mode().Run and c.mode().numbers
    assert c.limits and all("limit" in v for v in c.limits.values())
    for m in c.metrics("per_layer"):
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_names_its_faults_and_cpu_sizes(cell):
    spec = harness.Cell(cell, 1).spec
    assert spec["faults"] and all(f in faults.FAULTS for f in spec["faults"])
    c = harness.Cell(cell, 1)
    assert set(spec["small"]) <= set(c.traffic)


def test_a_per_layer_metric_without_workloads_is_refused():
    c = harness.Cell(CELLS[0], 1)
    c.bench = dict(c.bench, per_layer=[{"name": "x", "moves": "setup_s"}])
    with pytest.raises(SystemExit):
        c.metrics("per_layer")


def test_every_limit_lies_between_its_readings():
    for cell in CELLS:
        for name, lim in harness.Cell(cell, 1).limits.items():
            if lim.get("lower") is not None:
                assert lim["lower"] < lim["limit"], (cell, name)
            if lim.get("upper") is not None:
                assert lim["limit"] < lim["upper"], (cell, name)


def test_seeds_split_into_fixed_streams():
    a, b = harness.Cell(CELLS[0], 2**31 + 5), harness.Cell(CELLS[0], 2**31 + 5)
    assert a.seed_for("weights") == b.seed_for("weights")
    assert a.seed_for("weights") != a.seed_for("data")
    assert 0 <= a.seed_for("draws") < 2**63


def test_judge_fails_a_number_over_its_limit_or_missing():
    limits = {"x": {"limit": 1.0}, "y": {"limit": 2.0}}
    assert harness.judge({"x": 0.5, "y": 2.0}, limits)[0]
    assert not harness.judge({"x": 1.5, "y": 0.0}, limits)[0]
    assert not harness.judge({"x": float("nan"), "y": 0.0}, limits)[0]
    assert not harness.judge({"x": 0.5}, limits)[0]
    _, checks = harness.judge({"x": 0.5, "y": 1.0, "z": 9.0}, limits)
    assert list(checks) == ["x", "y"]

