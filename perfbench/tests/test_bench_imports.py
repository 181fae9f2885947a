"""Nothing the benchmark runs loads JAX or the JAX package, judged by
whole top-level module names (the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path
from unittest import mock

from perfbench import harness

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent

RUN = """
import json, sys, time, torch
from perfbench import harness
for w in harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"]:
    cell = harness.Cell(w["name"], 2**31 + 3)
    cell.traffic.update(cell.spec["small"])
    harness.run(cell, 0.05, False, torch.device("cpu"), time.time())
print(json.dumps(harness.forbidden_modules()))
"""

REFERENCE = """
import json, sys
import perfbench.reference.serve, perfbench.reference.train
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=600)
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_nor_the_jax_package():
    assert _python(RUN) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    loaded = set(eval(_python(REFERENCE)))
    assert not loaded & {"gan_rl_3d_tpu_torch", "gan_rl_3d_tpu", "jax",
                         "jaxlib", "flax"}


def test_no_source_imports_jax_or_the_jax_package():
    for path in PERFBENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, path
                if path.parent.name == "reference":
                    assert name.split(".")[0] != "gan_rl_3d_tpu_torch", path


def test_forbidden_names_are_compared_whole():
    before = harness.forbidden_modules()
    with mock.patch.dict(sys.modules, {"gan_rl_3d_tpu_torch_extra": sys,
                                       "jaxtyping": sys}):
        assert harness.forbidden_modules() == before
    with mock.patch.dict(sys.modules, {"gan_rl_3d_tpu.models": sys}):
        assert "gan_rl_3d_tpu" in harness.forbidden_modules()
