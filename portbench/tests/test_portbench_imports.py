"""What the benchmark loads: no JAX and no JAX package in a cell's run,
and nothing of the program in the plain references."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT, TINY

CELL_RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_spec
from portbench import core, run
line, _ = run.run_cell(tiny_spec({cell!r}), 7, 0.2, False, "cpu")
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": json.loads(line)["correct"], "tops": tops}}))
"""

REFERENCES = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.taxi, portbench.reference.ppo, portbench.reference.ant_tag
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_cell_run_loads_no_jax(cell):
    got = _tops(CELL_RUN.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"),
                                cell=cell))
    assert got["correct"]
    assert "gym_po_tpu_torch" in got["tops"]
    for name in ("jax", "jaxlib", "flax", "gym_po_tpu"):
        assert name not in got["tops"]


def test_references_load_nothing_of_the_program():
    tops = _tops(REFERENCES.format(root=str(ROOT)))
    for name in ("gym_po_tpu_torch", "gym_po_tpu", "jax"):
        assert name not in tops
