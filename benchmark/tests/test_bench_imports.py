"""The import guard: nothing that the benchmark loads for a cell may be
JAX or the JAX package, compared by whole top-level names."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import guard, spec

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]

_WALK = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from benchmark.harness import guard, loop, spec
from benchmark.tools import readings, count_work
cell = spec.cell({cell!r})
for m in cell.end_to_end + cell.per_layer:
    spec.reader(m["name"])
out = loop.run_cell({cell!r}, 7, frames=2, device_type="cpu",
                    overrides={overrides!r})
print(json.dumps({{"loaded": sorted({{n.split(".")[0]
                                     for n in sys.modules}}),
                  "forbidden": out["forbidden"]}}))
"""

SMALL_SHEET = {"kind": "ripple_sheet", "n_major": 16, "n_minor": 8,
               "min_det": 0.02, "depth": 20.0, "amp_frac": 0.075,
               "periods": 6.0}


@pytest.mark.parametrize("name,forbidden", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("opencl_montecarlo_path_tracing_tpu", True),
    ("opencl_montecarlo_path_tracing_tpu.ops.pallas_super", True),
    ("opencl_montecarlo_path_tracing_tpu_torch", False),
    ("opencl_montecarlo_path_tracing_tpu_torch.api", False),
    ("jaxtyping", False), ("numpy", False),
])
def test_guard_compares_whole_names(name, forbidden):
    assert bool(guard.forbidden_modules([name])) == forbidden


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_loads_no_jax(cell):
    """A whole run of the cell, shrunk to run on the CPU, in a fresh
    process: every module it loaded is walked by top-level name."""
    cfg = spec.cell(cell).config
    scene = dict(cfg["scene"])
    if scene["mesh"]["kind"] == "ripple_sheet":
        scene["mesh"] = SMALL_SHEET
    ov = {"width": 2, "height": 64, "spp": 2, "scene": scene}
    code = _WALK.format(root=ROOT, cell=cell, overrides=ov)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert "opencl_montecarlo_path_tracing_tpu_torch" in out["loaded"]
    assert guard.forbidden_modules(out["loaded"]) == []
    assert out["forbidden"] == []
