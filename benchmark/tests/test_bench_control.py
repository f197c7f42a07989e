"""The check fails what it must: the control (the reference in bfloat16
in the program's place) and each fault a cell can have, planted under
the timed path of a whole run.  Runs skip the look for a chip and render
on the CPU, at a size a test run holds: 2 x 256 pixels at 8 samples, the
sheet cut to 256 triangles; the limits are the cells' own.

On the CPU the trianglegrid variant renders its DDA wavefront, whose
break rule makes its film differ from the closest hit's; the card's
``accel="auto"`` route is B2/B3, held to the closest hit.  So the runs of
that cell take the super route here (the brute-force plain version that
B2/B3 is held to)."""

import pytest

from benchmark.harness import check, loop, spec
from benchmark.tools import readings

SEED = 3_000_000_019
SMALL_SHEET = {"kind": "ripple_sheet", "n_major": 16, "n_minor": 8,
               "min_det": 0.02, "depth": 20.0, "amp_frac": 0.075,
               "periods": 6.0}
FAULTS = {"super.frames": ("stale", "half", "altered"),
          "trianglegrid.frames": ("stale", "half", "altered")}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _overrides(cell):
    cfg = spec.cell(cell).config
    ov = {"width": 2, "height": 256, "spp": 8}
    if cfg["scene"]["mesh"]["kind"] == "ripple_sheet":
        ov["scene"] = dict(cfg["scene"], mesh=SMALL_SHEET)
    return ov


@pytest.fixture
def closest_hit_route(monkeypatch):
    from opencl_montecarlo_path_tracing_tpu_torch.models import trianglegrid
    monkeypatch.setattr(trianglegrid, "route",
                        lambda *a, **k: "mega_blocked")


def _run(cell, faults=()):
    return loop.run_cell(cell, SEED, frames=4, device_type="cpu",
                         faults=faults, overrides=_overrides(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, closest_hit_route):
    out = _run(cell)
    assert out["result"]["correct"], out["shown"]
    assert out["values"]["px_differ_share"] == 0.0
    assert out["result"]["attempted"] == 4


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_fault_is_not_correct(cell, fault, closest_hit_route):
    out = _run(cell, (fault,))
    assert not out["result"]["correct"], out["shown"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference computed in bfloat16, in the program's place."""
    ov = _overrides(cell)
    rows = readings.control_readings(cell, [SEED + 1], 4, "cpu", ov)
    limits = spec.cell(cell).workload["check"]["limits"]
    ok, shown = check.verdict(rows[0]["values"], limits, 4)
    assert not ok, shown
