"""The roofline's work: counted by the reference alone, the same whatever
implements a kernel, and consistent with each cell's frozen file."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import roofline, spec
from benchmark.reference import super_film

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]

_COUNT = r"""
import json, sys
sys.path.insert(0, {root!r})
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax",
                "opencl_montecarlo_path_tracing_tpu",
                "opencl_montecarlo_path_tracing_tpu_torch"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import torch
from benchmark.harness import spec
from benchmark.tools.count_work import count
cfg = spec.cell({cell!r}).config
print(json.dumps(count(cfg, 8, 5, torch.device("cpu"))))
"""


@pytest.mark.parametrize("cell", ["super.frames", "trianglegrid.frames"])
def test_count_imports_no_program(cell):
    """The count runs in a process where importing the program or JAX
    fails, and repeats exactly."""
    code = _COUNT.format(root=ROOT, cell=cell)
    outs = [json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=300).stdout.splitlines()[-1]) for _ in range(2)]
    for k in ("primary", "shadow", "frame_traces", "frame_ops"):
        assert outs[0][k] == outs[1][k]
    assert outs[0]["primary"] == 8 * spec.cell(cell).config["spp"]


@pytest.mark.parametrize("cell", CELLS)
def test_frozen_work_is_consistent(cell):
    c = spec.cell(cell)
    w, cfg = c.work, c.config
    assert w["counted_by"].startswith("benchmark/reference/")
    assert w["sample_paths"] == w["sample_pixels"] * cfg["spp"]
    assert w["traces_per_path"] == pytest.approx(
        (w["primary"] + w["shadow"]) / w["sample_paths"])
    assert w["frame_paths"] == cfg["width"] * cfg["height"] * cfg["spp"]
    assert w["frame_traces"] == round(w["traces_per_path"]
                                      * w["frame_paths"])
    assert w["frame_ops"] == w["frame_traces"] * super_film.OPS_PER_TEST
    assert w["frame_bytes"] == w["scene_bytes"] + w["film_bytes"]
    # a camera trace a path, at most one shadow trace a light besides
    nl = len(cfg["scene"]["lights"])
    assert 1.0 <= w["traces_per_path"] <= 1.0 + nl


def test_share_cannot_pass_100():
    """A kernel that took only the least time would read 100%."""
    import types
    c = spec.cell("super.frames")
    peak = {"fp32_flops": 6.7e13, "hbm_bytes_per_s": 3.35e12}
    ops, nbytes = roofline.frame_work(c.work)
    least = roofline.least_seconds(ops, nbytes, peak)

    class S:
        def kernel_time(self, match):
            return least * 10 if match("mega_super_kernel(...)") else 0.0

    ctx = types.SimpleNamespace(summary=S(), peak=peak, work=c.work,
                                frames=10)
    assert roofline.kernel_share(ctx, "mega_super_kernel") == \
        pytest.approx(100.0)
    assert roofline.kernel_share(ctx, "mega_blocked_kernel") is None


def test_trace_reduction():
    """Busy time is the union of device operations inside the window;
    the benchmark's spans mirrored on the device do not count; idle time
    is split over what the host was doing."""
    import types
    from benchmark.harness import trace

    def ev(name, a, b, device=False, annotation=False):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=a, end=b),
            device_type=types.SimpleNamespace(
                name="CUDA" if device else "CPU"),
            is_user_annotation=annotation)

    events = [ev(trace.WINDOW_SPAN, 0, 100), ev(trace.FRAME_SPAN, 10, 50),
              ev("aten::add", 12, 14), ev("kern", 20, 45, True),
              ev("Memcpy DtoH", 40, 48, True), ev(trace.FRAME_SPAN, 55, 95),
              ev(trace.FRAME_SPAN, 55, 95, True, True),
              ev("kern", 60, 90, True), ev("kern", 120, 130, True)]
    s = trace.reduce_events(events, 2)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(58e-6)     # [20, 48] and [60, 90]
    assert s.kernels == 2 and s.kernel_s == {"kern": pytest.approx(55e-6)}
    idle = dict(s.idle_gaps)
    assert sum(idle.values()) == pytest.approx(42e-6)
    assert idle["aten::add"] == pytest.approx(2.5e-6)
