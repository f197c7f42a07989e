"""Per-stage profiling reports in the reference's format.

Port of ``opencl_montecarlo_path_tracing_tpu/utils/profiling.py``.  The
reference enables CL_QUEUE_PROFILING_ENABLE on every queue
(ocl_boiler.h:154-155) and prints per-stage lines like

    rendering : 262144 pixels in 12.3ms: 0.085 GB/s

(CLSuperPathTracer.c:321-325; 7-stage variant
CLSuperMetropolisPathTracer_vlpgrid/...c:673-705).  Here a stage is the
wall clock between a device synchronisation before ``fn()`` and one after
it, the JAX package's ``block_until_ready`` semantics.  CUDA events are
not used: the light passes are bound by host dispatch, and an event-only
time would hide that dispatch from the report.  ``StageTimer`` keeps the
reporting format (ms + derived GB/s = data_size / 1e6 / ms).

Besides, the frame path's spans and the program's counters:

* ``span(name)`` marks a block as a ``torch.profiler`` user annotation
  while a profiler records, and costs one flag check otherwise (no
  environment variable, no argument: a span is on exactly when a profiler
  records).  Its events share the profiler's clock with the device's
  kernels and copies, and its parent is the span that encloses it on the
  host thread.  The spans: ``pt.render`` (``api.render``, the whole call)
  and in it ``pt.route`` (the integrator's film: the variant's model,
  its routing and its launches), ``pt.quantize`` and ``pt.readback`` (the
  RGBA8 reduction and its copy to the host); ``pt.kernel.<route>`` (the
  CUDA path of ``film_super_mega``, from entry to return: ``mega_super``
  for B1, ``mega_blocked`` for B2/B3 and its walk of the exact grid),
  ``pt.pack`` (B1's per-launch scene pack and upload), ``pt.build`` (a
  prepared scene or a derived table built on a cache miss: a fresh
  large-mesh scene's first B2/B3 frame builds ``prep_scene``, the
  triangle-free ``mega_super.scene_buffer/bare`` and
  ``exact_grid.exact_grid``).
* ``COUNTS`` holds integer tallies by name, always on, read by snapshot
  (``dict(COUNTS)``); ``count(name, n)`` adds to one.  Each build adds 1
  to ``build.<name>`` and its own nanoseconds, less those of the builds
  nested in it, to ``build_ns.<name>`` (``ops/intersect.py::_memo``;
  ``<name>`` is ``prep_scene`` or the derived table's name), so the
  ``build_ns`` counters add up to the builds' time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

_OFF = contextlib.nullcontext()

#: Integer tallies by name since the process started (see the module's
#: docstring); never reset by the program.
COUNTS: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[name]``."""
    COUNTS[name] = COUNTS.get(name, 0) + n


def span(name: str):
    """A context manager that records the block as the user annotation
    ``name`` while a ``torch.profiler`` records, and does nothing
    otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _OFF


@dataclasses.dataclass
class Stage:
    name: str
    items: int
    item_label: str
    data_size: int  # bytes moved, for the GB/s figure
    ms: float

    @property
    def gbs(self) -> float:
        return self.data_size / 1.0e6 / self.ms if self.ms > 0 else float("inf")


class StageTimer:
    """Stages timed on ``device`` (a CUDA device is synchronised around
    each stage; a CPU stage is complete when ``fn`` returns)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.stages: list[Stage] = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, name: str, fn, *, items: int, item_label: str,
            data_size: int):
        """Execute ``fn()``, wait for the device to finish it, and record
        the stage; returns what ``fn`` returned."""
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        self.stages.append(Stage(name, items, item_label, data_size, ms))
        return out

    def record(self, name: str, ms: float, *, items: int, item_label: str,
               data_size: int):
        self.stages.append(Stage(name, items, item_label, data_size, ms))

    def report(self) -> str:
        lines = []
        total = 0.0
        for s in self.stages:
            lines.append(f"{s.name} : {s.items} {s.item_label} in {s.ms:g}ms: "
                         f"{s.gbs:g} GB/s")
            total += s.ms
        lines.append("")
        lines.append(f"Total time: {total:g} ms.")
        return "\n".join(lines)

    def print_report(self):
        print(self.report())
