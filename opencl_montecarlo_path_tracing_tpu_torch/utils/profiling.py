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
"""

from __future__ import annotations

import dataclasses
import time

import torch


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

    def trace(self, log_dir: str):
        """A ``torch.profiler`` profile (host, and the device's kernels on
        CUDA) around a block, written under ``log_dir`` as a Chrome /
        TensorBoard trace - the deep-profiling analog of the reference's
        CL_QUEUE_PROFILING_ENABLE event timing.  Usage:

            with timer.trace("traces"):
                film = render(...); torch.cuda.synchronize()
        """
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(log_dir))

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
