"""One run of a cell: set-up, warm-up, the measured window, the check.

The window is a closed loop of frames: the next frame is asked for when
the last frame's RGBA8 image is on the host, for ``seconds`` (or, in the
tools, for a number of frames).  Every frame in the window counts, and
the window ends with the last frame's image.  ``setup_s`` runs from the
process's start (the kernel's record of it) to the window's start: the
imports, the CUDA context, the kernels' library (built on a checkout's
first run), the scene and every table the program derives from it, and
the warm-up frames of the cell's own shape.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import time
import types

import torch

from benchmark.harness import (check, faults as faultmod, guard, roofline,
                               scenes, spec, trace, traffic)


def boottime() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _process_start() -> float | None:
    """This process's start on the CLOCK_BOOTTIME scale (seconds), from
    /proc/self/stat; None where that cannot be read."""
    try:
        with open("/proc/self/stat") as fp:
            fields = fp.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_STARTED = _process_start()
_IMPORTED = boottime()


def process_start() -> float:
    return _STARTED if _STARTED is not None else _IMPORTED


def sync(device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device_type: str) -> int:
    if device_type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


class Tracer:
    """A ``torch.profiler`` trace around the window, which it marks with
    the span ``trace.WINDOW_SPAN``."""

    def __init__(self, device_type: str):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device_type = device_type
        self.prof = profile(activities=acts)
        self.span = torch.autograd.profiler.record_function(trace.WINDOW_SPAN)

    def start(self) -> None:
        sync(self.device_type)
        self.prof.__enter__()
        self.span.__enter__()

    def stop(self) -> None:
        sync(self.device_type)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self, frames: int):
        return trace.reduce_events(self.prof.events(), frames)

    def busy_s(self) -> float | None:
        s = self.summary(0)
        return None if s is None else s.busy_s


@contextlib.contextmanager
def _frame_span(traced: bool):
    if traced:
        with torch.autograd.profiler.record_function(trace.FRAME_SPAN):
            yield
    else:
        yield


def window(entry, stream, seconds=None, frames=None, keep=None,
           traced=False):
    """The loop: frame k is asked for when frame k - 1's image is on the
    host.  Returns (frame times in ms, window seconds); ``keep`` (a
    ``check.Reservoir``) is offered every frame."""
    times = []
    k = 0
    t0 = time.perf_counter()
    while True:
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
        if frames is not None and k >= frames:
            break
        s, fresh = stream.request(k)
        a = time.perf_counter()
        with _frame_span(traced):
            img = entry.frame(s, fresh=fresh)
        times.append((time.perf_counter() - a) * 1e3)
        if keep is not None:
            keep.offer(check.Kept(k, s, img))
        k += 1
    return times, time.perf_counter() - t0


def scene_prep_ms(entry, stream, pairs: int = 5) -> float:
    """The median over ``pairs`` of (a frame from a fresh ``Scene``, which
    the program prepares anew) less (a frame of the prepared scene)."""
    out = []
    for i in range(pairs):
        s = stream.warmup_seed(100 + i)
        a = time.perf_counter()
        entry.frame(s, fresh=True)
        b = time.perf_counter()
        entry.frame(s)
        c = time.perf_counter()
        out.append(((b - a) - (c - b)) * 1e3)
    return statistics.median(out)


def _power_limit() -> float | None:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Session(types.SimpleNamespace):
    """A cell's program, set up: ``cell``, ``cfg``, ``raw`` (the scene),
    ``device``, ``entry``."""


@contextlib.contextmanager
def session(name: str, device_type: str = "cuda", faults=(),
            overrides: dict | None = None, marks: dict | None = None):
    """Set up a cell's program, and take it down again: the program's
    state is freed.  Its stages are marked in ``marks`` (boot-clock
    seconds by name)."""
    marks = {} if marks is None else marks
    cell = spec.cell(name)
    cfg = dict(cell.config, **(overrides or {}))
    s = Session(cell=cell, cfg=cfg, raw=scenes.make_scene(cfg["scene"]),
                entry=None)
    marks["scene"] = boottime()
    s.device = (torch.device(device_type, 0) if device_type == "cuda"
                else torch.device("cpu"))
    undo = faultmod.install(faults)
    try:
        if device_type == "cuda":
            torch.cuda.set_device(s.device)
            torch.cuda.init()
            torch.zeros(1, device=s.device)
            sync(device_type)
        marks["cuda_context"] = boottime()
        s.entry = spec.plugin("entries", cfg["entry"]).Entry(cfg, s.raw,
                                                             s.device)
        marks["entry"] = boottime()
        yield s
    finally:
        undo()
        s.entry = None
        gc.collect()
        if device_type == "cuda":
            torch.cuda.empty_cache()


def setup_split(marks: dict) -> dict:
    """Seconds of each set-up stage, in the order marked, from the
    process's start."""
    out = {}
    last = process_start()
    for name, t in sorted(marks.items(), key=lambda kv: kv[1]):
        out[name] = t - last
        last = t
    return out


def run_cell(name: str, seed: int, seconds=None, frames=None,
             trace_on: bool = False, device_type: str = "cuda",
             faults=(), overrides: dict | None = None,
             marks: dict | None = None) -> dict:
    """One run; returns {"result": the result line's object, "shown":
    the compared numbers and limits, "values": every number of the
    check, "setup_split": seconds of each set-up stage, "forbidden": JAX
    modules that the process loaded}.  ``marks`` holds the stages the
    caller marked before (boot-clock seconds by name)."""
    summary = prep = None
    marks = dict(marks or {})
    with session(name, device_type, faults, overrides, marks) as s:
        chk = s.cell.workload["check"]
        stream = traffic.stream(s.cell.traffic, seed)
        for i in range(stream.warmup_frames):
            s.entry.frame(stream.warmup_seed(i))
            sync(device_type)
            marks.setdefault("first_warmup_frame", boottime())
        marks["warmup_frames"] = boottime()
        tracer = None
        if trace_on:
            tracer = Tracer(device_type)
            tracer.start()
        setup_s = boottime() - process_start()
        keep = check.Reservoir(int(chk["frames"]) - 1, seed)
        times, window_s = window(s.entry, stream, seconds, frames, keep,
                                 traced=trace_on)
        if tracer is not None:
            tracer.stop()
        peak_bytes = memory_peak(device_type)
        if tracer is not None:
            summary = tracer.summary(len(times))
            prep = scene_prep_ms(s.entry, stream)
    cfg, device = s.cfg, s.device
    kept = keep.kept()
    values = check.numbers(cfg, s.raw, seed, kept, int(chk["pixels"]),
                           device)
    ok, shown = check.verdict(values, chk["limits"], len(times))
    kind = (torch.cuda.get_device_name(device) if device_type == "cuda"
            else "cpu")
    ctx = types.SimpleNamespace(
        cell=s.cell, cfg=cfg, work=s.cell.work, summary=summary,
        frames=len(times), times_ms=times, window_s=window_s,
        setup_s=setup_s, scene_prep_ms=prep, peak=roofline.peaks(kind))
    metrics = {}
    for m in (s.cell.per_layer if trace_on else s.cell.end_to_end):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device_type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": peak_bytes}
    result = {"correct": bool(ok), "attempted": len(times), "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    if device_type == "cuda":
        dev["power_limit_w"] = _power_limit()
    return {"result": result, "shown": shown, "values": values,
            "setup_split": setup_split(marks),
            "forbidden": guard.forbidden_modules()}
