"""The device's idle time a frame, split by the program's spans, and what
tracing costs.

    python3 benchmark/tools/span_split.py --workload super.frames \\
        --seeds 7 8 9 --seconds 20 --out spans.json

In one process, the cell's program set up once and warmed up; for each
seed a window of ``--seconds`` without the profiler and one traced as a
``--trace 1`` run traces its window (``loop.Tracer``), in turns (the
traced window first on every other seed), then the five pairs of
``scene_prep_ms`` with the program's counters read around them.  For
each seed: both windows' ``paths_per_s`` and ``frame_ms_p95``; from the
traced one the device's idle time a frame inside each span
(``harness/spans.py``), under the names of the readings it stands for:
``render_idle_ms`` (``pt.render``), ``route_idle_ms`` (``pt.route``),
``launch_idle_ms`` (the ``pt.kernel.*`` spans), ``film_idle_ms``
(``pt.quantize`` and ``pt.readback``), ``between_idle_ms`` (outside
``bench.frame``: the loop's own time), and ``prep_build_ms`` (the growth
of the counters ``build_ns.*`` over a pair); the shares of
``render_idle_ms`` that ``pt.render``'s children cover; and
``launch_lag_us``, a check of the trace's clocks (see the function).
Last, one traced frame from a fresh ``Scene`` (``fresh``): the host ms
of ``pt.render`` and of the ``pt.build`` spans in it, what the frame
spends outside them, and the builds it made by name with their ms (the
counters ``build.<name>``, ``build_ns.<name>``).  On a program without
spans or counters those readings are left out.  Prints one JSON object a
seed and writes all of them to ``--out``.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import loop, spans, trace, traffic  # noqa: E402

PREP_PAIRS = 5


def program_counts() -> dict:
    """A snapshot of the program's counters; empty where it has none."""
    try:
        prof = importlib.import_module(
            "opencl_montecarlo_path_tracing_tpu_torch.utils.profiling")
    except ImportError:
        return {}
    return dict(getattr(prof, "COUNTS", {}))


def _per_frame_ms(seconds: float, frames: int) -> float:
    return seconds / frames * 1e3


def split(summary, sp, frames: int) -> dict:
    """The readings of a traced window: idle ms a frame by span, host ms
    a frame by span, and the device's share of the window."""
    out = {"frames": frames}
    if summary is not None:
        out["device_idle_pct"] = 100.0 * (1.0 - summary.busy_s
                                          / summary.window_s)
        out["idle_gaps"] = summary.idle_gaps
    if sp is None or not frames:
        return out
    names = sp.by_name

    def idle(match):
        return _per_frame_ms(sp.idle(match), frames)

    out["idle_ms"] = _per_frame_ms(sp.idle_s, frames)
    out["span_idle_ms"] = {n: _per_frame_ms(s.idle_s, frames)
                           for n, s in sorted(names.items())}
    out["span_host_ms"] = {n: _per_frame_ms(s.host_s, frames)
                           for n, s in sorted(names.items())}
    out["span_count"] = {n: s.count for n, s in sorted(names.items())}
    frame = names.get(trace.FRAME_SPAN)
    if frame is not None:
        out["between_idle_ms"] = _per_frame_ms(sp.idle_s - frame.idle_s,
                                               frames)
    if "pt.render" in names:
        render = idle(lambda n: n == "pt.render")
        route = idle(lambda n: n == "pt.route")
        launch = idle(lambda n: n.startswith("pt.kernel."))
        film = idle(lambda n: n in ("pt.quantize", "pt.readback"))
        out.update(render_idle_ms=render, route_idle_ms=route,
                   launch_idle_ms=launch, film_idle_ms=film)
        if render:
            out["kernel_film_share"] = (launch + film) / render
            out["children_share"] = (route + film) / render
        if out["idle_ms"]:
            out["closure"] = ((render + out.get("between_idle_ms", 0.0))
                              / out["idle_ms"])
    return out


_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx")


def launch_lag_us(events, kernel="mega_"):
    """The median of (a ``kernel`` launch's start on the device less the
    start of the host's launch call nearest to it), in us: a few us when
    the trace's host and device clocks agree; a negative lag is an offset
    between them, which moves idle time from the spans before a launch to
    those after it."""
    calls = sorted(e.time_range.start for e in events
                   if not trace._is_device(e) and e.name in _LAUNCH_CALLS)
    lags = []
    for e in events:
        if (trace._is_device(e) and kernel in e.name
                and not e.is_user_annotation and calls):
            t = e.time_range.start
            i = bisect.bisect_left(calls, t)
            near = min(calls[max(0, i - 1):i + 1], key=lambda c: abs(c - t))
            lags.append(t - near)
    return statistics.median(lags) if lags else None


def _window(s, seed, seconds, device_type, traced):
    stream = traffic.stream(s.cell.traffic, seed)
    tracer = loop.Tracer(device_type) if traced else None
    if tracer is not None:
        tracer.start()
    times, window_s = loop.window(s.entry, stream, seconds=seconds,
                                  traced=traced)
    if tracer is not None:
        tracer.stop()
    c = s.cfg
    out = {"paths_per_s": c["width"] * c["height"] * c["spp"] * len(times)
           / window_s / 1e6,
           "frame_ms_p95": float(np.percentile(times, 95)),
           "frames": len(times), "window_s": window_s}
    if tracer is not None:
        events = list(tracer.prof.events())
        mirrors = [e for e in events if e.name.startswith("pt.")
                   and trace._is_device(e)]
        out["split"] = split(trace.reduce_events(events, len(times)),
                             spans.span_times(events), len(times))
        out["split"]["launch_lag_us"] = launch_lag_us(events)
        out["split"]["device_mirrors"] = len(mirrors)
        out["split"]["mirrors_not_annotations"] = sum(
            not e.is_user_annotation for e in mirrors)
    return out


def fresh_reading(events, before: dict, after: dict) -> dict:
    """A traced frame from a fresh ``Scene``: ``builds`` and ``build_ms``
    by name from the counters' growth from ``before`` to ``after``; from
    the trace, each span's host ms and instances (the profiler's event
    list drops a span that is the only child of a span of its name, so
    the builds are counted by the counters) and ``outside_build_ms``,
    ``pt.render``'s host ms less its ``pt.build`` spans'."""
    out = {"builds": spans.growth(before, after, "build."),
           "build_ms": {n: v / 1e6 for n, v in
                        spans.growth(before, after, "build_ns.").items()}}
    sp = spans.span_times(events)
    if sp is None:
        return out
    host = {n: x.host_s * 1e3 for n, x in sorted(sp.by_name.items())}
    out["span_host_ms"] = host
    out["span_count"] = {n: x.count for n, x in sorted(sp.by_name.items())}
    if "pt.render" in host:
        out["outside_build_ms"] = host["pt.render"] - host.get("pt.build",
                                                               0.0)
    return out


def fresh_frame(s, seed, device_type="cuda") -> dict:
    """:func:`fresh_reading` of one frame from a fresh ``Scene``, with its
    time on the host clock (``frame_ms``, the profiler on)."""
    before = program_counts()
    tracer = loop.Tracer(device_type)
    tracer.start()
    a = time.perf_counter()
    s.entry.frame(seed, fresh=True)
    ms = (time.perf_counter() - a) * 1e3
    tracer.stop()
    out = fresh_reading(list(tracer.prof.events()), before,
                        program_counts())
    out["frame_ms"] = ms
    return out


def run(name, seeds, seconds, device_type="cuda", overrides=None):
    rows = []
    with loop.session(name, device_type, overrides=overrides) as s:
        stream = traffic.stream(s.cell.traffic, seeds[0])
        for i in range(stream.warmup_frames):
            s.entry.frame(stream.warmup_seed(i))
        loop.sync(device_type)
        for i, seed in enumerate(seeds):
            row = {"workload": name, "seed": seed}
            for traced in ((True, False) if i % 2 else (False, True)):
                row["traced" if traced else "untraced"] = _window(
                    s, seed, seconds, device_type, traced)
            before = program_counts()
            row["scene_prep_ms"] = loop.scene_prep_ms(s.entry, stream,
                                                      PREP_PAIRS)
            build = spans.build_ms(before, program_counts(), PREP_PAIRS)
            if build is not None:
                row["prep_build_ms"] = build
            row["fresh"] = fresh_frame(s, stream.warmup_seed(200 + i),
                                       device_type)
            row["cost_pct"] = 100.0 * (1.0 - row["traced"]["paths_per_s"]
                                       / row["untraced"]["paths_per_s"])
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    ns = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    rows = run(ns.workload, ns.seeds, ns.seconds)
    res = {"workload": ns.workload,
           "device": torch.cuda.get_device_name(0),
           "cost_pct_median": statistics.median(r["cost_pct"] for r in rows),
           "rows": rows}
    if ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
        with open(ns.out, "w") as fp:
            fp.write(json.dumps(res) + "\n")
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
