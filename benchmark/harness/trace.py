"""Reduction of a ``torch.profiler`` trace of the measured window.

The window is the span ``bench.window`` that the loop records around its
frames; every device operation (kernel, copy, set) inside it counts.
From the trace: the device's busy seconds (the union of its operations'
intervals), the device time of each kernel by name, the kernels launched,
the operations that took most time, and the idle gaps, each named by what
the host was doing in it (the innermost host event at 8 points of the
gap, under the benchmark's own span).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW_SPAN = "bench.window"
FRAME_SPAN = "bench.frame"
_COPIES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    frames: int
    kernel_s: dict          # kernel name -> device seconds in the window
    kernels: int            # kernel launches in the window
    device_ops: list        # [[name, seconds], ...] most time first
    idle_gaps: list         # [[host activity, seconds], ...] longest first

    def kernel_time(self, match) -> float:
        """Device seconds of the kernels whose name ``match(name)`` is
        true."""
        return sum(s for n, s in self.kernel_s.items() if match(n))


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CUDA"


def reduce_events(events, frames: int, top: int = 10) -> Summary | None:
    """The window's summary from a profiler's ``events()``; None when the
    trace has no window span or no device operation in it."""
    events = list(events)
    win = [e for e in events if e.name == WINDOW_SPAN and not _is_device(e)]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if b <= w0 or a >= w1:
            continue
        if _is_device(e) and (e.is_user_annotation
                              or e.name in (WINDOW_SPAN, FRAME_SPAN)):
            continue     # the benchmark's spans, mirrored on the device
        (dev if _is_device(e) else host).append(
            (max(a, w0), min(b, w1), e.name))
    if not dev:
        return None
    busy = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    per_op = collections.Counter()
    kernel_s = collections.Counter()
    kernels = 0
    for a, b, n in dev:
        per_op[n] += (b - a) * 1e-6
        if not n.startswith(_COPIES):
            kernel_s[n] += (b - a) * 1e-6
            kernels += 1
    # idle gaps inside the window, named by the host's innermost event
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    host = [h for h in host if h[2] != WINDOW_SPAN]
    host.sort()
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for a, b in gaps:
        # the gap's time, split over what the host did at 8 points in it
        for j in range(8):
            at = a + (j + 0.5) * (b - a) / 8
            i = bisect.bisect_right(starts, at)
            # nested events: the covering one that started last is innermost
            inner = next((h for h in reversed(host[max(0, i - 4096):i])
                          if h[1] >= at), None)
            if inner is None:
                label = "host between frames (the harness's loop)"
            elif inner[2] == FRAME_SPAN:
                label = ("host in the frame, in no torch op (Python, numpy, "
                         "launch)")
            else:
                label = inner[2]
            idle[label] += (b - a) * 1e-6 / 8
    return Summary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, frames=frames,
        kernel_s=dict(kernel_s), kernels=kernels,
        device_ops=[[n, s] for n, s in per_op.most_common(top)],
        idle_gaps=[[n, s] for n, s in idle.most_common(top)])
