"""The program's spans in a ``torch.profiler`` trace of the window.

The program marks its frame path with user annotations (``pt.render``,
``pt.kernel.<route>``, ``pt.quantize``, ``pt.readback``, ``pt.pack``,
``pt.build``: ``utils/profiling.py``), the loop its frames
(``bench.frame``).  For each such host span, inside the window span
``bench.window``: its instances, their host seconds, and the device-idle
seconds that fall inside any instance, the time of the spans nested in it
included.  Device idle is the window less the union of the device's
operations, as in ``trace.reduce_events`` (whose busy time leaves out the
spans' own mirrors on the device, which are user annotations too); so a
span's idle seconds are the idle time that the host spent in it.
"""

from __future__ import annotations

import collections
import dataclasses

from benchmark.harness import trace


@dataclasses.dataclass
class Span:
    count: int        # instances that overlap the window
    host_s: float     # seconds covered by the instances (their union)
    idle_s: float     # device-idle seconds inside the instances


@dataclasses.dataclass
class Spans:
    window_s: float
    idle_s: float     # the window's device-idle seconds
    by_name: dict     # span name -> Span

    def idle(self, match) -> float:
        """Device-idle seconds inside the spans whose name ``match(name)``
        is true, summed over the names."""
        return sum(s.idle_s for n, s in self.by_name.items() if match(n))


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    out = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            out += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def span_times(events) -> Spans | None:
    """The window's host spans from a profiler's ``events()``; None when
    the trace has no window span."""
    events = list(events)
    win = [e for e in events
           if e.name == trace.WINDOW_SPAN and not trace._is_device(e)]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    busy, spans = [], collections.defaultdict(list)
    for e in events:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        if trace._is_device(e):
            if not (e.is_user_annotation
                    or e.name in (trace.WINDOW_SPAN, trace.FRAME_SPAN)):
                busy.append((a, b))
        elif e.is_user_annotation and e.name != trace.WINDOW_SPAN:
            spans[e.name].append((a, b))
    gaps, edge = [], w0
    for a, b in trace._union(busy):
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    by_name = {}
    for name, iv in spans.items():
        cover = trace._union(iv)
        by_name[name] = Span(len(iv),
                             sum(b - a for a, b in cover) * 1e-6,
                             _overlap(cover, gaps) * 1e-6)
    return Spans((w1 - w0) * 1e-6, sum(b - a for a, b in gaps) * 1e-6,
                 by_name)


def growth(before: dict, after: dict, prefix: str) -> dict:
    """The growth of each of the program's counters named ``prefix<name>``
    from ``before`` to ``after``, by ``<name>``, where it grew."""
    return {k[len(prefix):]: after[k] - before.get(k, 0) for k in after
            if k.startswith(prefix) and after[k] != before.get(k, 0)}


def build_ms(before: dict, after: dict, pairs: int) -> float | None:
    """Milliseconds a pair spent in the program's builds: the growth of
    its ``build_ns.*`` counters from ``before`` to ``after`` over
    ``pairs``; None where the program keeps no such counter.  A build
    counts its time less that of the builds nested in it, so the sum
    counts no time twice."""
    keys = [k for k in after if k.startswith("build_ns.")]
    if not keys:
        return None
    return sum(after[k] - before.get(k, 0) for k in keys) / pairs / 1e6
