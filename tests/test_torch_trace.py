"""The frame path's spans and the program's counters
(``utils/profiling.py``) on the CPU.

* under ``torch.profiler``, ``api.render(..., as_rgba8=True)`` records
  ``pt.render`` around ``pt.route``, ``pt.quantize`` and ``pt.readback``,
  and a fresh ``Scene`` one ``pt.build`` in ``pt.route`` (the same
  ``Scene`` again none);
* with no profiler recording, a span never enters ``record_function``;
* ``COUNTS`` adds up counts and a build's nanoseconds exactly; a build
  nested in another (a derived table whose build derives another) counts
  its own time, and the outer one its time less the nested one's.

The card's spans (``pt.kernel.<route>``, ``pt.pack``) are held in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opencl_montecarlo_path_tracing_tpu_torch import api
from opencl_montecarlo_path_tracing_tpu_torch.ops import intersect
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils import profiling as P


def small_scene() -> Scene:
    return Scene(
        sphere_centers=np.array([[10, 0, 4], [11, 0, 11]], np.float32),
        square_kj=np.array([[12, 0], [7, 6]], np.float32),
        triangles=np.array([[[8, 5, 10], [7.5, 5.3, 10.6],
                             [7.6, 5.1, 10.7]]], np.float32),
        lights=np.array([[10, 4, 10, 200]], np.float32))


def _frame(scene):
    return api.render("super", scene, 16, 16, spp=1, as_rgba8=True,
                      device="cpu")


def _traced_frame(scene):
    """The program's spans of one frame, and the counters it added."""
    before = dict(P.COUNTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = _frame(scene)
    assert img.shape == (16, 16, 4) and img.dtype == np.uint8
    spans = [e for e in prof.events() if e.name.startswith("pt.")]
    added = {k: v - before.get(k, 0) for k, v in P.COUNTS.items()
             if v != before.get(k, 0)}
    return spans, added


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("child,parent", [
    ("pt.route", "pt.render"), ("pt.quantize", "pt.render"),
    ("pt.readback", "pt.render"), ("pt.build", "pt.route")])
def test_render_span_encloses_its_children(child, parent):
    spans, _ = _traced_frame(small_scene())
    assert all(e.is_user_annotation for e in spans)
    (outer,) = [e for e in spans if e.name == parent]
    (inner,) = [e for e in spans if e.name == child]
    assert _inside(inner, outer)
    assert inner.cpu_parent is not None
    assert inner.cpu_parent.name == parent


@pytest.mark.parametrize("again", [False, True], ids=["fresh", "prepared"])
def test_a_build_records_one_span_and_its_counters(again):
    """A fresh ``Scene`` is prepared once: one ``pt.build``, one
    ``build.prep_scene`` and its nanoseconds; the same ``Scene`` again
    records and counts nothing."""
    scene = small_scene()
    if again:
        _frame(scene)
    spans, added = _traced_frame(scene)
    builds = [e for e in spans if e.name == "pt.build"]
    if again:
        assert builds == [] and added == {}
    else:
        assert len(builds) == 1
        assert set(added) == {"build.prep_scene", "build_ns.prep_scene"}
        assert added["build.prep_scene"] == 1
        assert added["build_ns.prep_scene"] > 0


def test_span_is_off_without_a_profiler(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with P.span("pt.test"):
        pass
    assert _frame(small_scene()).shape == (16, 16, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="pt.test"):
            with P.span("pt.test"):
                pass


@pytest.mark.parametrize("adds", [[1], [3, 4], [0, 2**40, 5]])
def test_count_adds_exactly(adds):
    name = f"test.count/{len(adds)}"
    before = P.COUNTS.get(name, 0)
    for n in adds:
        P.count(name, n)
    assert P.COUNTS[name] == before + sum(adds)
    P.count(name)
    assert P.COUNTS[name] == before + sum(adds) + 1


def test_build_counts_its_nanoseconds_exactly(monkeypatch):
    """``_memo``'s miss adds the difference of its two clock readings to
    ``build_ns.<name>``, whatever the build."""
    ticks = iter([1_000_000_007, 1_000_123_456])
    monkeypatch.setattr(intersect, "perf_counter_ns", lambda: next(ticks))
    cache, owner = {}, object()
    before = dict(P.COUNTS)
    got = intersect._memo(cache, owner, "k", "test.table", lambda: 42)
    assert got == 42
    assert P.COUNTS["build.test.table"] == before.get("build.test.table",
                                                      0) + 1
    assert P.COUNTS["build_ns.test.table"] == \
        before.get("build_ns.test.table", 0) + 123_456 - 7
    assert intersect._memo(cache, owner, "k", "test.table",
                           lambda: 0) == 42       # a hit: counts nothing
    assert P.COUNTS["build.test.table"] == before.get("build.test.table",
                                                      0) + 1


def test_nested_builds_count_their_own_time(monkeypatch):
    """One ``derived`` table built inside another's build: two ``pt.build``
    spans, the inner one inside the outer; ``build_ns`` of the inner is
    its clock difference and of the outer its difference less the
    inner's, so the two add up to the outer build's time."""
    scn = intersect.prep_scene(small_scene())       # built before the ticks
    base = 5_000_000_000
    # outer start, inner start, inner end, outer end
    ticks = iter([base, base + 1_000, base + 31_000, base + 100_000])
    monkeypatch.setattr(intersect, "perf_counter_ns", lambda: next(ticks))
    before = dict(P.COUNTS)

    # The profiler's event list drops a span that is the only child of a
    # span of its name, so the outer build does a torch op of its own.
    def outer(s):
        torch.zeros(1)
        return intersect.derived(s, "test.inner", "cpu", lambda _: 2) + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert intersect.derived(scn, "test.outer", "cpu", outer) == 3
    added = {k: v - before.get(k, 0) for k, v in P.COUNTS.items()
             if v != before.get(k, 0)}
    assert added == {"build.test.outer": 1, "build.test.inner": 1,
                     "build_ns.test.inner": 30_000,
                     "build_ns.test.outer": 70_000}
    builds = sorted((e for e in prof.events() if e.name == "pt.build"),
                    key=lambda e: e.time_range.start)
    assert len(builds) == 2 and _inside(builds[1], builds[0])
    assert intersect._NESTED_NS == []
