"""The program's spans in a trace of the window (``harness/spans.py``), on
synthetic event lists: device-idle time inside each span, its nested
spans' included; the spans' mirrors on the device busy nothing; every
metric reads the same with and without them; the build counters'
growth."""

import types

import pytest

from benchmark.harness import spans, spec, trace


def ev(name, a, b, device=False, annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=types.SimpleNamespace(name="CUDA" if device else "CPU"),
        is_user_annotation=annotation)


def span(name, a, b):
    """A span on the host, and its mirror on the device."""
    return [ev(name, a, b, annotation=True),
            ev(name, a, b, device=True, annotation=True)]


# two frames in a window of [0, 200] us; the device is busy on [30, 60],
# [62, 65] and [120, 170]: idle [0, 30], [60, 62], [65, 120], [170, 200]
# (117 us)
BASE = [ev(trace.WINDOW_SPAN, 0, 200, annotation=True),
        ev(trace.FRAME_SPAN, 5, 100, annotation=True),
        ev(trace.FRAME_SPAN, 105, 195, annotation=True),
        ev("aten::add", 70, 72), ev("kern", 30, 60, device=True),
        ev("Memcpy DtoH", 62, 65, device=True),
        ev("kern", 120, 170, device=True)]
# the program's spans in both frames: pt.render around a kernel span
# (nested in it, a build and in the build another build: a repeated
# name) and the readback
PROGRAM = (span("pt.render", 10, 98) + span("pt.kernel.mega_super", 12, 31)
           + span("pt.build", 14, 25) + span("pt.build", 16, 20)
           + span("pt.readback", 61, 96)
           + span("pt.render", 110, 190)
           + span("pt.kernel.mega_super", 112, 121)
           + span("pt.readback", 171, 188))


def test_span_idle_is_inclusive():
    sp = spans.span_times(BASE + PROGRAM)
    assert sp.window_s == pytest.approx(200e-6)
    # idle [0, 30], [60, 62], [65, 120], [170, 200]
    assert sp.idle_s == pytest.approx(117e-6)
    got = {n: (s.count, s.host_s, s.idle_s) for n, s in sp.by_name.items()}
    want = {
        # [10, 98]: idle [10, 30], [60, 62], [65, 98]; [110, 190]:
        # [110, 120], [170, 190]
        "pt.render": (2, 168e-6, 85e-6),
        # [12, 31] idle to 30; [112, 121] idle to 120
        "pt.kernel.mega_super": (2, 28e-6, 26e-6),
        # [14, 25] and the build nested in it, [16, 20]: counted once
        "pt.build": (2, 11e-6, 11e-6),
        # [61, 96]: [61, 62], [65, 96]; [171, 188]
        "pt.readback": (2, 52e-6, 49e-6),
        "bench.frame": (2, 185e-6, 102e-6),
    }
    assert set(got) == set(want)
    for name, (count, host_s, idle_s) in want.items():
        assert got[name][0] == count, name
        assert got[name][1] == pytest.approx(host_s), name
        assert got[name][2] == pytest.approx(idle_s), name
    assert sp.idle(lambda n: n.startswith("pt.kernel.")) == \
        pytest.approx(26e-6)


def test_spans_outside_the_window_and_no_window():
    assert spans.span_times(PROGRAM) is None
    late = span("pt.render", 190, 260)
    sp = spans.span_times(BASE + late)
    r = sp.by_name["pt.render"]
    assert (r.count, r.host_s, r.idle_s) == (1, pytest.approx(10e-6),
                                             pytest.approx(10e-6))
    assert "pt.kernel.mega_super" not in spans.span_times(
        BASE + span("pt.kernel.mega_super", 210, 220)).by_name


def test_program_spans_leave_the_device_trace_alone():
    """The program's spans, mirrored on the device as user annotations,
    change neither busy time nor any kernel count of the window."""
    a = trace.reduce_events(BASE, 2)
    b = trace.reduce_events(BASE + PROGRAM, 2)
    assert a.busy_s == pytest.approx(83e-6) and b.busy_s == a.busy_s
    assert (b.kernel_s, b.kernels, b.window_s) == \
        (a.kernel_s, a.kernels, a.window_s)
    assert sum(s for _, s in b.idle_gaps) == \
        pytest.approx(sum(s for _, s in a.idle_gaps))


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_every_metric_reads_the_same_with_program_spans(cell):
    c = spec.cell(cell)
    peak = {"fp32_flops": 6.7e13, "hbm_bytes_per_s": 3.35e12}
    kernel = {"super.frames": "mega_super_kernel",
              "trianglegrid.frames": "mega_blocked_kernel"}[cell]

    def events(with_program):
        out = [e if e.name != "kern" else ev(kernel, e.time_range.start,
                                             e.time_range.end, True)
               for e in BASE]
        return out + (PROGRAM if with_program else [])

    def read(with_program):
        ctx = types.SimpleNamespace(
            cell=c, cfg=c.config, work=c.work,
            summary=trace.reduce_events(events(with_program), 2), frames=2,
            times_ms=[9.0, 9.5], window_s=0.02, setup_s=8.0,
            scene_prep_ms=0.5, peak=peak)
        return {m["name"]: spec.reader(m["name"])(ctx)
                for m in c.end_to_end + c.per_layer}

    plain, traced = read(False), read(True)
    assert plain == traced
    assert plain["device_idle_pct"] == pytest.approx(58.5)


@pytest.mark.parametrize("before,after,want", [
    ({}, {"build.prep_scene": 5, "build_ns.prep_scene": 3_000_000}, 0.6),
    ({"build_ns.prep_scene": 10**9, "build_ns.mega_super.block_tables": 7},
     {"build_ns.prep_scene": 10**9 + 25_000_000,
      "build_ns.mega_super.block_tables": 7 + 125_000_000,
      "build.prep_scene": 12}, 30.0),
    ({"build.prep_scene": 1}, {"build.prep_scene": 1}, None),
])
def test_build_ms_reads_the_counters_growth(before, after, want):
    got = spans.build_ms(before, after, 5)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("prefix,want", [
    ("build.", {"prep_scene": 1, "mega_super.block_tables": 2}),
    ("build_ns.", {"prep_scene": 4_000_000})])
def test_growth_by_name(prefix, want):
    before = {"build.prep_scene": 3, "build_ns.prep_scene": 10**9,
              "build_ns.grid.tri_table": 5}
    after = {"build.prep_scene": 4, "build_ns.prep_scene": 10**9 + 4 * 10**6,
             "build_ns.grid.tri_table": 5, "build.mega_super.block_tables": 2}
    assert spans.growth(before, after, prefix) == want


def test_fresh_reading_splits_a_fresh_frame():
    """A fresh frame's ``pt.render`` [10, 98] holds a build [14, 25] and
    one nested in it [16, 20]: 11 us in builds, 77 us outside them."""
    from benchmark.tools.span_split import fresh_reading
    before = {"build.prep_scene": 2, "build_ns.prep_scene": 9}
    after = {"build.prep_scene": 3, "build_ns.prep_scene": 9 + 7_000,
             "build.mega_super.block_tables": 1,
             "build_ns.mega_super.block_tables": 4_000}
    got = fresh_reading(BASE + PROGRAM[:8], before, after)
    assert got["builds"] == {"prep_scene": 1, "mega_super.block_tables": 1}
    assert got["build_ms"] == pytest.approx(
        {"prep_scene": 0.007, "mega_super.block_tables": 0.004})
    assert got["span_host_ms"]["pt.build"] == pytest.approx(0.011)
    assert got["span_count"]["pt.build"] == 2
    assert got["outside_build_ms"] == pytest.approx(0.088 - 0.011)
    assert "span_host_ms" not in fresh_reading(PROGRAM, before, after)


@pytest.mark.parametrize("offset,want", [(0.0, 3.0), (-300.0, -297.0)])
def test_launch_lag_sees_a_clock_offset(offset, want):
    """A kernel starts 3 us after its launch call; the device's clock
    read ``offset`` us off the host's shows as the lag."""
    from benchmark.tools.span_split import launch_lag_us
    events = []
    for t in (1000.0, 11000.0, 21000.0):
        events += [ev("cudaLaunchKernel", t, t + 5),
                   ev("mega_super_kernel", t + 3 + offset,
                      t + 8000 + offset, device=True),
                   ev("pt.kernel.mega_super", t - 300, t + 20,
                      device=True, annotation=True)]
    assert launch_lag_us(events) == pytest.approx(want)
    assert launch_lag_us(BASE) is None
