"""Every part of a cell is a file found by its name: the entry, the scene
and mesh makers, the traffic generator, the reference.  The harness names
none of them, so a later cell adds files and never edits one."""

import glob
import os
import re

import pytest

from benchmark.harness import check, loop, spec, traffic

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 4_000_000_007
SMALL_SHEET = {"kind": "ripple_sheet", "n_major": 16, "n_minor": 8,
               "min_det": 0.02, "depth": 20.0, "amp_frac": 0.075,
               "periods": 6.0}


def _parts(cell):
    c = spec.cell(cell)
    cfg = c.config
    return [("entries", cfg["entry"]), ("scenes", cfg["scene"]["kind"]),
            ("meshes", cfg["scene"]["mesh"]["kind"]),
            ("reference", cfg["reference"]), ("loops", c.traffic["loop"])]


@pytest.mark.parametrize("cell", CELLS)
def test_every_part_is_a_file_found_by_name(cell):
    want = {"entries": "Entry", "scenes": "make", "meshes": "make",
            "reference": "film_pixels", "loops": "Stream"}
    for kind, name in _parts(cell):
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, kind,
                                           name + ".py"))
        assert callable(getattr(spec.plugin(kind, name), want[kind]))


@pytest.mark.parametrize("kind,name", [
    ("entries", "no_such_entry"), ("meshes", "../harness/spec"),
    ("loops", "closed.py"), ("harness", "spec"), ("reference", ""),
])
def test_unknown_part_is_refused(kind, name):
    with pytest.raises((KeyError, ValueError)):
        spec.plugin(kind, name)


def test_harness_names_no_part():
    """No file of the harness or the command names an entry, scene, mesh,
    loop or reference: each is found through the cell's files."""
    names = {name for cell in CELLS for _, name in _parts(cell)}
    assert {"api_render", "super_bitmaps", "torus", "ripple_sheet",
            "closed", "super_film"} <= names
    sources = glob.glob(os.path.join(spec.BENCH_DIR, "harness", "*.py"))
    sources.append(os.path.join(spec.BENCH_DIR, "run.py"))
    for path in sources:
        with open(path) as fp:
            text = fp.read()
        for n in names:
            assert not re.search(r"[\"'.]" + n + r"\b", text), (path, n)


def test_closed_loop_requests():
    """Frame seeds are a pure function of (--seed, k), warm-ups are
    seeded apart, and ``fresh_every`` marks every n-th frame fresh
    without changing any seed."""
    mix = {"loop": "closed", "clients": 1, "seed_rule": "splitmix64",
           "warmup_frames": 2}
    a = traffic.stream(mix, SEED)
    b = traffic.stream(dict(mix, fresh_every=3), SEED)
    seeds = [a.request(k)[0] for k in range(9)]
    assert seeds == [b.request(k)[0] for k in range(9)]
    assert seeds == [traffic.stream(mix, SEED).request(k)[0]
                     for k in range(9)]
    assert len(set(seeds)) == 9
    assert not any(a.request(k)[1] for k in range(9))
    assert [k for k in range(9) if b.request(k)[1]] == [0, 3, 6]
    assert {a.warmup_seed(i) for i in range(2)}.isdisjoint(seeds)
    assert traffic.stream(mix, SEED + 1).request(0)[0] != seeds[0]
    with pytest.raises(ValueError):
        traffic.stream(dict(mix, clients=2), SEED)


def test_fresh_frames_are_checked_alike():
    """Frames rendered from a fresh program scene (``fresh_every``) pass
    the same check: the program prepares the scene anew, the image is
    the same."""
    mix = {"loop": "closed", "clients": 1, "seed_rule": "splitmix64",
           "warmup_frames": 1, "fresh_every": 2}
    ov = {"width": 2, "height": 64, "spp": 4}
    with loop.session("super.frames", "cpu", overrides=ov) as s:
        stream = traffic.stream(mix, SEED)
        keep = check.Reservoir(3, SEED)
        times, _ = loop.window(s.entry, stream, frames=4, keep=keep)
    assert len(times) == 4 and len(keep.kept()) == 4
    vals = check.numbers(s.cfg, s.raw, SEED, keep.kept(), 128, s.device)
    assert vals["px_differ_share"] == 0.0


def test_setup_split_sums_to_the_set_up():
    t0 = loop.process_start()
    marks = {"b": t0 + 3.0, "a": t0 + 1.0, "c": t0 + 3.5}
    split = loop.setup_split(marks)
    assert list(split) == ["a", "b", "c"]
    assert split == pytest.approx({"a": 1.0, "b": 2.0, "c": 0.5})
    assert sum(split.values()) == pytest.approx(3.5)
