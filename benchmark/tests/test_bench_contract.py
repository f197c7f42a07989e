"""BENCHMARK.json against the benchmark's contract, and every part it
names found by name from its file."""

import json
import os
import re

import pytest

from benchmark.harness import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        text = fp.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd[1].startswith(tuple(p + "/" for p in bench["paths"]))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check(bench):
    """A check of the full 24 cells fits into its 43,200 seconds."""
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(bench, section, keys):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    assert 1 <= len(names) <= 24
    for e in bench[section]:
        assert set(e) == keys
        assert NAME.match(e["name"]) and _line(e["why"])
    if section == "configs":
        files = [e["file"] for e in bench["configs"]]
        assert len(files) == len(set(files))
        used = {w["config"] for w in bench["workloads"]}
        for e in bench["configs"]:
            assert e["name"] in used
            assert _line(e["source"]) and e["source"].startswith("https://")
            assert e["file"].startswith(tuple(p + "/" for p in
                                              bench["paths"]))
            assert len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
            with open(os.path.join(ROOT, e["file"])) as fp:
                cfg = json.load(fp)
            assert cfg["name"] == e["name"] and cfg["source"] == e["source"]
            assert cfg["reduced"] == e["reduced"]
    else:
        pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
        assert len(pairs) == len(set(pairs))
        four = sum(w["chips"] == 4 for w in bench["workloads"])
        assert all(w["chips"] in (1, 4) for w in bench["workloads"])
        assert four <= max(1, len(names) // 4)
        for w in bench["workloads"]:
            assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics(bench):
    e2e, pl = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + pl]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    assert "setup_s" in [m["name"] for m in e2e]
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        assert m["moves"] in [x["name"] for x in e2e]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # one layer, one spelling
    assert all(len(v) == 1 for v in layers.values())
    for m in e2e + pl:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_every_part_found_by_name(bench):
    """Each cell's files, configuration, traffic, work and each metric's
    reader are found from the names in BENCHMARK.json."""
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c.workload["name"] == w["name"]
        assert c.config["name"] == w["config"]
        assert c.traffic["loop"] == "closed"
        assert c.work is not None and c.work["cell"] == w["name"]
        assert c.config["ranks"] == w["chips"]
        assert c.end_to_end and c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert callable(spec.reader(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


def test_limits_are_set(bench):
    """Every cell compares at least one number of its check."""
    for w in bench["workloads"]:
        lim = spec.cell(w["name"], bench).workload["check"]["limits"]
        assert lim and all(v > 0 for v in lim.values())
