"""Finds a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the configurations,
cells and metrics.  Everything that belongs to one of them sits in a file
of its own, found by its name:

* ``benchmark/configs/<config>.json``: the deployment (the file that
  ``BENCHMARK.json``'s config entry names), which names the parts below
  that serve it: its ``entry``, its ``scene`` kind and mesh kind, and its
  ``reference``;
* ``benchmark/traffic/<traffic>.json``: the parameters of a traffic mix,
  read by the generator that its ``loop`` names;
* ``benchmark/workloads/<cell>.json``: the cell, naming its
  configuration and traffic, and the limits of its check;
* ``benchmark/work/<cell>.json``: the cell's frozen roofline work, counted
  by the reference (``tools/count_work.py``);
* ``benchmark/metrics/<metric>.py``: the reader of one metric;
* ``benchmark/entries/<entry>.py``: the call into the program;
* ``benchmark/scenes/<kind>.py``, ``benchmark/meshes/<kind>.py``: the
  makers of a scene's raw arrays and of its mesh;
* ``benchmark/loops/<loop>.py``: a traffic generator;
* ``benchmark/reference/<reference>.py``: a plain reference.

So a later cell, configuration, traffic mix or metric is files added
beside these and entries added to ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str):
    with open(path) as fp:
        return json.load(fp)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict        # the cell's entry in BENCHMARK.json
    config: dict       # the configuration's file
    traffic: dict      # the traffic mix's file
    workload: dict     # the cell's file
    work: dict | None  # the frozen roofline work, if counted
    end_to_end: list   # BENCHMARK.json's end-to-end metrics of this cell
    per_layer: list    # BENCHMARK.json's per-layer metrics of this cell


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with every part it names, read from its files."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(ROOT, configs[entry["config"]]["file"]))
    workload = _json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: the cell's file names {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    traffic = _json(os.path.join(BENCH_DIR, "traffic",
                                 f"{entry['traffic']}.json"))
    work_path = os.path.join(BENCH_DIR, "work", f"{name}.json")
    work = _json(work_path) if os.path.isfile(work_path) else None
    return Cell(name, entry, config, traffic, workload, work,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


PLUGIN_KINDS = ("entries", "scenes", "meshes", "loops", "reference")


def plugin(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py`` (``kind`` one of
    ``PLUGIN_KINDS``; ``name`` a Python identifier)."""
    if kind not in PLUGIN_KINDS or not str(name).isidentifier():
        raise ValueError(f"no {kind!r} part named {name!r}")
    if not os.path.isfile(os.path.join(BENCH_DIR, kind, f"{name}.py")):
        raise KeyError(f"no file benchmark/{kind}/{name}.py")
    return importlib.import_module(f"benchmark.{kind}.{name}")


def reader(metric: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
