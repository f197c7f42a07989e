"""Same-call A/B of the light pass's kernels (L1, L2a, L2b) between two
source trees, on one CUDA GPU.

    python -m opencl_montecarlo_path_tracing_tpu_torch.tools.ab_light_pass \
        --trees OLD NEW [--runs 10]

Each tree is the root of a checkout (an older commit unpacked with
``git archive`` into a git-ignored directory, and ``.``).  The trees are
timed in turns OLD, NEW, NEW, OLD, each turn in a process of its own that
imports that tree's package and builds its kernels first: L1, L2a and L2b
through the tree's ``ops/light_pass.py`` wrappers (the arguments every
version takes) on ``demo_scene()`` and on the 20,736-triangle sheet
(``large_mesh_scene()``), at the main paths' 512 work items / chains a
light and 8 rounds, after a warm-up: each call's mean time over
``--runs`` calls on CUDA events (what a caller waits, the wrapper's host
time included where it exceeds the kernel's) and the kernel's device time
a launch over the launches a torch.profiler trace of ``--runs`` calls
holds.  Prints every turn's times (one JSON line a turn) and each
measure's mean OLD / NEW ratio.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N, ROUNDS = 512, 8
KERNELS = {"L1": "light_emit_kernel", "L2a": "light_mlt_seed_kernel",
           "L2b": "light_mlt_chain_kernel"}


def time_tree(tree: str, runs: int) -> dict:
    """ms a call of each kernel on each scene, with ``tree``'s package."""
    sys.path.insert(0, tree)
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, large_mesh_scene)
    if not os.path.abspath(L.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {L.__file__}, not {tree}'s package")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / runs

    def device_ms(fn, kernel: str):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        ev = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        return sum(ev) / 1e3 / len(ev) if ev else None

    key, out = make_key(0), {}
    for name, scene in (("demo", demo_scene()[0]),
                        ("sheet", large_mesh_scene())):
        scn = prep_scene(scene)
        seed = L.mlt_seed(key, scn, N, DEFAULT)
        for k, fn in (
                ("L1", lambda: L.emit(key, scn, N, DEFAULT)),
                ("L2a", lambda: L.mlt_seed(key, scn, N, DEFAULT)),
                ("L2b", lambda: L.mlt_mutate_emit(key, scn, N, ROUNDS,
                                                  DEFAULT, 1e-3, seed))):
            out[f"{name} {k} events"] = ms(fn)
            out[f"{name} {k} device"] = device_ms(fn, KERNELS[k])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--time", metavar="TREE", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.time:
        print(json.dumps(time_tree(os.path.abspath(a.time), a.runs)))
        return 0
    if not a.trees:
        ap.error("--trees OLD NEW is required")
    old, new = (os.path.abspath(t) for t in a.trees)
    times = {old: [], new: []}
    for tree in (old, new, new, old):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time", tree, "--runs", str(a.runs)],
                           capture_output=True, text=True, timeout=900,
                           cwd=tree)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        t = json.loads(r.stdout.strip().splitlines()[-1])
        times[tree].append(t)
        print(json.dumps({"tree": tree, "ms": t}))
    for k in times[old][0]:
        if any(t[k] is None for t in times[old] + times[new]):
            print(f"{k}: not measured (the profiler recorded no launch)")
            continue
        o = sum(t[k] for t in times[old]) / 2
        n = sum(t[k] for t in times[new]) / 2
        print(f"{k}: old {o:.4f} ms, new {n:.4f} ms, {o / n:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
