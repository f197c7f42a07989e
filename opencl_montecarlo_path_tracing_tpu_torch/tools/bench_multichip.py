"""Multi-rank scaling harness.

Port of ``tools/bench_multichip.py``.  Run it under torchrun, one rank a
GPU; rank 0 prints the rows, one JSON line each:

    torchrun --nproc-per-node 4 -m \\
        opencl_montecarlo_path_tracing_tpu_torch.tools.bench_multichip
    ... --json out.json      # also write all rows to a file
    ... --device cpu --size 64 --spp 16 --repeats 1   # the harness on gloo

Rank counts are the powers of two up to the group's size; a mesh of n
ranks takes ranks [0, n) and the others wait.  Measured per rank count n:

  strong scaling - the FIXED workload (--size^2 x --spp camera paths on
    the demo scene) sharded over an n-rank spp mesh; ideal = n-fold
    speedup over n = 1.  --spp (and --n-vlp) are rounded ONCE, down to a
    multiple of the largest rank count, before the sweep, so every row
    renders the same samples; the rows print that spp.
  weak scaling - --spp-local samples PER RANK (total spp = n *
    --spp-local); ideal = flat time as n grows.
  2-D mesh - the strong workload on an (n/2 rows x 2 spp) mesh when
    n >= 4 (the rows x spp composition of the CLI's --shard RxS).
  bidirectional - strong scaling of the VLP integrator whose LIGHT pass
    is sharded too (an emission window a rank + all_gather).

Times are the minimum of --repeats wall-clock renders after a warm-up,
each ending when the film is on the host.  One rank a GPU (NCCL refuses
two ranks on one); --device cpu runs the ranks over gloo.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist


def bench(fn, repeats: int) -> float:
    """Min-of-repeats seconds; ``.cpu()`` waits for the film."""
    fn().cpu()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn().cpu()
        best = min(best, time.perf_counter() - t0)
    return best


def rank_counts(world: int, cap: int = 0) -> list:
    top = min(world, cap) if cap else world
    counts, n = [], 1
    while n <= top:
        counts.append(n)
        n *= 2
    return counts


def round_once(value: int, counts: list) -> int:
    """``value`` rounded down to a multiple of the largest rank count (at
    least that count), so every row of the sweep does the same work."""
    top = counts[-1]
    return max(value // top, 1) * top


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1024,
                    help="image size (headline 1024)")
    ap.add_argument("--spp", type=int, default=1024,
                    help="TOTAL spp for the strong-scaling rows")
    ap.add_argument("--spp-local", type=int, default=128,
                    help="per-rank spp for the weak-scaling rows")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--n-vlp", type=int, default=512)
    ap.add_argument("--max-devices", type=int, default=0,
                    help="cap the rank-count sweep (0 = all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write all rows to PATH as a JSON array")
    ns = ap.parse_args(argv)

    from ..core.rng import make_key
    from ..parallel import multihost
    from ..parallel.mesh import (
        make_mesh_2d, make_spp_mesh, render_bidirectional_sharded,
        render_super_sharded, render_super_sharded_2d)
    from ..scene.builtin import demo_scene

    multihost.initialize(device=ns.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    counts = rank_counts(world, ns.max_devices)
    spp = round_once(ns.spp, counts)
    nv = round_once(ns.n_vlp, counts)
    primary = multihost.is_primary()
    device = multihost.rank_device(ns.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if primary:
        print(f"# device={kind} ranks={world} sweep={counts} spp={spp} "
              f"n_vlp={nv} (--spp {ns.spp}, --n-vlp {ns.n_vlp})",
              file=sys.stderr)

    scene, tag = demo_scene()
    key = make_key(0)
    size = ns.size
    rows, base = [], {}

    def emit(row):
        if primary:
            rows.append(row)
            print(json.dumps(row), flush=True)

    for n in counts:
        mesh = make_spp_mesh(n, device=ns.device)
        mesh2 = (make_mesh_2d(n // 2, 2, device=ns.device)
                 if n >= 4 and size % (n // 2) == 0 else None)
        if mesh.rank is not None:
            s = bench(lambda: render_super_sharded(key, scene, size, size,
                                                   spp, mesh), ns.repeats)
            base.setdefault("strong", s)
            mp = size * size * spp / s / 1e6
            emit({"mode": "strong", "variant": "super", "mesh": f"1d-spp{n}",
                  "n_devices": n, "device": kind,
                  "config": f"{size}x{size} spp={spp}", "scene": tag,
                  "ms": s * 1e3, "mpaths_per_s": mp,
                  "mpaths_per_s_per_device": mp / n,
                  "speedup_vs_1": base["strong"] / s})

            wspp = ns.spp_local * n
            sw = bench(lambda: render_super_sharded(key, scene, size, size,
                                                    wspp, mesh), ns.repeats)
            base.setdefault("weak", sw)
            mpw = size * size * wspp / sw / 1e6
            emit({"mode": "weak", "variant": "super", "mesh": f"1d-spp{n}",
                  "n_devices": n, "device": kind,
                  "config": f"{size}x{size} spp={wspp}", "scene": tag,
                  "ms": sw * 1e3, "mpaths_per_s": mpw,
                  "mpaths_per_s_per_device": mpw / n,
                  "efficiency_vs_1": base["weak"] / sw})

            if mesh2 is not None:
                s2 = bench(lambda: render_super_sharded_2d(
                    key, scene, size, size, spp, mesh2), ns.repeats)
                mp2 = size * size * spp / s2 / 1e6
                emit({"mode": "strong", "variant": "super",
                      "mesh": f"2d-{n // 2}x2", "n_devices": n,
                      "device": kind, "config": f"{size}x{size} spp={spp}",
                      "scene": tag, "ms": s2 * 1e3, "mpaths_per_s": mp2,
                      "mpaths_per_s_per_device": mp2 / n,
                      "speedup_vs_1": base["strong"] / s2})

            sb = bench(lambda: render_bidirectional_sharded(
                key, scene, size, size, spp, mesh, n_vlp=nv), ns.repeats)
            base.setdefault("bpt", sb)
            mpb = size * size * spp / sb / 1e6
            emit({"mode": "strong", "variant": "bidirectional",
                  "mesh": f"1d-spp{n}", "n_devices": n, "device": kind,
                  "config": f"{size}x{size} spp={spp} n_vlp={nv}",
                  "scene": tag, "ms": sb * 1e3, "mpaths_per_s": mpb,
                  "mpaths_per_s_per_device": mpb / n,
                  "speedup_vs_1": base["bpt"] / sb})
        if dist.is_initialized():
            dist.barrier()

    if ns.json and primary:
        with open(ns.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"# wrote {len(rows)} rows to {ns.json}", file=sys.stderr)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
