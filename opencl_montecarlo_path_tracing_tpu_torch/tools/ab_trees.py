"""Same-call A/B of two source trees' kernels on one CUDA GPU: their films
bit for bit, and their times.

    python -m opencl_montecarlo_path_tracing_tpu_torch.tools.ab_trees \
        --set films|walk|light_pass|dda|diag|grid --trees OLD NEW \
        [--runs 10]

Each tree is the root of a checkout (an older commit unpacked with
``git archive`` into a git-ignored directory, and ``.``).  The trees run
in turns OLD, NEW, NEW, OLD, each turn in a process of its own that
imports that tree's package, builds its kernels and runs the set's
workloads through the wrappers' arguments every version takes:

``films``
    B2/B3 (``film_super_mega``) on the 20,736- and 262,144-triangle sheets
    (``large_mesh_scene``) at 512x512x4 under the default and the
    reference quirks, and forced onto ``demo_scene()``; B4
    (``film_vlp_mega``) on the VLP main paths' tables - the demo's and
    ``dense_vlp_scene()``'s emitted tables, the demo's Metropolis table
    dense and with its grid - at 512x512, samples 0-1 of 256, culled and
    cull-free, under the default and the reference quirks; and the
    ``walk`` set.  Times: B2/B3 at 512x512x4 on each sheet (events, and
    its kernel's device time a launch), B4's render pass at 512x512x256
    on each table, and the ``walk`` set's.
``walk``
    B4's walk route (past 512 triangles) at the large-mesh VLP paths'
    launch, 256x256x16 with the emitted table (512 work items a light), on
    the 20,736-, 262,144- and 1,048,576-triangle sheets under the default
    quirks and on the 20,736 sheet under the reference quirks.  Its films
    are held to the first OLD turn's under the CRN contract
    (``utils/crn.py``), not bit for bit: a redesigned walk may visit the
    triangles in another order.  Times: each launch on CUDA events and its
    kernel's device time a launch.
``light_pass``
    L1, L2a and L2b through ``ops/light_pass.py`` on ``demo_scene()`` and
    on the 20,736-triangle sheet, at the main paths' 512 work items /
    chains a light and 8 rounds.  Times: each call on CUDA events (what a
    caller waits, the wrapper's host time included where it exceeds the
    kernel's) and the kernel's device time a launch over the launches a
    torch.profiler trace of ``--runs`` calls holds.  No films.
``dda``
    B8-dda-closest and B8-dda-occ through ``ops/diag_dda.py`` on the grid
    diagnostic's scenes (``tools/diag_dda.py``: the demo scene and the 5k
    and 20k sheets) at 512x512, with every structure the tool runs there:
    the closest call over cell, Morton and (up to 25,000 triangles) dense
    lists, and each light's occlusion call over cell and Morton shadow
    lists from the Morton call's hit points, each set of lists ranked once
    (``ranked``) where the tree has it.  Films: every t, m and occlusion
    map.  Times: each call on CUDA events, and the device time a call of
    every kernel the calls launch.
``diag``
    B8-prim's four arms (``ops/diag_takelist.py``) on the primitives
    tool's inputs at its 128 blocks x 200 repetitions, and B8-loops' 13
    arms (``ops/diag_loops.py``) at the loop tool's trip counts from a
    random start, tile and table (``RandomState(3)``).  Films: every
    output and the take-list's count.  Times: each call on CUDA events,
    and the device time a call of the arm's kernel (B8-prim: the
    ``takelist_kernel`` launches, not the wrapper's fill of the count;
    B8-loops: every kernel the call launches, which is the arm's alone).

``grid``
    The trianglegrid DDA route's kernels through ``ops/grid.py``: B11
    (``film_grid_mega``) on the 20,736-triangle sheet and the demo torus
    at 512x512x64 under the default quirks, and on the sheet at
    512x512x2 under the reference quirks; B11w (``grid_walk``) on the
    sheet's 512x512 camera rays (sample 0 of 64, from t = 1e9), and
    ``traverse_triangles`` on the tier-1 DDA route's first shadow call
    (a 9-light copy of the sheet at 256x256, recorded from a one-sample
    render).  Films: every film and every walk output.  Times: B11 on
    CUDA events; B11w on events and its kernel's device time a call.

Event times are the mean of ``--runs`` calls after a warm-up.  A turn
writes its films to a ``.npz`` file and prints one JSON line of times.
Then every turn's films are compared with the first OLD turn's, bit for
bit (the walk route's under the CRN contract, :func:`films_agree`), and
each time's mean OLD / NEW ratio is printed; the command exits 1 if a
film differs or a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

W = H = 512
VSPP = 256
WALK_W = WALK_H = 256   # the large-mesh VLP paths' launch
WALK_SPP = 16
WALK_PREFIX = "B4 walk "   # films held under the CRN contract
N, ROUNDS = 512, 8
KERNELS = {"L1": "light_emit_kernel", "L2a": "light_mlt_seed_kernel",
           "L2b": "light_mlt_chain_kernel"}


def event_ms(fn, runs: int) -> float:
    """Mean ms a call of ``fn`` over ``runs`` calls on CUDA events, after
    one warm-up call."""
    import torch
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


def device_ms(fn, runs: int, kernel: str | None):
    """Device ms a launch of ``kernel`` in a torch.profiler trace of
    ``runs`` calls of ``fn``, or with ``kernel`` None the device ms a call
    of every kernel the calls launch; None when the trace holds no
    launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ev = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and (kernel is None or kernel in e.name)]
    if not ev:
        return None
    return sum(ev) / 1e3 / (runs if kernel is None else len(ev))


def films_agree(key: str, a: np.ndarray, b: np.ndarray) -> tuple:
    """(agree, how) of two turns' ``key`` outputs: the walk route's films
    under the CRN contract of ``WALK_SPP`` samples, every other output bit
    for bit."""
    if not key.startswith(WALK_PREFIX):
        return bool(np.array_equal(a, b)), None
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
    ok, st = crn_ok(a, b, WALK_SPP)
    return ok, st


def walk_turn(runs: int) -> tuple[dict, dict]:
    """The ``walk`` set: (films, times in ms)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        DEFAULT, REFERENCE)
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M4
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    key = make_key(0)
    films, times = {}, {}
    shape = f"{WALK_W}x{WALK_H}x{WALK_SPP}"
    for nm in ((144, 72), (512, 256), (1024, 512)):
        scn = prep_scene(large_mesh_scene(*nm))
        nt = int(scn.tri_v0.shape[0])
        vlps = V.emit_vlps(key, scn, 512, device="cuda")
        quirk_sets = (("default", DEFAULT),) + (
            (("reference", REFERENCE),) if nt == 20736 else ())
        for qn, q in quirk_sets:
            films[f"{WALK_PREFIX}sheet {nt} {qn} {shape}"] = \
                M4.film_vlp_mega(key, scn, vlps, WALK_W, WALK_H, WALK_SPP,
                                 quirks=q, device="cuda")
        fn = lambda: M4.film_vlp_mega(  # noqa: E731
            key, scn, vlps, WALK_W, WALK_H, WALK_SPP, device="cuda")
        times[f"{WALK_PREFIX}sheet {nt} {shape}"] = event_ms(fn, runs)
        times[f"{WALK_PREFIX}sheet {nt} {shape} device"] = device_ms(
            fn, runs, "mega_vlp_kernel")
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in films.items()}, times


def films_turn(runs: int) -> tuple[dict, dict]:
    """The ``films`` set: (films, times in ms)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        DEFAULT, REFERENCE)
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M4
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, dense_vlp_scene, large_mesh_scene)
    key = make_key(0)
    films, times = {}, {}
    quirk_sets = (("default", DEFAULT), ("reference", REFERENCE))
    for nm in ((144, 72), (512, 256)):
        scn = prep_scene(large_mesh_scene(*nm))
        nt = int(scn.tri_v0.shape[0])
        for qn, q in quirk_sets:
            films[f"B2/B3 sheet {nt} {qn}"] = M.film_super_mega(
                key, scn, W, H, 4, quirks=q, device="cuda")
        fn = lambda: M.film_super_mega(  # noqa: E731
            key, scn, W, H, 4, device="cuda")
        times[f"B2/B3 sheet {nt} {W}x{H}x4"] = event_ms(fn, runs)
        times[f"B2/B3 sheet {nt} {W}x{H}x4 device"] = device_ms(
            fn, runs, "mega_blocked_kernel")
    demo = prep_scene(demo_scene()[0])
    films["B2/B3 forced demo"] = M.film_super_mega(
        key, demo, W, H, 4, device="cuda", force_blocked=True)
    dense = prep_scene(dense_vlp_scene())
    mlt = mlt_vlps(key, demo, 512, 8, device="cuda")
    grid = V.build_vlp_grid(mlt, V.vlp_grid_static_res(int(mlt.shape[0])))
    for name, scn, vlps, g in (
            ("demo emitted", demo, V.emit_vlps(key, demo, 512, device="cuda"),
             None),
            ("dense emitted", dense,
             V.emit_vlps(key, dense, 512, device="cuda"), None),
            ("demo Metropolis", demo, mlt, None),
            ("demo Metropolis, grid", demo, mlt, grid)):
        films[f"B4 {name} table"] = vlps
        for qn, q in quirk_sets:
            for cull in (True, False):
                films[f"B4 {name} {qn} cull={cull}"] = M4.film_vlp_mega(
                    key, scn, vlps, W, H, 2, spp_total=VSPP, grid=g,
                    quirks=q, cull=cull, device="cuda")
        times[f"B4 {name} {W}x{H}x{VSPP}"] = event_ms(
            lambda: M4.film_vlp_mega(key, scn, vlps, W, H, VSPP, grid=g,
                                     device="cuda"), runs)
    torch.cuda.synchronize()
    films = {k: v.cpu().numpy() for k, v in films.items()}
    wf, wt = walk_turn(runs)
    return {**films, **wf}, {**times, **wt}


def light_pass_turn(runs: int) -> tuple[dict, dict]:
    """The ``light_pass`` set: (no films, times in ms)."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, large_mesh_scene)
    key, times = make_key(0), {}
    for name, scene in (("demo", demo_scene()[0]),
                        ("sheet", large_mesh_scene())):
        scn = prep_scene(scene)
        seed = L.mlt_seed(key, scn, N, DEFAULT)
        for k, fn in (
                ("L1", lambda: L.emit(key, scn, N, DEFAULT)),
                ("L2a", lambda: L.mlt_seed(key, scn, N, DEFAULT)),
                ("L2b", lambda: L.mlt_mutate_emit(key, scn, N, ROUNDS,
                                                  DEFAULT, 1e-3, seed))):
            times[f"{name} {k} events"] = event_ms(fn, runs)
            times[f"{name} {k} device"] = device_ms(fn, runs, KERNELS[k])
    return {}, times


def dda_turn(runs: int) -> tuple[dict, dict]:
    """The ``dda`` set: (maps, times in ms)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K
    from opencl_montecarlo_path_tracing_tpu_torch.tools import diag_dda as TD
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_host as DH)
    films, times = {}, {}

    def timed(name, fn):
        times[f"{name} events"] = event_ms(fn, runs)
        times[f"{name} device"] = device_ms(fn, runs, None)

    def on_card(lists, table):
        ls = K.lists_on(lists, "cuda")
        return K.ranked(ls, table) if hasattr(K, "ranked") else ls

    o, d = DH.primary_rays(W)
    for tag in ("demo", "5k", "20k"):
        scn = TD.scene_arrays(tag)
        boxes = {"cell": DH.cell_boxes(scn)[2], "morton": DH.morton_boxes(scn)}
        if int(scn.tri_v0.shape[0]) <= TD.DENSE_MAX:
            boxes["dense"] = DH.dense_boxes(scn)
        for name, bx in boxes.items():
            lists = (DH.dense_lists(len(bx.start), W, H) if name == "dense"
                     else DH.tile_lists(o, d, bx, W, H, device="cuda"))
            tb = K.table_on(bx, "cuda")
            ls = on_card(lists, tb)
            fn = lambda: K.closest(ls, tb, W, H)
            films[f"{tag} {name} t"], films[f"{tag} {name} m"] = fn()
            timed(f"{tag} {name} closest", fn)
        x = DH.hit_points(*(films[f"{tag} morton {k}"].cpu().numpy()
                            for k in "tm"), o, d)
        for li, light in enumerate(np.asarray(scn.lights, np.float64)):
            sd, dist = DH.shadow_rays(x, light)
            rays = [torch.from_numpy(a).cuda()
                    for a in DH.shadow_inputs(x, sd, dist, W, H)]
            for name in ("cell", "morton"):
                tb = K.table_on(boxes[name], "cuda")
                ls = on_card(DH.tile_lists(
                    x, sd, boxes[name], W, H, tmax_cap=dist, sort_near=False,
                    device="cuda"), tb)
                fn = lambda: K.occluded(ls, tb, *rays)
                films[f"{tag} {name} occ L{li}"] = fn()
                timed(f"{tag} {name} occ L{li}", fn)
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in films.items()}, times


def diag_turn(runs: int) -> tuple[dict, dict]:
    """The ``diag`` set: (outputs, times in ms)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_takelist as P)
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_loops as TL)
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_primitives as TP)
    films, times = {}, {}
    x, flags = TP.inputs("cuda")
    for arm in P.ARMS:
        fn = lambda: P.run(arm, x, P.NB, P.REPS, flags)
        films[f"prim {arm}"], films[f"prim {arm} count"] = fn()
        times[f"prim {arm} events"] = event_ms(fn, runs)
        times[f"prim {arm} device"] = device_ms(fn, runs, "takelist_kernel")
    rng = np.random.RandomState(3)
    x, acc0 = (torch.from_numpy(rng.rand(8, 128).astype(np.float32)).cuda()
               for _ in range(2))
    table = torch.from_numpy(rng.rand(*L.TABLE_SHAPE).astype(np.float32)
                             ).cuda()
    for arm in L.ARMS:
        n1, n2 = TL.COUNTS[arm]
        fn = lambda: L.run(arm, x, n1, n2, acc0, table)
        films[f"loops {arm}"] = fn()
        times[f"loops {arm} events"] = event_ms(fn, runs)
        times[f"loops {arm} device"] = device_ms(fn, runs, None)
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in films.items()}, times


def grid_turn(runs: int) -> tuple[dict, dict]:
    """The ``grid`` set: (films and walk outputs, times in ms)."""
    import dataclasses
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        DEFAULT, REFERENCE)
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, large_mesh_scene)
    key, spp = make_key(0), 64
    films, times = {}, {}

    def walk_times(name, fn, runs):
        times[f"{name} events"] = event_ms(fn, runs)
        times[f"{name} device"] = device_ms(fn, runs, "grid_walk_kernel")

    sheet = large_mesh_scene()
    for name, scene in (("sheet", sheet), ("torus", demo_scene()[0])):
        scn = prep_scene(scene)
        tab = G.triangle_tables(scn, device="cuda")
        fn = lambda: G.film_grid_mega(key, scn, tab, W, H, spp,  # noqa
                                      device="cuda")
        films[f"B11 {name} {W}x{H}x{spp}"] = fn()
        times[f"B11 {name} {W}x{H}x{spp}"] = event_ms(fn, max(1, runs // 2))
    scn = prep_scene(sheet)
    tab = G.triangle_tables(scn, device="cuda")
    films[f"B11 sheet reference {W}x{H}x2"] = G.film_grid_mega(
        key, scn, tab, W, H, 2, spp_total=spp, quirks=REFERENCE,
        device="cuda")
    ii, jj = C.pixel_grid(W, H, device="cuda")
    ray_id = (jj * W + ii).to(torch.int64) * spp
    o, d = primary_rays(make_camera(z_sign=-1.0), ii, jj,
                        *R.randn_draws(key, ray_id, C.SITE_CAMERA, 4))
    n = o.shape[0]
    z = torch.zeros(n, dtype=torch.float32, device="cuda")
    args = (o, d, torch.full((n,), 1e9, dtype=torch.float32, device="cuda"),
            torch.zeros(n, dtype=torch.int32, device="cuda"), z, z, z,
            torch.zeros(n, dtype=torch.bool, device="cuda"))
    fn = lambda: G.grid_walk(*args, tab, DEFAULT)  # noqa: E731
    for k, v in zip(("t", "m", "nx", "ny", "nz", "needs"), fn()):
        films[f"B11w camera rays {k}"] = v
    walk_times(f"B11w sheet camera rays {n}", fn, runs)
    # the tier-1 DDA route's first shadow call, recorded
    nine = dataclasses.replace(sheet, lights=np.tile(sheet.lights,
                                                     (5, 1))[:9])
    calls, walk = [], G.traverse_triangles

    def recording(*a, **kw):
        calls.append((a, kw))
        return walk(*a, **kw)
    G.traverse_triangles = recording
    try:
        pt.render("trianglegrid", nine, 256, 256, spp=1, seed=0, accel="dda",
                  device="cuda")
    finally:
        G.traverse_triangles = walk
    a, kw = calls[1]
    a = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
    fn = lambda: walk(*a, **kw)  # noqa: E731
    for k, v in zip(("t", "m", "nx", "ny", "nz", "needs"), fn()):
        films[f"B11w tier-1 shadow call {k}"] = v
    walk_times(f"B11w tier-1 shadow call {a[0].shape[0]}", fn, runs)
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in films.items()}, times


SETS = {"films": films_turn, "walk": walk_turn,
        "light_pass": light_pass_turn, "dda": dda_turn, "diag": diag_turn,
        "grid": grid_turn}


def run_turn(name: str, tree: str, out: str, runs: int) -> dict:
    """One turn of set ``name`` with ``tree``'s package: writes its films
    to ``out`` and returns its times."""
    sys.path.insert(0, tree)
    import opencl_montecarlo_path_tracing_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not {tree}'s package")
    films, times = SETS[name](runs)
    np.savez(out, **films)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", choices=sorted(SETS), required=True)
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--one", nargs=2, metavar=("TREE", "OUT"),
                    help=argparse.SUPPRESS)   # a turn, in its own process
    args = ap.parse_args(argv)
    if args.one:
        tree, out = args.one
        print(json.dumps(run_turn(args.set, os.path.abspath(tree), out,
                                  args.runs)))
        return 0
    if not args.trees:
        ap.error("--trees OLD NEW is required")
    old, new = (os.path.abspath(t) for t in args.trees)
    turns = [("OLD", old), ("NEW", new), ("NEW", new), ("OLD", old)]
    times = {"OLD": [], "NEW": []}
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, (tag, tree) in enumerate(turns):
            out = os.path.join(tmp, f"turn{i}.npz")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--set", args.set,
                 "--runs", str(args.runs), "--one", tree, out], cwd=tree,
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            t = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"turn {i} {tag}: " + json.dumps(t), flush=True)
            times[tag].append(t)
            files.append(out)
        first = np.load(files[0])
        differ = set()
        for i, f in enumerate(files[1:], 1):
            other = np.load(f)
            for k in first.files:
                ok, st = films_agree(k, first[k], other[k])
                if st is not None:
                    print(f"turn {i} {k} against turn 0 (CRN contract): "
                          f"{'ok' if ok else 'VIOLATED'} {st}")
                if not ok:
                    differ.add(k)
        differ = sorted(differ)
        print(f"films: {len(first.files)} a turn; differing from the first "
              f"OLD turn's: {differ or 'none'}")
    for k in times["OLD"][0]:
        if any(t[k] is None for t in times["OLD"] + times["NEW"]):
            print(f"{k}: not measured (the profiler recorded no launch)")
            continue
        o = np.mean([t[k] for t in times["OLD"]])
        n = np.mean([t[k] for t in times["NEW"]])
        print(f"{k}: OLD {o:.4f} ms, NEW {n:.4f} ms, OLD / NEW {o / n:.3f}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
