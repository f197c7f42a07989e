"""GPU smoke test of the PyTorch / CUDA port: every ported path and kernel.

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and skipped):

1. card and build: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the CUDA kernels built with nvcc from ``csrc/`` (one
   nvcc per source, all at once);
2. B1 (``mega_super``) vs its plain PyTorch version on the same inputs, on
   the card, held to the common-random-number contract of
   ``tools/validate_crn_frame.py`` (utils/crn.py: per-pixel difference on
   the display scale, p99.5 < 1e-5 and a razor-edge tie fraction (> 1e-4)
   < 0.6%);
3. B4 (``mega_vlp``) vs its plain version under the same contract: the GPU
   tests' cases, and the bench tables at 512x512, samples 0-1 of 256 - the
   demo scene's emitted 1024-row table, the dense-VLP scene's (478 of 1024
   rows live) and the 4096-row Metropolis table, dense and grid;
4. B6 (``gather_vlp``) vs its plain version on 512x512 random shading points
   against 64, 1024 and 4096 VLPs (rtol = atol = 1e-5);
5. the super main path: ``api.render("super")`` on ``demo_scene()`` at
   1024x1024 with 1024 spp; the film is checked, quantised and written as a
   PAM file, and Mpaths/s is timed with CUDA events over 3 runs;
6. the VLP main paths: ``api.render`` at 512x512 with 256 spp -
   bidirectional, metropolis and metropolis_vlpgrid on ``demo_scene()``,
   bidirectional on ``dense_vlp_scene()`` - each timed over 3 runs after a
   warm-up, its light pass and render pass timed apart, and the Metropolis
   chain's device-busy share read from a profile;
7. the tier-1 VLP route: bidirectional under the REFERENCE_LMEM quirks
   (outside B4's gate) at 256x256x4 runs the plain wavefront on the card,
   whose gather is B6; its film is held to the contract against the same
   render with the plain scan gather;
8. B2/B3 (``mega_blocked``) vs B1 and vs its plain version: forced onto
   B1's cases and the demo scene (max abs against B1's film), on an
   1,800-triangle ripple sheet against the plain scan, and against the
   tier-1 plain film (whose traces are B7's plain version) on the 20,736
   sheet at 512x512x4, the 262,144 sheet at 512x512, sample 0 of 4, and
   the 1,048,576 sheet on the top, middle and bottom 16 rows of 512x512,
   samples 0-1 of 4, all under the contract (and max abs 2e-5 where no
   pixel ties); on each sheet at 512x512x4 the kernel's time and its work
   tally (``blocked_stats``): the yardstick's needed pairs, this design's
   own need (pairs of the 32-row sub-blocks each ray's test passes), the
   pairs the warps test, the box tests of each level and the clock64 split
   of the cycles into walk and row scans, and beside the yardstick's bound
   the bound restated over the design's own need and over the tested
   pairs;
9. B7 (``tri_closest``) vs its plain version on the 512x512 primary rays
   of the large-mesh scene x 20,736 triangles, and on the inputs of every
   B7 call of one bidirectional main-path render there (camera, shadow
   and light-pass rays): hit/miss and index agreement >= 99.9%, ``t`` at
   rtol 2e-4 where both take the same triangle; and that render's film
   against its plain version (plain gather, B7's plain version) under the
   contract;
10. the large-mesh main paths through ``api.render``: trianglegrid on
   ``large_mesh_scene()`` at 512x512x64 (``accel="auto"``: B2/B3), super
   on it and on the 262,144-triangle sheet at 512x512x4, bidirectional on
   it at 256x256x16 (the tier-1 route: B7 and B6), each timed over 3 runs;
   ``accel="dda"`` (the uniform-grid walk) on a band, held against the
   kernel under the contract;
11. B5 (``mega_simple``) vs its plain version under the simple family's
   contract (utils/crn.py ``SIMPLE``: p95 < 1e-5, ties on < 2%, and max
   abs 2e-5 where no pixel ties): the GPU tests' cases at 5, 0 and 1
   bounces, and the simple main path's full frame (1024x1024, samples 0-1
   of 256), each also bit for bit; its tie pixels' band is rendered again
   at max_bounces 1..5 by both, and the first bounce at which they differ
   is printed as a histogram; the bound counts the live rays of each
   bounce (every sphere a trace: the yardstick), and is restated beside it
   over the sphere tests that the kernel's cull lets through for each ray;
   the kernel is timed at max_bounces 5 and 1;
12. the simple main path: ``api.render("simple")`` at 1024x1024 with 256
   spp (bench.py's simple row), timed over 3 runs after a warm-up, its
   film written as a PAM file;
13. the nodof main path: ``api.render("nodof")`` on ``demo_scene()`` at
   512x512 with an 8x8 sample grid (B1 once a render), timed the same
   way, and held against the tier-1 sample buffer of the same render
   (16.7 M rays, reduced on the card): <= 1 uint8 step, >= 99% exact;
14. B8-loops (``diag_loops``): the 13 arms of ``tools/diag_loops.py``
   against their plain versions at 1/100 of the JAX tool's trip counts
   (bit-equal; both timed there, the ``kernels`` line's row), then the
   tool's run at its own counts (ns an iteration);
15. B8-prim (``diag_takelist``): the four arms of
   ``tools/diag_primitives.py`` at 128 blocks x 200 repetitions (ns a
   block), each bit-equal to its plain version, the take-list's count the
   64 flagged blocks;
16. B8-dda (``diag_dda``, closest and occlusion): ``tools/diag_dda.py`` at
   512x512 on the demo scene and the 5k and 20,736-triangle sheets - the
   cell-list walk, the Morton take-list twin, the shadow arm of each, the
   dense scan and the per-lane DDA - every kernel call then held against
   its plain version (bit-equal maps), and cell == Morton == dense;
17. CLI: ``super``, ``bidirectional`` and ``metropolis_vlpgrid`` at 256x256
   with 4 spp on a scene written to text files, ``trianglegrid`` on the
   large-mesh scene's files, ``nodof`` on the demo files and ``simple`` /
   ``simplecpu`` at 64x64 with 2 spp; each must exit 0 and write a valid
   PAM.

Every path phase (5, 6, 7, 10, 12, 13) and each diagnostic's run (14-16)
sets all launch counts to 0 just before it and reads them just after; the
counts in the ``kernels`` line come from those runs.  Each kernel's
``bound_ms`` is the least time the card could take for the same work: the
larger of its bytes (inputs read once, output written once) over 3.35 TB/s
and its operations over 3.345e13 FP32 ops/s (132 SMs x 128 lanes x 1.98
GHz, one multiply or add an instruction: the kernels build with
--fmad=false), counting the (ray, triangle) pairs this run's data needs;
for the loop and primitive arms, each one dependent chain, the chain's
FP32 operations x 4 cycles over the SM clock (``bound_by``
``"latency"``).  The last line of standard output is ``{"ok": true,
"device": {...}}``; the line before it is the card's name and power limit,
the line before that each kernel's launches, error, times and bound.  The
script imports no JAX.  It exits non-zero, printing no result, without a
GPU or without the package beside it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

W = H = 1024          # the super main path: bench.py's headline super row
SPP = 1024
VW = VH = 512         # the VLP main paths: bench.py:95-101
VSPP = 256
TIMED_RUNS = 3
PKG = "opencl_montecarlo_path_tracing_tpu_torch"

LW = LH = 512          # the large-mesh main paths: bench.py:92-104, 112-163
LSPP_GRID = 64         # trianglegrid row
LSPP = 4               # super_largemesh / super_stream rows
BW = BH = 256          # bidirectional on the large mesh
BSPP = 16

# the card's ceilings for bound_ms (H100 SXM data sheet; FP32 without FMA
# contraction: each multiply and add is one instruction per lane)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 132 * 128 * 1.98e9
PAIR_OPS = 48         # multiplies + adds of one division-free M-T pair test
B7_PAIR_OPS = 113     # 4 x 13-term dot products + the epilogue
GATHER_PAIR_OPS = 20  # one (point, VLP) gather term
# B5's FP32 operations, counted from csrc/mega_simple.cu (compares, int
# and threefry work not counted): a sample's camera ray; a trace's floor
# test and each sphere test; a sphere normal's renormalisation; a hit's
# point, light direction and lamb; the floor's, a mirror's and the sky's
# shading
CAMERA_OPS = 50
FLOOR_OPS = 2
SPHERE_OPS = 19
RENORM_OPS = 10
HIT_OPS = 25
FLOOR_SHADE_OPS = 13
MIRROR_OPS = 30
SKY_OPS = 12

SW = SH = 1024         # the simple main path: bench.py:92-94
SSPP = 256
NW = NH = 512          # the nodof main path: bench.py:138-146
NSG = 8

# the B8 diagnostics: tools/diag_dda_pallas.py's size and scenes (the 20k
# sheet is the large-mesh rows' 20,736 triangles); the loop and primitive
# arms are one dependent chain each, so their bound is its latency: the
# chain's FP32 operations x 4 cycles (the dependent-issue latency of an
# FP32 add, multiply or max that microbenchmark studies report for Volta
# through Hopper, e.g. Jia et al. 2018, "Dissecting the NVIDIA Volta GPU
# Architecture via Microbenchmarking") / the SM clock (clocks.max.sm)
DIAG_SIZE = 512
DIAG_SCENES = ("demo", "5k", "20k")
FP32_CHAIN_CYCLES = 4
# FP32 operations a loop iteration's chain holds: one multiply and one add
# a step; the broadcast an add; a reduce its tree depth (the full reduce 5
# shuffle levels and 5 across 32 warps, the lane reduce 5 and 2 across a
# row's 4 warps, the sub reduce 3 across 8 rows) plus a multiply and an
# add; the copy and scalar arms one add
LOOP_CHAIN_OPS = {"bcast": 1, "reduce_full": 12, "reduce_lane": 9,
                  "reduce_sub": 5, "copy": 1, "scalar": 1}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, runs: int, warm_up: bool = True) -> float:
    """Mean ms per call of ``fn`` over ``runs`` calls, CUDA events, after
    one warm-up call (skipped when the caller has just run the same code)."""
    import torch
    if warm_up:
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


def timed_call(fn):
    """(fn(), its ms on CUDA events) for one call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def reset_counts():
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_dda, diag_loops, diag_takelist, gather_vlp, mega_simple,
        mega_super, mega_vlp, tri_closest)
    mega_super.LAUNCHES = mega_super.BLOCKED_LAUNCHES = 0
    mega_vlp.LAUNCHES = gather_vlp.LAUNCHES = tri_closest.LAUNCHES = 0
    mega_simple.LAUNCHES = 0
    diag_dda.CLOSEST_LAUNCHES = diag_dda.OCC_LAUNCHES = 0
    diag_takelist.LAUNCHES = diag_loops.LAUNCHES = 0


def read_counts() -> dict:
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_dda, diag_loops, diag_takelist, gather_vlp, mega_simple,
        mega_super, mega_vlp, tri_closest)
    return {"mega_super": mega_super.LAUNCHES,
            "mega_blocked": mega_super.BLOCKED_LAUNCHES,
            "mega_vlp": mega_vlp.LAUNCHES, "gather_vlp": gather_vlp.LAUNCHES,
            "tri_closest": tri_closest.LAUNCHES,
            "mega_simple": mega_simple.LAUNCHES,
            "diag_dda_closest": diag_dda.CLOSEST_LAUNCHES,
            "diag_dda_occ": diag_dda.OCC_LAUNCHES,
            "diag_takelist": diag_takelist.LAUNCHES,
            "diag_loops": diag_loops.LAUNCHES}


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the byte time and the operation
    time on the card's ceilings."""
    t_ops = ops / FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def shading_counts(key, scn, w, h, spp, spp_total):
    """(lit, casts) over samples 0..spp-1 of a w x h super film: primary
    hits the shading lights (floor, diffuse), and the (hit, light) pairs
    whose shadow ray the shading uses (front-facing lights) - the plain
    tier-1 trace on the card, the data behind B1's and B4's bounds."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        trace_ray)
    ii, jj = C.pixel_grid(w, h, device="cuda")
    pix = (jj * w + ii).to(torch.int64)
    cam = make_camera(z_sign=-1.0)
    lit_n = cast_n = 0
    for s in range(spp):
        ray_id = (pix * spp_total + s) & 0xFFFFFFFF
        r = R.randn_draws(key, ray_id, C.SITE_CAMERA, 4)
        o, d = primary_rays(cam, ii, jj, *r)
        tr = trace_ray(o, d, scn, sphere_material=3, plain=True)
        lit = (tr.material == 1) | (tr.material == 3)
        x = o + d * tr.t[..., None]
        for i in range(int(scn.lights.shape[0])):
            u1, u2 = R.rand2(key, ray_id, C.SITE_LIGHT0 + i)
            lp = torch.as_tensor(scn.lights[i, :3], device="cuda")
            ldir = C.normalize(
                lp + torch.stack([u1, u2, torch.zeros_like(u1)], -1) - x)
            cast_n += int((lit & (C.dot(ldir, tr.normal) >= 0)).sum())
        lit_n += int(lit.sum())
    return lit_n, cast_n


def gpu_tests():
    """tests/test_torch_gpu.py, loaded by path (an installed package may
    also be named "tests"); it imports no JAX."""
    spec = importlib.util.spec_from_file_location(
        "_torch_gpu_cases", os.path.join(ROOT, "tests", "test_torch_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_crn(name, a, b, spp, failed, atol=None, contract=None) -> float:
    """Print the contract's statistics of two films; returns the max abs
    film difference and records a violation in ``failed``.  With ``atol``,
    a pair with no tie pixel must also agree to ``atol``.  ``contract``
    defaults to the super/VLP families' (utils/crn.py ``SUPER``)."""
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import (
        SUPER, crn_ok)
    contract = SUPER if contract is None else contract
    a = a.cpu().numpy()
    b = b.cpu().numpy()
    if a.shape != b.shape or not np.isfinite(a).all():
        raise RuntimeError(f"{name}: bad kernel film {a.shape}")
    ok, st = crn_ok(a, b, spp, contract)
    if atol is not None and st["tie_frac"] == 0.0:
        ok = ok and st["max_abs"] <= atol
    qname = f"p{contract.quantile * 100:g}"
    print(f"  {name}: max {st['max']:.3e} {qname} {st['q']:.3e} "
          f"ties {st['tie_frac'] * 100:.3f}% max_abs_film "
          f"{st['max_abs']:.3e} {'ok' if ok else 'VIOLATION'}")
    if not ok:
        failed.append(name)
    return st["max_abs"]


def phase_card_and_build(card: str):
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.utils import build
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    info = build.build()
    build.load()
    print(f"build: {info.seconds:.1f} s ({os.path.relpath(info.path, ROOT)})")
    for line in info.log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_super_kernel_vs_plain(gt) -> float:
    """B1 on the GPU tests' cases plus the demo scene and the main path's
    film shape; returns the largest abs film error."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    print("B1 mega_super vs plain:")
    cases = [(name, prep_scene(make_scene()), seed, shape, kw,
              gt.QUIRKS[q])
             for name, make_scene, seed, shape, kw, q in gt.CASES]
    demo = prep_scene(demo_scene()[0])
    cases += [
        ("demo scene 256x256x4", demo, 0, (256, 256, 4), {}, DEFAULT),
        ("demo scene 1024x1024, samples 0-1 of 1024", demo, 0,
         (W, H, 2), dict(spp_total=SPP), DEFAULT),
    ]
    worst, failed = 0.0, []
    for name, scn, seed, (w, h, spp), kw, quirks in cases:
        key = make_key(seed)
        a = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", **kw)
        b = M.film_super_mega_plain(key, scn, w, h, spp, quirks=quirks,
                                    device="cuda", **kw)
        worst = max(worst, check_crn(name, a, b, spp, failed))
    if failed:
        raise RuntimeError(f"B1 kernel vs plain contract violated: {failed}")
    return worst


def vlp_bench_tables():
    """The VLP main paths' tables on the card: (name, scene arrays, vlps,
    grid or None)."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, dense_vlp_scene)
    key = make_key(0)
    demo = prep_scene(demo_scene()[0])
    dense = prep_scene(dense_vlp_scene())
    mlt = mlt_vlps(key, demo, 512, 8, device="cuda")
    grid = V.build_vlp_grid(mlt, V.vlp_grid_static_res(int(mlt.shape[0])))
    return [
        ("demo emitted 1024 rows", demo,
         V.emit_vlps(key, demo, 512, device="cuda"), None),
        ("dense_vlp_scene emitted 1024 rows", dense,
         V.emit_vlps(key, dense, 512, device="cuda"), None),
        ("demo Metropolis 4096 rows", demo, mlt, None),
        ("demo Metropolis 4096 rows, grid", demo, mlt, grid),
    ]


def live_overflow(vlps, grid) -> int:
    """The most live VLPs any cell of ``grid`` overlaps (the tier-1 gather
    keeps 62 a cell, the kernel's masked scan all of them)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    live = vlps[vlps[:, 3] > 0]
    amin, amax = V.vlp_aabbs(live)
    g = G.build_grid_cellscan(amin, amax, grid.vmin, grid.cell_size,
                              grid.res, cap=int(live.shape[0]) + 1)
    return int(torch.max(g.counts)) if g.counts.numel() else 0


def phase_vlp_kernel_vs_plain(gt, tables) -> dict:
    """B4 on the GPU tests' cases and the bench tables; returns the largest
    abs film error and the kernel / plain times at 512x512x2."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.grid import (
        MAX_NELS_PER_CELL)
    print("B4 mega_vlp vs plain:")
    worst, failed = 0.0, []
    for name in gt.VLP_CASES:
        scn, key, vlps, grid, (w, h, spp), kw = gt.vlp_case_inputs(name,
                                                                   "cuda")
        a = M.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                            device="cuda", **kw)
        b = M.film_vlp_mega_plain(key, scn, vlps, w, h, spp, grid=grid,
                                  device="cuda", **kw)
        worst = max(worst, check_crn(name, a, b, spp, failed))
    key = make_key(0)
    for name, scn, vlps, grid in tables:
        n_live = int((vlps[:, 3] > 0).sum())
        if grid is not None:
            over = live_overflow(vlps, grid)
            print(f"  {name}: grid {grid.res}, at most {over} live VLPs in "
                  f"a cell (tier-1 cap {MAX_NELS_PER_CELL}); dead VLPs' far "
                  "boxes fill the corner cell, beyond n_live")
            if over > MAX_NELS_PER_CELL:
                raise RuntimeError(f"{name}: a cell overflows with live VLPs;"
                                   " kernel and plain would differ there")
        a = M.film_vlp_mega(key, scn, vlps, VW, VH, 2, spp_total=VSPP,
                            grid=grid, device="cuda")
        b = M.film_vlp_mega_plain(key, scn, vlps, VW, VH, 2, spp_total=VSPP,
                                  grid=grid, device="cuda")
        worst = max(worst, check_crn(
            f"{name} ({n_live} live), {VW}x{VH} samples 0-1 of {VSPP}",
            a, b, 2, failed))
    if failed:
        raise RuntimeError(f"B4 kernel vs plain contract violated: {failed}")
    _, scn, vlps, _ = tables[0]
    k_ms = time_ms(lambda: M.film_vlp_mega(
        key, scn, vlps, VW, VH, 2, spp_total=VSPP, device="cuda"), 5)
    p_ms = time_ms(lambda: M.film_vlp_mega_plain(
        key, scn, vlps, VW, VH, 2, spp_total=VSPP, device="cuda"), 2)
    # work: primary pairs, one capped shadow ray per lit hit and light,
    # one gather term per (sample, live VLP)
    R, nt = VW * VH * 2, int(scn.tri_v0.shape[0])
    lit, _ = shading_counts(key, scn, VW, VH, 2, VSPP)
    n_live = int((vlps[:, 3] > 0).sum())
    ops = ((R + lit * int(scn.lights.shape[0])) * nt * PAIR_OPS
           + R * n_live * GATHER_PAIR_OPS)
    b_ms, b_by = bound(ops, vlps.shape[0] * 32 + nt * 48 + VW * VH * 12)
    print(f"  {tables[0][0]}, {VW}x{VH}x2: kernel {k_ms:.3f} ms, plain "
          f"PyTorch {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; {lit} lit "
          f"hits, {n_live} live VLPs)")
    return {"max_abs": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def phase_gather_kernel_vs_plain() -> dict:
    """B6 on 512x512 random shading points against 64, 1024, 4096 VLPs."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G
    print("B6 gather_vlp vs plain:")
    rng = np.random.default_rng(11)
    R = VW * VH
    x = rng.normal(5, 3, (R, 3)).astype(np.float32)
    n = rng.normal(0, 1, (R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tx, tn = (torch.from_numpy(a).cuda() for a in (x, n))
    worst_abs = worst_rel = 0.0
    times = {}
    for V in (64, 1024, 4096):
        vlps = rng.normal(5, 3, (V, 4)).astype(np.float32)
        vlps[:, 3] = np.abs(vlps[:, 3])
        vlps[::5, 3] = 0.0
        tv = torch.from_numpy(vlps).cuda()
        a = G.gather_vlps_mxu(tx, tn, tv)
        b = G.gather_vlps_mxu_plain(tx, tn, tv)
        if a.shape != (R,) or not torch.isfinite(a).all():
            raise RuntimeError(f"B6 V={V}: bad output {tuple(a.shape)}")
        d = (a - b).abs()
        max_abs = float(d.max())
        max_rel = float((d / b.abs().clamp_min(1e-30)).max())
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
        ok = bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5))
        k_ms = time_ms(lambda: G.gather_vlps_mxu(tx, tn, tv), 10)
        p_ms = time_ms(lambda: G.gather_vlps_mxu_plain(tx, tn, tv), 2)
        times[V] = (k_ms, p_ms)
        print(f"  {R} points x {V} VLPs: max_abs {max_abs:.3e} max_rel "
              f"{max_rel:.3e} {'ok' if ok else 'VIOLATION'}; kernel "
              f"{k_ms:.3f} ms, plain PyTorch {p_ms:.1f} ms")
        if not ok:
            raise RuntimeError(f"B6 kernel vs plain differ at V={V}")
    b_ms, b_by = bound(R * 4096 * GATHER_PAIR_OPS, R * 28 + 4096 * 16)
    print(f"  bound at {R} x 4096: {b_ms:.4f} ms ({b_by})")
    return {"max_abs": worst_abs, "max_rel": worst_rel, "ms": times[4096][0],
            "plain_ms": times[4096][1], "bound_ms": b_ms, "bound_by": b_by}


def phase_super_main_path(card: str) -> dict:
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.ops.reduce import (
        quantize_film)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import (
        ImgInfo, load_pam, save_pam)

    scene, tag = demo_scene()

    film, ms, counts = timed_renders(lambda: pt.render(
        "super", scene, W, H, spp=SPP, seed=0, device="cuda"))
    if counts["mega_super"] < TIMED_RUNS:
        raise RuntimeError(f"super main path launched B1 "
                           f"{counts['mega_super']} times in {TIMED_RUNS} "
                           "renders")
    f = film.cpu().numpy()
    mean = float(f.mean()) / SPP
    if f.shape != (H, W, 3) or not np.isfinite(f).all() \
            or not 0.5 < mean < 2.0:
        raise RuntimeError(f"bad main-path film: shape {f.shape}, "
                           f"mean/spp {mean}")
    mpaths = W * H * SPP / (ms / 1e3) / 1e6
    print(f"main path: super {W}x{H}x{SPP} on {tag}: {ms:.1f} ms/render, "
          f"{mpaths:.1f} Mpaths/s ({card}); film mean/spp {mean:.4f}, "
          f"launches {counts}")

    rgba = quantize_film(film).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.ppm")
        save_pam(out, ImgInfo(width=W, height=H, channels=4, data=rgba))
        img = load_pam(out)
        if (img.width, img.height) != (W, H) or \
                not np.array_equal(img.data, rgba):
            raise RuntimeError("result.ppm does not read back")

    # the kernel and its plain version at the main path's film shape (fewer
    # samples: the plain version runs ~1e4 small launches per sample), and
    # at 256x256x4
    scn = prep_scene(scene)
    key = make_key(0)
    times = {}
    for w, h, spp in ((W, H, 4), (256, 256, 4)):
        k_ms = time_ms(lambda: M.film_super_mega(
            key, scn, w, h, spp, device="cuda"), 5)
        p_ms = time_ms(lambda: M.film_super_mega_plain(
            key, scn, w, h, spp, device="cuda"), 2)
        times[(w, h, spp)] = (k_ms, p_ms)
        print(f"  {w}x{h}x{spp}: kernel {k_ms:.3f} ms, plain PyTorch "
              f"{p_ms:.1f} ms ({card})")
    # work at 1024x1024x4: every primary ray scans the mesh, and every
    # shadow ray the shading uses
    nt = int(scn.tri_v0.shape[0])
    _, casts = shading_counts(key, scn, W, H, 4, 4)
    b_ms, b_by = bound((W * H * 4 + casts) * nt * PAIR_OPS,
                       nt * 48 + W * H * 12)
    print(f"  bound at {W}x{H}x4: {b_ms:.4f} ms ({b_by}; {casts} shadow "
          "rays cast)")
    return {"launches": counts["mega_super"], "ms": times[(W, H, 4)][0],
            "plain_ms": times[(W, H, 4)][1], "render_ms": ms,
            "mpaths": mpaths, "bound_ms": b_ms, "bound_by": b_by}


def profiled(name, fn):
    """(fn(), a line of its torch.profiler summary: host wall time, device
    kernel time, kernel count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not kernels:
        return out, (f"{name}: {wall_ms:.1f} ms wall; device time not "
                     "measured (the profiler recorded no kernel)")
    return out, (f"{name}: {wall_ms:.1f} ms wall, {len(kernels)} kernels, "
                 f"{dev_ms:.1f} ms device-busy "
                 f"({100 * dev_ms / wall_ms:.2f}%), "
                 f"{1e3 * (wall_ms - dev_ms) / len(kernels):.2f} us of host "
                 "dispatch per kernel")


def phase_vlp_main_paths(card: str) -> dict:
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
        film_vlp)
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, dense_vlp_scene)

    demo, tag = demo_scene()
    paths = [("bidirectional", demo, tag), ("metropolis", demo, tag),
             ("metropolis_vlpgrid", demo, tag),
             ("bidirectional", dense_vlp_scene(), "dense_vlp_scene")]
    key = make_key(0)
    total = 0
    for variant, scene, stag in paths:
        film, ms, counts = timed_renders(lambda: pt.render(
            variant, scene, VW, VH, spp=VSPP, seed=0, device="cuda"))
        if counts["mega_vlp"] != TIMED_RUNS or counts["gather_vlp"]:
            raise RuntimeError(f"{variant} on {stag}: launches {counts} in "
                               f"{TIMED_RUNS} renders (want B4 once each)")
        total += counts["mega_vlp"]
        mpaths = VW * VH * VSPP / (ms / 1e3) / 1e6

        # the same render in its two passes, and the film it must equal
        scn = prep_scene(scene)
        use_grid = variant.endswith("vlpgrid")
        if variant == "bidirectional":
            def light():
                return V.emit_vlps(key, scn, 512, device="cuda"), None
        else:
            def light():
                vl = mlt_vlps(key, scn, 512, 8, device="cuda")
                grid = (V.build_vlp_grid(
                    vl, V.vlp_grid_static_res(int(vl.shape[0])))
                    if use_grid else None)
                return vl, grid
        if variant == "metropolis":
            # the chain's device-busy share, on the pass the check needs
            (vlps, grid), line = profiled("chain", light)
            print("  " + line)
        else:
            vlps, grid = light()
        # the Metropolis chain takes seconds: one more (warm) run times it
        light_ms = time_ms(light, TIMED_RUNS if variant == "bidirectional"
                           else 1, warm_up=False)
        render_ms = time_ms(lambda: film_vlp(
            key, scn, vlps, grid, VW, VH, VSPP, 0, VSPP, DEFAULT,
            device="cuda"), TIMED_RUNS)
        again = film_vlp(key, scn, vlps, grid, VW, VH, VSPP, 0, VSPP,
                         DEFAULT, device="cuda")
        f = film.cpu().numpy()
        if f.shape != (VH, VW, 3) or not np.isfinite(f).all() \
                or not torch.equal(film, again):
            raise RuntimeError(f"{variant} on {stag}: bad main-path film "
                               f"{f.shape}, or not the film of its passes")
        n_live = int((vlps[:, 3] > 0).sum())
        print(f"main path: {variant} {VW}x{VH}x{VSPP} on {stag}: "
              f"{ms:.1f} ms/render, {mpaths:.1f} Mpaths/s ({card}); light "
              f"pass {light_ms:.1f} ms, render pass {render_ms:.2f} ms "
              f"({n_live} live of {int(vlps.shape[0])} VLPs); film "
              f"mean/spp {float(f.mean()) / VSPP:.4f}, launches {counts}")
    return {"launches": total}


def phase_tier1_route(card: str) -> int:
    """bidirectional under REFERENCE_LMEM: B6 launches, B4 does not."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        REFERENCE_LMEM)
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    w = h = 256
    spp = 4
    scene = demo_scene()[0]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    film = pt.render("bidirectional", scene, w, h, spp=spp, seed=0,
                     quirks=REFERENCE_LMEM, device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    if counts["gather_vlp"] == 0 or counts["mega_vlp"]:
        raise RuntimeError(f"REFERENCE_LMEM route: launches {counts}")
    scn = prep_scene(scene)
    key = make_key(0)
    vlps = V.emit_vlps(key, scn, 512, REFERENCE_LMEM, device="cuda")
    want = M.film_vlp_mega_plain(key, scn, vlps, w, h, spp,
                                 quirks=REFERENCE_LMEM, device="cuda")
    failed = []
    check_crn(f"tier-1 bidirectional REFERENCE_LMEM {w}x{h}x{spp} (B6) vs "
              "scan gather", film, want, spp, failed)
    if failed:
        raise RuntimeError("tier-1 route: B6 film vs scan film violated")
    print(f"tier-1 route: {ms:.1f} ms ({card}), launches {counts}")
    return counts["gather_vlp"]


def phase_blocked_kernel_vs_plain(gt, card: str) -> dict:
    """B2/B3 forced onto B1's cases (against B1's film), on the GPU tests'
    meshes and an 1,800-triangle sheet (against the plain scan), and on
    the 20,736 / 262,144 / 1,048,576-triangle sheets (against the tier-1
    plain film, whose traces are B7's plain version)."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, large_mesh_scene)
    print("B2/B3 mega_blocked vs B1 and vs plain:")
    worst, failed = 0.0, []
    demo = prep_scene(demo_scene()[0])
    cases = [(name, prep_scene(make_scene()), seed, shape, kw,
              gt.QUIRKS[q]) for name, make_scene, seed, shape, kw, q
             in gt.CASES]
    cases += [
        ("demo scene 256x256x4", demo, 0, (256, 256, 4), {}, DEFAULT),
        ("demo scene 1024x1024, samples 0-1 of 1024", demo, 0, (W, H, 2),
         dict(spp_total=SPP), DEFAULT)]
    for name, scn, seed, (w, h, spp), kw, quirks in cases:
        key = make_key(seed)
        a = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", force_blocked=True, **kw)
        b = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", **kw)
        worst = max(worst, check_crn(f"{name}: forced vs B1", a, b, spp,
                                     failed, atol=2e-5))
    sheet = gt.sheet_scene(30, 30)
    cases = [(name, prep_scene(make_scene()), seed, shape, kw,
              gt.QUIRKS[q]) for name, make_scene, seed, shape, kw, q
             in gt.BLOCKED_CASES]
    cases += [("sheet 1800, 512x512 rows 200-263, samples 0-1 of 4",
               prep_scene(sheet), 0, (512, 512, 2),
               dict(spp_total=4, row_offset=200, rows=64), DEFAULT)]
    for name, scn, seed, (w, h, spp), kw, quirks in cases:
        key = make_key(seed)
        a = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", force_blocked=True, **kw)
        b = M.film_super_mega_plain(key, scn, w, h, spp, quirks=quirks,
                                    device="cuda", **kw)
        worst = max(worst, check_crn(f"{name}: vs plain scan", a, b, spp,
                                     failed, atol=2e-5))
    key = make_key(0)
    # against the tier-1 plain film: the 20,736 sheet at the super main
    # path's full shape (the plain film's time too), the 262,144 sheet over
    # the full frame at sample 0, the 1,048,576 sheet on 16-row bands at the
    # frame's top, middle and bottom (the edges graze the sheet)
    checks = [((144, 72), LSPP, ((0, LH),)),
              ((512, 256), 1, ((0, LH),)),
              ((1024, 512), 2, ((0, 16), (248, 16), (LH - 16, 16)))]
    p_ms = 0.0
    for nm, spp, bands in checks:
        scn = prep_scene(large_mesh_scene(*nm))
        nt = int(scn.tri_v0.shape[0])
        for row_offset, rows in bands:
            band = dict(spp_total=LSPP, row_offset=row_offset, rows=rows)
            a = M.film_super_mega(key, scn, LW, LH, spp, device="cuda",
                                  **band)
            b, ms = timed_call(lambda: M.film_super_mega_plain(
                key, scn, LW, LH, spp, device="cuda", **band))
            if (nm, spp, rows) == ((144, 72), LSPP, LH):
                p_ms = ms
            worst = max(worst, check_crn(
                f"sheet {nt}, {LW}x{LH} rows {row_offset}-"
                f"{row_offset + rows - 1}, samples 0-{spp - 1} of {LSPP}: "
                f"vs tier-1 plain (B7 plain, {ms / 1e3:.1f} s)", a, b, spp,
                failed, atol=2e-5))
        # the kernel alone at the super rows' shape (tables cached)
        k_ms = time_ms(lambda: M.film_super_mega(key, scn, LW, LH, LSPP,
                                                 device="cuda"), 3)
        st = M.blocked_stats(key, scn, LW, LH, LSPP)
        b_ms, b_by = bound(st["needed"] * PAIR_OPS, nt * 64 + LW * LH * 12)
        print(f"  sheet {nt}, {LW}x{LH}x{LSPP}: kernel {k_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {restated_blocked(st, nt, k_ms)}); "
              f"{blocked_split(st, LW * LH * LSPP)} ({card})")
    if failed:
        raise RuntimeError(f"B2/B3 kernel contract violated: {failed}")
    # the main path's kernel call: large_mesh_scene() at 512x512x4
    scn = prep_scene(large_mesh_scene())
    nt = int(scn.tri_v0.shape[0])
    k_ms = time_ms(lambda: M.film_super_mega(key, scn, LW, LH, LSPP,
                                             device="cuda"), 5)
    st = M.blocked_stats(key, scn, LW, LH, LSPP)
    pairs = st["needed"]
    b_ms, b_by = bound(pairs * PAIR_OPS, nt * 64 + LW * LH * 12)
    print(f"  sheet {nt}, {LW}x{LH}x{LSPP}: kernel {k_ms:.3f} ms, plain "
          f"PyTorch {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; {pairs} "
          f"needed pairs, {pairs / (LW * LH * LSPP):.0f} a sample; "
          f"{restated_blocked(st, nt, k_ms)}) ({card})")
    return {"max_abs": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def restated_blocked(st: dict, nt: int, k_ms: float) -> str:
    """B2/B3's bound restated over the work of its own walk (not the
    yardstick): the pairs of the 32-row sub-blocks each ray's own test
    passes, and the pairs its warps test; each with the kernel's share."""
    nbytes = nt * 64 + LW * LH * 12
    own, _ = bound(st["sub_needed"] * PAIR_OPS, nbytes)
    tested, _ = bound(st["tested"] * PAIR_OPS, nbytes)
    return (f"restated over this design's own need {own:.4f} ms, "
            f"{100 * own / k_ms:.1f}% of the kernel's time; over the "
            f"pairs its warps test {tested:.4f} ms, "
            f"{100 * tested / k_ms:.1f}%")


def blocked_split(st: dict, n: int) -> str:
    """B2/B3's work tally (``blocked_stats``) over ``n`` samples: pairs a
    sample (the yardstick's needed, this design's own need, tested by the
    warps), box tests a warp-sample by level, and the clock64 split of a
    warp's cycles."""
    ws = n / 32
    kc = max(st["kernel_cycles"], 1)
    return (f"a sample: {st['needed'] / n:.0f} needed pairs (yardstick), "
            f"{st['sub_needed'] / n:.0f} this design's own need, "
            f"{st['tested'] / n:.0f} tested by its warp "
            f"({st['tested'] / max(st['needed'], 1):.2f}x the yardstick, "
            f"{st['tested'] / max(st['sub_needed'], 1):.2f}x the own "
            f"need); a warp-sample: "
            f"{st['macro_tests'] / ws:.0f} node, {st['block_tests'] / ws:.0f}"
            f" block and {st['sub_tests'] / ws:.0f} sub-block box tests, "
            f"{kc / ws:.0f} cycles: walk {100 * st['walk_cycles'] / kc:.1f}%,"
            f" row scans {100 * st['scan_cycles'] / kc:.1f}%")


def b7_agreement(name, calls, min_hits: float) -> tuple[float, bool]:
    """B7 against its plain version on each (o, d, scn, quirks) of
    ``calls``: hit/miss agreement >= 99.9%; where both hit, the same
    triangle on >= 99.9% of rays (a razor-edge validity test may flip
    between the two sums, and then the ray's closest hit is another
    triangle at another ``t``); where it is the same, ``t`` within
    :func:`b7_t_bound`; more than ``min_hits`` of the rays hitting (the
    check is not vacuous).  Prints one line, returns (max abs ``t`` error
    on the same triangle, ok)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
    n = n_hit = n_both = hit_agree = idx_agree = n_out = 0
    max_abs = max_rel = max_ratio = 0.0
    for o, d, scn, quirks in calls:
        t, i = B7.triangle_closest(o, d, scn, quirks)
        tp, ip = B7.triangle_closest_plain(o, d, scn, quirks)
        hit, hitp = torch.isfinite(t), torch.isfinite(tp)
        both = hit & hitp
        same = both & (i == ip)
        if same.any():
            err = (t[same] - tp[same]).abs().double()
            lim = b7_t_bound(o[same], d[same], scn, ip[same], tp[same])
            n_out += int((err > lim).sum())
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / tp[same].abs()).max()))
            max_ratio = max(max_ratio, float((err / lim).max()))
        n += int(t.numel())
        n_hit += int(hitp.sum())
        n_both += int(both.sum())
        hit_agree += int((hit == hitp).sum())
        idx_agree += int(same.sum())
    agree_hit = hit_agree / max(n, 1)
    agree_idx = idx_agree / max(n_both, 1)
    ok = (n_out == 0 and agree_hit >= 0.999 and agree_idx >= 0.999
          and n_hit / max(n, 1) > min_hits)
    print(f"  {name}: {len(calls)} calls, {n} rays, hits {n_hit / n:.4f}, "
          f"hit agreement {agree_hit:.6f} ({n - hit_agree} rays differ), "
          f"index agreement {agree_idx:.6f} ({n_both - idx_agree} rays), "
          f"t on the same triangle max_abs {max_abs:.3e} max_rel "
          f"{max_rel:.3e}, at most {max_ratio:.3f} of its bound ({n_out} "
          f"over) {'ok' if ok else 'VIOLATION'}")
    return max_abs, ok


def b7_t_bound(o, d, scn, idx, t):
    """The most two FP32 evaluations of B7's ``t`` may differ by, for rays
    (o, d) on triangles ``idx`` at distance ``t``: the kernel and the
    plain version sum the K = 13 products of ``det`` and ``t*det`` in
    different orders, each within gamma_13 * sum|f_k w_k| of the exact
    sum (u = 2^-24 the unit roundoff, gamma_K = K u / (1 - K u)), and
    ``t = (t*det) * (1/det)`` rounds twice on each side:
    2 gamma_13 (S_tdet + |t| S_det) / |det| + 4 u |t|."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
    u = 2.0 ** -24
    gamma = 13 * u / (1 - 13 * u)
    f = B7._features(o, d).double()                       # (m, 13)
    w = B7.weights_on(scn, o.device)[idx].double()       # (m, 4, 16)
    det = (f * w[:, 0, :13]).sum(-1).abs()
    s_det = (f.abs() * w[:, 0, :13].abs()).sum(-1)
    s_tdet = (f.abs() * w[:, 3, :13].abs()).sum(-1)
    t = t.double().abs()
    return 2 * gamma * (s_tdet + t * s_det) / det + 4 * u * t


def recorded_b7_calls(fn) -> list:
    """Runs ``fn()`` with B7's wrapper wrapped so that each call's inputs
    (o, d, scn, quirks) are kept; returns them."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
    calls = []
    kernel = B7.triangle_closest

    def recording(o, d, scn, quirks):
        calls.append((o.clone(), d.clone(), scn, quirks))
        return kernel(o, d, scn, quirks)

    B7.triangle_closest = recording
    try:
        fn()
    finally:
        B7.triangle_closest = kernel
    return calls


def phase_tri_closest_vs_plain(card: str) -> dict:
    """B7 on the 512x512 primary rays (sample 0) of the large-mesh scene
    x its 20,736 triangles (also timed), and on every trace of one
    bidirectional main-path render there (camera, shadow and light-pass
    rays), whose film is then held against its plain version."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
        film_vlp_plain)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    print("B7 tri_closest vs plain:")
    scene = large_mesh_scene()
    scn = prep_scene(scene)
    nt = int(scn.tri_v0.shape[0])
    ii, jj = C.pixel_grid(LW, LH, device="cuda")
    ray_id = (ii + jj * LW).to(torch.int64)
    o, d = primary_rays(make_camera(z_sign=-1.0), ii, jj,
                        *R.randn_draws(make_key(0), ray_id, C.SITE_CAMERA, 4))
    R_ = LW * LH
    err, ok = b7_agreement(f"{R_} primary rays x {nt} triangles",
                           [(o, d, scn, DEFAULT)], min_hits=0.5)
    films = []
    calls = recorded_b7_calls(lambda: films.append(pt.render(
        "bidirectional", scene, BW, BH, spp=BSPP, seed=0, device="cuda")))
    sizes = sorted({int(c[0].shape[0]) for c in calls})
    err2, ok2 = b7_agreement(
        f"the traces of bidirectional {BW}x{BH}x{BSPP} (rays a call: "
        f"{sizes})", calls, min_hits=0.0)
    del calls
    # what the flips do to that film: the tier-1 render pass (B7, B6)
    # against its plain version on the same VLP table
    key = make_key(0)
    vlps = V.emit_vlps(key, scn, 512, device="cuda")
    plain, ms = timed_call(lambda: film_vlp_plain(
        key, scn, vlps, None, BW, BH, BSPP, 0, BSPP, DEFAULT,
        device="cuda"))
    failed = []
    check_crn(f"bidirectional {BW}x{BH}x{BSPP} tier 1 (B7, B6) vs plain "
              f"({ms / 1e3:.1f} s)", films[0], plain, BSPP, failed)
    k_ms = time_ms(lambda: B7.triangle_closest(o, d, scn, DEFAULT), 10)
    p_ms = time_ms(lambda: B7.triangle_closest_plain(o, d, scn, DEFAULT), 1,
                   warm_up=False)
    b_ms, b_by = bound(R_ * nt * B7_PAIR_OPS, R_ * 60 + nt * 256)
    print(f"  {R_} rays x {nt} triangles: kernel {k_ms:.3f} ms, plain "
          f"PyTorch {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}) ({card})")
    if not (ok and ok2) or failed:
        raise RuntimeError("B7 kernel vs plain outside its tolerance")
    return {"max_abs": max(err, err2), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_large_mesh_main_paths(card: str) -> dict:
    """trianglegrid (auto) and super on the large meshes (B2/B3),
    bidirectional on large_mesh_scene() (tier-1: B7 + B6); then the DDA
    walk on a band against the kernel."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.trianglegrid import (
        film_trianglegrid)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    large = large_mesh_scene()
    stream = large_mesh_scene(512, 256)
    paths = [("trianglegrid", large, LW, LH, LSPP_GRID, ("mega_blocked",)),
             ("super", large, LW, LH, LSPP, ("mega_blocked",)),
             ("super", stream, LW, LH, LSPP, ("mega_blocked",)),
             ("bidirectional", large, BW, BH, BSPP,
              ("tri_closest", "gather_vlp"))]
    total = dict.fromkeys(("mega_blocked", "tri_closest", "gather_vlp"), 0)
    for variant, scene, w, h, spp, want in paths:
        film, ms, counts = timed_renders(lambda: pt.render(
            variant, scene, w, h, spp=spp, seed=0, device="cuda"))
        if any(counts[k] == 0 for k in want) or any(
                counts[k] for k in counts if k not in want):
            raise RuntimeError(f"{variant} on {scene.n_triangles} "
                               f"triangles: launches {counts}, want only "
                               f"{want}")
        for k in want:
            total[k] += counts[k]
        f = film.cpu().numpy()
        mean = float(f.mean()) / spp
        if f.shape != (h, w, 3) or not np.isfinite(f).all() or mean <= 0:
            raise RuntimeError(f"{variant}: bad main-path film {f.shape}, "
                               f"mean/spp {mean}")
        mpaths = w * h * spp / (ms / 1e3) / 1e6
        print(f"main path: {variant} {w}x{h}x{spp} on {scene.n_triangles} "
              f"triangles: {ms:.1f} ms/render, {mpaths:.1f} Mpaths/s "
              f"({card}); film mean/spp {mean:.4f}, launches {counts}")
        if want == ("mega_blocked",):
            # the render split: the host preparation a Scene gets once, on
            # its first render (prep_scene, the block tables; timed on fresh
            # copies of the Scene), vs the kernel on the prepared scene
            t0 = time.perf_counter()
            for _ in range(TIMED_RUNS):
                scn = prep_scene(dataclasses.replace(scene))
                M.block_tables(scn, "cuda")
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_RUNS
            k_ms = time_ms(lambda: M.film_super_mega(
                make_key(0), scn, w, h, spp, device="cuda"), TIMED_RUNS)
            print(f"  split: first-render host preparation {host_ms:.1f} "
                  f"ms, kernel {k_ms:.2f} ms")
    # the reference-shaped DDA on the card, on a band, against the kernel
    scn = prep_scene(large)
    key = make_key(0)
    band = dict(row_offset=248, rows=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid, _ = G.triangle_grid(scn, device="cuda")
    dda = film_trianglegrid(key, scn, grid, LW, LH, 1, 0, LSPP_GRID, DEFAULT,
                            device="cuda", **band)
    torch.cuda.synchronize()
    dda_s = time.perf_counter() - t0
    auto = M.film_super_mega(key, scn, LW, LH, 1, spp_total=LSPP_GRID,
                             device="cuda", **band)
    failed = []
    check_crn(f"trianglegrid accel=dda vs auto (B2/B3), {LW}x{LH} rows "
              f"248-255, sample 0 of {LSPP_GRID} (grid {grid.res}, cap "
              f"{grid.items.shape[1]}; DDA {dda_s:.1f} s)", dda, auto, 1,
              failed)
    if failed:
        raise RuntimeError("trianglegrid DDA vs kernel contract violated")
    return total


def display_diff(a, b, spp) -> np.ndarray:
    """Per-pixel max-channel difference of two films on the CRN contract's
    display scale (utils/crn.py)."""
    d = np.abs(a.cpu().numpy().astype(np.float64)
               - b.cpu().numpy().astype(np.float64))
    return (d / spp * 64.0 / 255.0).max(axis=-1)


def simple_counts(key, w, h, spp, spp_total, max_bounces=5) -> dict:
    """B5's work over samples 0..spp-1 of a w x h simple film, from the
    plain trace on the card: per bounce the live rays traced, their floor
    and sphere hits, sky misses, the shadow rays cast (lamb >= 0) and the
    sphere tests those make up to their first hit (the floor first, as the
    kernel's any-hit stops); and the sphere tests that the kernel's cull
    lets through for each ray's own test (:func:`SphereCull`), on the
    traces and on the shadow rays."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
        simple_arrays)
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        trace_ray)
    scn = simple_arrays()
    ii, jj = C.pixel_grid(w, h, device="cuda")
    pix = (jj * w + ii).to(torch.int64)
    cam = make_camera(z_sign=-1.0)
    keys = ("live", "floor", "mirror", "sky", "cast", "shadow_tests",
            "cull_trace_tests", "cull_shadow_tests")
    n = {k: [0] * max_bounces for k in keys}
    eps, big = float(np.float32(0.01)), float(np.float32(1e9))
    cull = SphereCull(scn.sphere_centers)
    for s in range(spp):
        ray_id = (pix * spp_total + s) & 0xFFFFFFFF
        o, d = primary_rays(cam, ii, jj,
                            *R.randn_draws(key, ray_id, C.SITE_CAMERA, 4))
        alive = torch.ones_like(ii, dtype=torch.bool)
        for b in range(max_bounces):
            tr = trace_ray(o, d, scn, sphere_material=2, plain=True)
            n["cull_trace_tests"][b] += cull.trace_tests(o, d, alive)
            m = torch.where(alive, tr.material, -1)
            x = o + d * tr.t[..., None]
            u1, u2 = R.rand2(key, ray_id, C.SITE_LIGHT0
                             + b * C.SITE_STRIDE_BOUNCE)
            ldir = C.normalize(torch.stack(
                [9.0 + u1, 9.0 + u2, torch.full_like(u1, 16.0)], -1) - x)
            hit = (m == 1) | (m == 2)
            cast = hit & (C.dot(ldir, tr.normal) >= 0)
            ox, oy, oz = x.unbind(-1)
            dx, dy, dz = ldir.unbind(-1)
            p = -oz * (1.0 / dz)
            still = cast & ~((p > eps) & (p < big))
            tests = torch.zeros_like(ray_id)
            for cx, cy, cz in scn.sphere_centers:
                tests += still
                px, py, pz = ox - float(cx), oy - float(cy), oz - float(cz)
                bb = px * dx + py * dy + pz * dz
                q = bb * bb - (px * px + py * py + pz * pz - 1.0)
                sr = -bb - torch.sqrt(torch.clamp_min(q, 0.0))
                still = still & ~((q > 0.0) & (sr < big) & (sr > eps))
            for k, v in (("live", alive), ("floor", m == 1),
                         ("mirror", m == 2), ("sky", m == 0),
                         ("cast", cast)):
                n[k][b] += int(v.sum())
            n["shadow_tests"][b] += int(tests.sum())
            n["cull_shadow_tests"][b] += cull.shadow_tests(
                x, ldir, cast & ~((p > eps) & (p < big)))
            bounce = m == 2
            o = torch.where(bounce[..., None], x, o)
            d = torch.where(bounce[..., None], C.reflect(d, tr.normal), d)
            alive = alive & bounce
    return n


class SphereCull:
    """A torch twin, on the card, of B5's per-ray cull
    (``csrc/mega_simple.cu``: ``make_cull``, ``group_need``, over
    ``ops/mega_simple.py::sphere_groups``), counting the sphere tests it
    lets through for each ray's own test - not its warp's."""

    def __init__(self, centers, device="cuda"):
        import torch
        from opencl_montecarlo_path_tracing_tpu_torch.ops.mega_simple import (
            sphere_groups)
        recs = sphere_groups(centers)
        self.first = recs[:, 3].view(np.int32).tolist()
        self.count = recs[:, 7].view(np.int32).tolist()
        self.recs = torch.from_numpy(recs).to(device)
        self.c = torch.from_numpy(np.asarray(centers, np.float32)).to(device)
        lo, hi = self.recs[0, 0:3], self.recs[0, 4:7]
        e = hi - lo
        self.mid = 0.5 * (lo + hi)
        self.half = 0.5 * torch.sqrt(e[0] * e[0] + e[1] * e[1]
                                     + e[2] * e[2]) * 1.001

    def _pad(self, o):
        import torch
        q = o - self.mid
        P = torch.sqrt((q * q).sum(-1)) + self.half
        return (torch.sqrt(1.0 + 2e-6 * (P * P + 1.0)) - 1.0) + 0.01 + 1e-5 * P

    def _need(self, g, o, inv, pad, t):
        import torch
        lo = self.recs[g, 0:3] - pad[..., None]
        hi = self.recs[g, 4:7] + pad[..., None]
        t0, t1 = (lo - o) * inv, (hi - o) * inv
        nan = torch.isnan(t0) | torch.isnan(t1)
        tn = torch.where(nan, -np.inf, torch.minimum(t0, t1)).amax(-1)
        tf = torch.where(nan, np.inf, torch.maximum(t0, t1)).amin(-1)
        return (tf >= tn) & (tf >= 0.0) & (tn.clamp_min(0.0) <= t * 1.001)

    def _roots(self, k, o, d):
        import torch
        p = o - self.c[k]
        b = (p * d).sum(-1)
        q = b * b - ((p * p).sum(-1) - 1.0)
        return q > 0.0, -b - torch.sqrt(q.clamp_min(0.0))

    def trace_tests(self, o, d, active) -> int:
        """Sphere tests of the closest-hit traces of the ``active`` rays,
        the running t seeded by the floor."""
        import torch
        eps, big = float(np.float32(0.01)), float(np.float32(1e9))
        inv, pad = 1.0 / d, self._pad(o)
        p = -o[..., 2] * (1.0 / d[..., 2])
        t = torch.where((p > eps) & (p < big), p, big)
        in_card = active & self._need(0, o, inv, pad, t)
        tests = torch.zeros_like(t, dtype=torch.int64)
        for g in range(1, len(self.count)):
            tests += (in_card & self._need(g, o, inv, pad, t)) * self.count[g]
            for k in range(self.first[g], self.first[g] + self.count[g]):
                q, s = self._roots(k, o, d)
                t = torch.where(q & (s < t) & (s > eps), s, t)
        return int(tests.sum())

    def shadow_tests(self, o, d, open_) -> int:
        """Sphere tests of the uncapped any-hit rays that are ``open_``
        after the floor, each up to its first hit."""
        import torch
        eps, big = float(np.float32(0.01)), float(np.float32(1e9))
        inv, pad = 1.0 / d, self._pad(o)
        open_ = open_ & self._need(0, o, inv, pad, big)
        tests = torch.zeros(open_.shape, dtype=torch.int64, device=o.device)
        for g in range(1, len(self.count)):
            still = open_ & self._need(g, o, inv, pad, big)
            for k in range(self.first[g], self.first[g] + self.count[g]):
                tests += still
                q, s = self._roots(k, o, d)
                hit = still & q & (s < big) & (s > eps)
                open_ = open_ & ~hit
                still = still & ~hit
        return int(tests.sum())


def simple_ops(n: dict, rays: int, ns: int, culled: bool = False) -> int:
    """B5's FP32 operations for the counts of :func:`simple_counts`: every
    sphere for a live ray's trace and the shadow tests in index order (the
    yardstick), or with ``culled`` the sphere tests the cull lets through
    (box tests not counted)."""
    ops = rays * CAMERA_OPS
    for b in range(len(n["live"])):
        hits = n["floor"][b] + n["mirror"][b]
        trace = n["cull_trace_tests"][b] if culled else n["live"][b] * ns
        shadow = n["cull_shadow_tests" if culled else "shadow_tests"][b]
        ops += (n["live"][b] * FLOOR_OPS + trace * SPHERE_OPS
                + n["mirror"][b] * (RENORM_OPS + MIRROR_OPS)
                + hits * HIT_OPS + n["floor"][b] * FLOOR_SHADE_OPS
                + n["sky"][b] * SKY_OPS + n["cast"][b] * FLOOR_OPS
                + shadow * SPHERE_OPS)
    return ops


def phase_simple_kernel_vs_plain(gt, card: str) -> dict:
    """B5 on the GPU tests' cases (at 5, 0 and 1 bounces) and on the simple
    main path's full frame, samples 0-1 of 256; the full frame's tie
    pixels localised by bounce, and the ties against the NumPy oracle; the
    kernel and plain times and the bound at that shape."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
        simple_arrays)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_simple as M5
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import SIMPLE
    print("B5 mega_simple vs plain:")
    # what torch.rsqrt runs on a CUDA tensor, against 1/sqrt, near the
    # squared lengths the sphere normals renormalise (the kernel uses rsqrtf)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = 1.0 + (torch.rand(1 << 20, device="cuda", generator=g) - 0.5) * 1e-3
    same = float((torch.rsqrt(x) == 1.0 / torch.sqrt(x)).float().mean())
    print(f"  torch.rsqrt == 1/sqrt on {same * 100:.3f}% of 2^20 inputs "
          "near 1")
    scn = simple_arrays()
    worst, failed = 0.0, []
    for name, seed, (w, h, spp), kw, q in gt.SIMPLE_CASES:
        for bounces in (5, 0, 1):
            a = M5.film_simple_mega((seed, 0), scn, w, h, spp,
                                    quirks=gt.QUIRKS[q], max_bounces=bounces,
                                    device="cuda", **kw)
            b = M5.film_simple_mega_plain((seed, 0), scn, w, h, spp,
                                          quirks=gt.QUIRKS[q],
                                          max_bounces=bounces,
                                          device="cuda", **kw)
            worst = max(worst, check_crn(
                f"{name}, max_bounces {bounces}", a, b, spp, failed,
                atol=gt.SIMPLE_ATOL, contract=SIMPLE))
            bit_equal(f"{name}, max_bounces {bounces}", a, b, failed)
    key = make_key(0)
    frame = dict(spp_total=SSPP)
    a = M5.film_simple_mega(key, scn, SW, SH, 2, device="cuda", **frame)
    b = M5.film_simple_mega_plain(key, scn, SW, SH, 2, device="cuda", **frame)
    worst = max(worst, check_crn(
        f"{SW}x{SH}, samples 0-1 of {SSPP}", a, b, 2, failed,
        atol=gt.SIMPLE_ATOL, contract=SIMPLE))
    bit_equal(f"{SW}x{SH}, samples 0-1 of {SSPP}", a, b, failed)
    if failed:
        raise RuntimeError(f"B5 kernel vs plain contract violated: {failed}")
    # tie localisation: the band of the tie pixels again at max_bounces
    # 1..5; for each tie pixel, the first bounce count at which the two
    # films differ beyond rounding, and at which they differ by a tie
    ties = np.argwhere(display_diff(a, b, 2) > SIMPLE.tie_thresh)
    if len(ties):
        r0, r1 = int(ties[:, 0].min()), int(ties[:, 0].max()) + 1
        diffs = []
        for bounces in range(1, 6):
            band = dict(frame, row_offset=r0, rows=r1 - r0,
                        max_bounces=bounces)
            diffs.append(display_diff(
                M5.film_simple_mega(key, scn, SW, SH, 2, device="cuda",
                                    **band),
                M5.film_simple_mega_plain(key, scn, SW, SH, 2,
                                          device="cuda", **band), 2))
        beyond, tie = first_difference(
            diffs, [(int(r), int(c)) for r, c in ties], r0)
        print(f"  {len(ties)} tie pixels of the frame; first bounce beyond "
              f"rounding: {beyond}; first bounce at a tie: {tie}")
    else:
        print("  no tie pixel in the full frame")
    oracle_ties(scn)
    k_ms = time_ms(lambda: M5.film_simple_mega(key, scn, SW, SH, 2,
                                               device="cuda", **frame), 10)
    k1_ms = time_ms(lambda: M5.film_simple_mega(
        key, scn, SW, SH, 2, max_bounces=1, device="cuda", **frame), 10)
    p_ms = time_ms(lambda: M5.film_simple_mega_plain(
        key, scn, SW, SH, 2, device="cuda", **frame), 2)
    n = simple_counts(key, SW, SH, 2, SSPP)
    ns = int(scn.sphere_centers.shape[0])
    b_ms, b_by = bound(simple_ops(n, SW * SH * 2, ns), SW * SH * 12 + ns * 12)
    r_ms, _ = bound(simple_ops(n, SW * SH * 2, ns, culled=True),
                    SW * SH * 12 + ns * 12)
    rays = SW * SH * 2
    live = ", ".join(f"{v / rays:.4f}" for v in n["live"])
    print(f"  live fraction at bounces 1-5: {live}; shadow rays cast "
          f"{sum(n['cast']) / rays:.4f} a sample, "
          f"{sum(n['shadow_tests']) / max(sum(n['cast']), 1):.1f} sphere "
          "tests each in index order; after the cull, for each ray's own "
          f"test: {sum(n['cull_trace_tests']) / max(sum(n['live']), 1):.2f} "
          f"a trace (of {ns}), "
          f"{sum(n['cull_shadow_tests']) / max(sum(n['cast']), 1):.2f} a "
          "shadow ray")
    print(f"  {SW}x{SH}x2: kernel {k_ms:.3f} ms (at max_bounces 1: "
          f"{k1_ms:.3f} ms, so bounces 2-5 take "
          f"{100 * (k_ms - k1_ms) / k_ms:.1f}%), plain PyTorch {p_ms:.1f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}; restated over the sphere tests "
          f"the cull lets through {r_ms:.4f} ms, {100 * r_ms / k_ms:.1f}% "
          f"of the kernel's time) ({card})")
    return {"max_abs": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def bit_equal(name, a, b, failed):
    """B5 and its plain version run the same float operations in the same
    order, none contracted: their films must be equal bit for bit."""
    import torch
    if not torch.equal(a, b):
        print(f"  {name}: NOT bit-equal")
        failed.append(f"{name} (bit-equal)")


def first_difference(diffs, ties, r0) -> tuple[dict, dict]:
    """Histograms over the ``ties`` pixels (rows from ``r0``) of the first
    bounce count at which a film pair differs beyond rounding (1e-5 on the
    display scale) and by a tie (> 1e-4); ``diffs`` holds the pair's
    :func:`display_diff` at bounce counts 1, 2, ..."""
    import collections
    first = ({}, {})
    for bounces, dd in enumerate(diffs, start=1):
        for r, c in ties:
            for k, lim in enumerate((1e-5, 1e-4)):
                if (r, c) not in first[k] and dd[r - r0, c] > lim:
                    first[k][(r, c)] = bounces
    return tuple(dict(sorted(collections.Counter(
        f.get((int(r), int(c)), "none") for r, c in ties).items(), key=str))
        for f in first)


def oracle_ties(scn):
    """B5 against the NumPy oracle (the reference's CPU tracer, on the same
    threefry streams) on the sphere-field band of the 512-wide frame at 2
    spp: the simple family's tie class against its reference, localised
    by re-rendering both at max_bounces (max_depth) 1..5."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.oracle import (
        render_oracle)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_simple as M5
    import torch
    key, w, r0, rows, spp = make_key(9), 512, 160, 96, 2
    diffs = []
    for bounces in range(1, 6):
        k = M5.film_simple_mega(key, scn, w, r0 + rows, spp, row_offset=r0,
                                rows=rows, max_bounces=bounces, device="cuda")
        o = torch.from_numpy(render_oracle(w, rows, spp=spp, key=key,
                                           max_depth=bounces, row_offset=r0))
        diffs.append(display_diff(k, o, spp))
        d = diffs[-1]
        print(f"  vs NumPy oracle, {w}x{rows} band rows {r0}-{r0 + rows - 1}"
              f" x{spp}, max_bounces {bounces}: p95 "
              f"{float(np.quantile(d, 0.95)):.3e}, "
              f"{(d > 1e-5).mean() * 100:.3f}% > 1e-5, "
              f"{(d > 1e-4).mean() * 100:.3f}% tie, max {float(d.max()):.3e}")
    ties = [(int(r) + r0, int(c)) for r, c in np.argwhere(diffs[-1] > 1e-4)]
    beyond, tie = first_difference(diffs, ties, r0)
    print(f"  {len(ties)} oracle tie pixels at 5 bounces; first bounce beyond "
          f"rounding: {beyond}; first bounce at a tie: {tie}")
    if float(np.quantile(diffs[-1], 0.95)) >= 1e-5:
        raise RuntimeError("B5 vs the NumPy oracle: p95 past 1e-5 "
                           "(tests/test_crn.py's contract)")


def timed_renders(fn):
    """(last output, ms per call, launch counts) of TIMED_RUNS calls of
    ``fn`` after a warm-up, counts set to 0 just before them."""
    import torch
    fn()
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_RUNS):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    return out, start.elapsed_time(end) / TIMED_RUNS, counts


def only(counts: dict, name: str) -> bool:
    """Whether ``name`` launched once a render and no other kernel did."""
    return counts[name] == TIMED_RUNS and not any(
        v for k, v in counts.items() if k != name)


def phase_simple_main_path(card: str) -> dict:
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.ops.reduce import (
        quantize_film)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import (
        ImgInfo, load_pam, save_pam)
    film, ms, counts = timed_renders(lambda: pt.render(
        "simple", None, SW, SH, spp=SSPP, seed=0, device="cuda"))
    if not only(counts, "mega_simple"):
        raise RuntimeError(f"simple main path: launches {counts} in "
                           f"{TIMED_RUNS} renders (want B5 once each)")
    f = film.cpu().numpy()
    mean = float(f.mean()) / SSPP
    if f.shape != (SH, SW, 3) or not np.isfinite(f).all() \
            or not 0.0 < mean < 50.0:
        raise RuntimeError(f"bad simple film: shape {f.shape}, mean/spp "
                           f"{mean}")
    mpaths = SW * SH * SSPP / (ms / 1e3) / 1e6
    print(f"main path: simple {SW}x{SH}x{SSPP}: {ms:.2f} ms/render, "
          f"{mpaths:.1f} Mpaths/s ({card}); film mean/spp {mean:.4f}, "
          f"launches {counts}")
    rgba = quantize_film(film).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.ppm")
        save_pam(out, ImgInfo(width=SW, height=SH, channels=4, data=rgba))
        if not np.array_equal(load_pam(out).data, rgba):
            raise RuntimeError("simple result.ppm does not read back")
    return {"launches": counts["mega_simple"], "render_ms": ms,
            "mpaths": mpaths}


def phase_nodof_main_path(card: str) -> dict:
    """nodof through B1 (once a render), held against the tier-1 sample
    buffer of the same render, reduced on the card."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.sample_parallel \
        import render_sample_parallel
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    scene, tag = demo_scene()
    spp = NSG * NSG
    img, ms, counts = timed_renders(lambda: pt.render(
        "nodof", scene, NW, NH, spp=spp, seed=0, device="cuda"))
    if not only(counts, "mega_super"):
        raise RuntimeError(f"nodof main path: launches {counts} in "
                           f"{TIMED_RUNS} renders (want B1 once each)")
    mpaths = NW * NH * spp / (ms / 1e3) / 1e6
    torch.cuda.reset_peak_memory_stats()
    (ref, buf), buf_ms = timed_call(lambda: render_sample_parallel(
        make_key(0), scene, NW, NH, NSG, return_samples=True,
        device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if img.shape != (NH, NW, 4) or img.dtype != np.uint8 \
            or tuple(buf.shape) != (NH * NSG, NW * NSG, 3) \
            or not bool(torch.isfinite(buf).all()):
        raise RuntimeError(f"nodof: bad image {img.shape} or buffer "
                           f"{tuple(buf.shape)}")
    d = np.abs(img.astype(np.int32) - ref.cpu().numpy().astype(np.int32))
    exact = float((d == 0).mean())
    ok = int(d.max()) <= 1 and exact >= 0.99
    print(f"main path: nodof {NW}x{NH}x{spp} on {tag}: {ms:.2f} ms/render, "
          f"{mpaths:.1f} Mpaths/s ({card}); launches {counts}")
    print(f"  vs the tier-1 sample buffer ({NH * NSG}x{NW * NSG} rays, "
          f"{buf_ms:.1f} ms, peak {peak:.1f} GiB): max step {int(d.max())},"
          f" {exact * 100:.3f}% exact {'ok' if ok else 'VIOLATION'}")
    if not ok:
        raise RuntimeError("nodof B1 image vs sample-buffer image differ")
    return {"launches": counts["mega_super"], "render_ms": ms,
            "mpaths": mpaths}


def sm_clock_hz(query: str = "clocks.max.sm") -> float:
    """The SM clock nvidia-smi reads: its maximum, or ``clocks.sm`` now."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0]) * 1e6


def latency_bound(chain_ops: float) -> tuple[float, str]:
    """(bound_ms, "latency") of a dependent chain of FP32 operations."""
    return chain_ops * FP32_CHAIN_CYCLES / sm_clock_hz() * 1e3, "latency"


def max_abs(a, b) -> float:
    import torch
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def loop_chain_ops(arm: str, n1: int, n2: int) -> int:
    """FP32 operations in the dependent chain of one B8-loops call."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L
    steps = L.STEPS.get(arm)
    if steps:
        return 2 * steps * n1 * max(1, n2)
    return LOOP_CHAIN_OPS[arm] * n1


def phase_diag_loops(card: str) -> dict:
    """B8-loops: each of the 13 arms against its plain version at 1/100 of
    the JAX tool's trip counts (a random start and table; bit-equal), both
    timed there (the kernels line's row), then the tool's run at its own
    counts (ns an iteration), counts set to 0 just before it."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_loops as TL)
    print("B8 diag_loops vs plain:")
    rng = np.random.RandomState(7)
    x, acc0 = (torch.from_numpy(rng.rand(8, 128).astype(np.float32))
               .cuda() for _ in range(2))
    table = torch.from_numpy(rng.rand(*L.TABLE_SHAPE).astype(np.float32)
                             ).cuda()
    worst, failed, k_ms, p_ms, chain = 0.0, [], 0.0, 0.0, 0
    for arm in L.ARMS:
        n1, n2 = TL.COUNTS[arm]
        n1 = max(1, n1 // 100)
        k = L.run(arm, x, n1, n2, acc0, table)
        k_ms += time_ms(lambda: L.run(arm, x, n1, n2, acc0, table), 5)
        p, ms = timed_call(lambda: L.run_plain(arm, x, n1, n2, acc0, table))
        p_ms += ms
        chain += loop_chain_ops(arm, n1, n2)
        worst = max(worst, max_abs(k, p))
        if not torch.equal(k, p):
            failed.append(arm)
    b_ms, b_by = latency_bound(chain)
    print(f"  13 arms at 1/100 of the tool's counts: kernel {k_ms:.4f} ms, "
          f"plain PyTorch {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{chain} chained FP32 operations x {FP32_CHAIN_CYCLES} cycles at "
          f"{sm_clock_hz() / 1e6:.0f} MHz); max abs {worst:.3e}, "
          f"{'bit-equal' if not failed else f'DIFFER: {failed}'} ({card})")
    if failed:
        raise RuntimeError(f"B8-loops kernel vs plain differ: {failed}")
    print("  the tool's run (best of 5, ns an iteration):")
    reset_counts()
    res = TL.run_arms("cuda")
    counts = read_counts()
    now = sm_clock_hz("clocks.sm")
    print(f"  SM clock just after the run: {now / 1e6:.0f} MHz (max "
          f"{sm_clock_hz() / 1e6:.0f})")
    if counts["diag_loops"] != 13 * (1 + TL.REPEATS) or any(
            v for k, v in counts.items() if k != "diag_loops"):
        raise RuntimeError(f"diag_loops run: launches {counts}")
    # the four arms that run the same 25,600-step chain from zero agree
    same = [res[a][0] for a in ("flat1", "chunk32", "chunk128", "nested")]
    if not all(torch.equal(same[0], o) for o in same[1:]) or not all(
            bool(torch.isfinite(o).all()) for o, _, _ in res.values()):
        raise RuntimeError("B8-loops at the tool's counts: the 25,600-step "
                           "chains disagree or an output is not finite")
    f_ms = sum(ms for _, ms, _ in res.values())
    f_bound, _ = latency_bound(sum(loop_chain_ops(a, *TL.COUNTS[a])
                                   for a in L.ARMS))
    print(f"  13 arms at the tool's counts: kernel {f_ms:.3f} ms in all, "
          f"bound {f_bound:.4f} ms (latency); the 25,600-step chains agree "
          f"bit for bit ({card})")
    return {"launches": counts["diag_loops"], "max_abs": worst, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_diag_primitives(card: str) -> dict:
    """B8-prim: the tool's run at NB = 128, REPS = 200 (counts set to 0
    just before), each arm then held against its plain version on the same
    inputs: bit-equal, the take-list's count the 64 flagged blocks."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_takelist as P)
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_primitives as TP)
    print("B8 diag_takelist (the take-list primitives):")
    reset_counts()
    res = TP.run_arms("cuda", P.NB, P.REPS)
    counts = read_counts()
    if counts["diag_takelist"] != 4 * (1 + TP.REPEATS) or any(
            v for k, v in counts.items() if k != "diag_takelist"):
        raise RuntimeError(f"diag_primitives run: launches {counts}")
    x, flags = TP.inputs("cuda")
    worst, p_ms = 0.0, 0.0
    for arm in P.ARMS:
        (out, cnt), ms = timed_call(lambda: P.run_plain(arm, x, P.NB, P.REPS,
                                                        flags))
        p_ms += ms
        worst = max(worst, max_abs(out, res[arm][0]))
        want = 64 if arm == "takelist" else 0
        if not torch.equal(out, res[arm][0]) \
                or res[arm][1] != int(cnt[0]) or res[arm][1] != want:
            raise RuntimeError(f"B8-prim {arm}: kernel vs plain differ (count "
                               f"{res[arm][1]}, plain {int(cnt[0])}, want "
                               f"{want})")
    k_ms = sum(ms for _, _, ms in res.values())
    # chained adds: every block for noop, the 64 flagged ones otherwise
    b_ms, b_by = latency_bound(P.REPS * (P.NB + 3 * 64))
    print(f"  4 arms: kernel {k_ms:.3f} ms, plain PyTorch {p_ms:.1f} ms "
          f"(bit-equal; take-list count 64 of {P.NB}), bound {b_ms:.4f} ms "
          f"({b_by}) ({card})")
    return {"launches": counts["diag_takelist"], "max_abs": worst,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


def listed_pairs(arm) -> tuple[int, int]:
    """((ray, triangle) pairs, distinct rows) of one closest call: every
    ray of a tile against every row its list names."""
    import torch
    llen, ids = arm.lists.llen.long(), arm.lists.ids.long()
    k = torch.arange(ids.shape[1], device=ids.device)[None]
    live = k < llen[:, None]
    rows = torch.where(live, arm.table.count.long()[ids], 0)
    used = torch.unique(ids[live])
    return (int(rows.sum()) * 2048, int(arm.table.count.long()[used].sum()))


def occ_pairs_needed(arm) -> int:
    """(ray, triangle) pairs an occlusion call needs: each ray's rows in
    walk order up to its first occluder, or all of them."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K
    o, d, tl = arm.rays
    h, w = tl.shape
    ot, dt, tlt = K._rays_in_tiles(o, d, tl, w, h)
    first = torch.zeros(tlt.shape, dtype=torch.int64, device=tl.device)
    for c, (ok, dd, tn_s, _) in enumerate(K._chunks(arm.lists, arm.table,
                                                   ot, dt)):
        hit = ok & (tn_s < tlt[..., None] * dd)
        pos = hit.to(torch.int8).argmax(-1) + c * K._CHUNK + 1
        first = torch.where((first == 0) & hit.any(-1), pos, first)
    llen, ids = arm.lists.llen.long(), arm.lists.ids.long()
    k = torch.arange(ids.shape[1], device=ids.device)[None]
    rows = torch.where(k < llen[:, None], arm.table.count.long()[ids],
                       0).sum(-1)                       # a tile's rows
    return int(torch.where(first > 0, first, rows[:, None]).sum())


def phase_diag_dda(card: str) -> tuple[dict, dict]:
    """B8-dda-closest and B8-dda-occ: the tool's run at 512x512 on the demo
    scene and the 5k and 20k sheets (counts set to 0 just before), then
    every kernel call of it held against its plain version on the same
    inputs (bit-equal maps), cell vs Morton vs dense t maps and cell vs
    Morton occlusion maps bit-equal, and the tables of times."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K
    from opencl_montecarlo_path_tracing_tpu_torch.tools import diag_dda as TD
    print("B8 diag_dda (the grid cell-walk diagnostic):")
    reset_counts()
    runs = [TD.run_scene(tag, DIAG_SIZE, "cuda") for tag in DIAG_SCENES]
    counts = read_counts()
    n_closest = sum(len(r["closest"]) for r in runs) * (1 + TD.REPEATS)
    n_occ = sum(len(a) for r in runs for a in r["shadow"].values()) * (
        1 + TD.REPEATS)
    if (counts["diag_dda_closest"], counts["diag_dda_occ"]) != (
            n_closest, n_occ) or any(
            v for k, v in counts.items()
            if k not in ("diag_dda_closest", "diag_dda_occ")):
        raise RuntimeError(f"diag_dda run: launches {counts}, want "
                           f"{n_closest} closest and {n_occ} occlusion")
    worst_c = worst_o = 0.0
    failed = []
    for r in runs:
        tag = r["tag"]
        t_c = r["closest"]["cell"].out[0]
        for name, arm in r["closest"].items():
            t, m = K.closest_plain(arm.lists, arm.table, DIAG_SIZE,
                                   DIAG_SIZE)
            worst_c = max(worst_c, max_abs(arm.out[0], t))
            if not (torch.equal(arm.out[0], t) and torch.equal(arm.out[1], m)):
                failed.append(f"{tag} {name} closest: kernel vs plain")
            if not torch.equal(arm.out[0], t_c):
                failed.append(f"{tag} {name} vs cell t map")
        for name, arms in r["shadow"].items():
            for li, arm in enumerate(arms):
                occ = K.occluded_plain(arm.lists, arm.table, *arm.rays)
                worst_o = max(worst_o, max_abs(arm.out, occ))
                if not torch.equal(arm.out, occ):
                    failed.append(f"{tag} {name} L{li} occ: kernel vs plain")
                if not torch.equal(arm.out, r["shadow"]["cell"][li].out):
                    failed.append(f"{tag} {name} L{li} vs cell occ map")
    print(f"  every call vs plain: t max abs {worst_c:.3e}, occlusion max abs "
          f"{worst_o:.3e}; cell == Morton == dense t maps, cell == Morton "
          f"occlusion maps: {'yes' if not failed else failed}")
    if failed:
        raise RuntimeError(f"B8-dda: {failed}")
    print(f"  {DIAG_SIZE}x{DIAG_SIZE}, best of {TD.REPEATS} warm calls, ms "
          f"({card}):")
    print("  | scene | structure | closest | shadow (2 lights) | total | "
          "lists mean | host lists s |")
    for r in runs:
        hs = r["host_s"]
        for name, arm in r["closest"].items():
            sh = r["shadow"].get(name)
            sh_ms = sum(a.ms for a in sh) if sh else None
            tot = arm.ms + (sh_ms or 0.0)
            lists_s = {"cell": hs["cell_lists"], "morton": hs["morton_lists"]
                       }.get(name)
            print(f"  | {r['tag']} | {name} | {arm.ms:.3f} | "
                  f"{'-' if sh_ms is None else f'{sh_ms:.3f}'} | "
                  f"{tot:.3f} | {float(arm.lists.llen.float().mean()):.1f} | "
                  f"{'-' if lists_s is None else f'{lists_s:.2f}'} |")
        print(f"  {r['tag']}: cell/Morton closest+shadow "
              f"{r['totals']['morton'] / r['totals']['cell']:.2f}x, per-lane "
              f"DDA (plain) {r['dda_ms']:.1f} ms, host: tables "
              f"{hs['cells'] + hs['morton']:.2f} s, shadow lists "
              f"{hs['shadow_lists']:.2f} s")
    # the rows of the kernels line: the 20k sheet's cell-list calls
    r = runs[-1]
    c_arm, o_arm = r["closest"]["cell"], r["shadow"]["cell"][0]
    _, pc_ms = timed_call(lambda: K.closest_plain(
        c_arm.lists, c_arm.table, DIAG_SIZE, DIAG_SIZE))
    _, po_ms = timed_call(lambda: K.occluded_plain(o_arm.lists, o_arm.table,
                                                   *o_arm.rays))
    npix = DIAG_SIZE * DIAG_SIZE
    pairs, rows = listed_pairs(c_arm)
    bc_ms, bc_by = bound(pairs * PAIR_OPS + npix * CAMERA_OPS,
                         rows * 64 + c_arm.lists.ids.numel() * 4 + npix * 8)
    o_pairs = occ_pairs_needed(o_arm)
    _, o_rows = listed_pairs(o_arm)
    bo_ms, bo_by = bound(o_pairs * PAIR_OPS,
                         o_rows * 64 + o_arm.lists.ids.numel() * 4 + npix * 32)
    print(f"  {r['tag']} cell closest: kernel {c_arm.ms:.3f} ms, plain "
          f"PyTorch {pc_ms:.1f} ms, bound {bc_ms:.4f} ms ({bc_by}; {pairs} listed "
          f"pairs); cell shadow L0: kernel {o_arm.ms:.3f} ms, plain PyTorch "
          f"{po_ms:.1f} ms, bound {bo_ms:.4f} ms ({bo_by}; {o_pairs} needed "
          f"pairs) ({card})")
    closest = {"launches": counts["diag_dda_closest"], "max_abs": worst_c,
               "ms": c_arm.ms, "plain_ms": pc_ms, "bound_ms": bc_ms,
               "bound_by": bc_by}
    occ = {"launches": counts["diag_dda_occ"], "max_abs": worst_o,
           "ms": o_arm.ms, "plain_ms": po_ms, "bound_ms": bo_ms,
           "bound_by": bo_by}
    return closest, occ


def phase_cli():
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene, procedural_super_scene, write_scene_files)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import load_pam
    runs = [["super", "256", "256"],
            ["bidirectional", "256", "256", "512"],
            ["metropolis_vlpgrid", "256", "256", "512", "8", "3.0"],
            ["trianglegrid", "256", "256", "3.0"],
            ["nodof", "256", "256"],
            ["simple", "64", "64", "16", "--spp", "2"],
            ["simplecpu", "64", "64", "--spp", "2"]]
    with tempfile.TemporaryDirectory() as tmp:
        demo_dir = os.path.join(tmp, "demo")
        mesh_dir = os.path.join(tmp, "large_mesh")
        write_scene_files(procedural_super_scene(), demo_dir)
        write_scene_files(large_mesh_scene(), mesh_dir)
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        for args in runs:
            out = os.path.join(tmp, f"{args[0]}.ppm")
            scene_dir = mesh_dir if args[0] == "trianglegrid" else demo_dir
            spp = [] if "--spp" in args else ["--spp", "4"]
            r = subprocess.run(
                [sys.executable, "-m", PKG, *args, *spp, "--seed", "1",
                 "--scene-dir", scene_dir, "--out", out], cwd=tmp,
                env=env, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"CLI {args} exited {r.returncode}:\n"
                                   f"{r.stdout}\n{r.stderr}")
            img = load_pam(out)
            size = int(args[1])
            if (img.width, img.height, img.channels) != (size, size, 4):
                raise RuntimeError(f"CLI {args[0]} wrote {img.width}x"
                                   f"{img.height}x{img.channels}")
            stage = [ln for ln in r.stdout.splitlines()
                     if " in " in ln and "GB/s" in ln]
            print(f"cli {args[0]}: ok ({stage[0] if stage else ''})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    card = card_line()
    t0 = time.perf_counter()

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[{fn.__name__}: {time.perf_counter() - t:.1f} s]")
        return out

    phase(phase_card_and_build, card)
    gt = gpu_tests()
    b1_err = phase(phase_super_kernel_vs_plain, gt)
    tables = vlp_bench_tables()
    b4 = phase(phase_vlp_kernel_vs_plain, gt, tables)
    b6 = phase(phase_gather_kernel_vs_plain)
    mp = phase(phase_super_main_path, card)
    vp = phase(phase_vlp_main_paths, card)
    b6_launches = phase(phase_tier1_route, card)
    b23 = phase(phase_blocked_kernel_vs_plain, gt, card)
    b7 = phase(phase_tri_closest_vs_plain, card)
    lp = phase(phase_large_mesh_main_paths, card)
    b5 = phase(phase_simple_kernel_vs_plain, gt, card)
    sp = phase(phase_simple_main_path, card)
    npth = phase(phase_nodof_main_path, card)
    b8_loops = phase(phase_diag_loops, card)
    b8_prim = phase(phase_diag_primitives, card)
    b8_closest, b8_occ = phase(phase_diag_dda, card)
    phase(phase_cli)
    print(f"smoke: {time.perf_counter() - t0:.1f} s")
    src = f"{PKG}/csrc"
    ref = "opencl_montecarlo_path_tracing_tpu/ops"

    def row(name, source, replaces, launches, k):
        """``replaces``: the TPU kernel's file (from the repository root)
        and line."""
        return {"name": name, "route": "cuda", "source": f"{src}/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["max_abs"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}

    kernels = [
        row("mega_super", "mega_super.cu", f"{ref}/pallas_super.py:2228",
            mp["launches"] + npth["launches"], dict(mp, max_abs=b1_err)),
        row("mega_vlp", "mega_vlp.cu", f"{ref}/pallas_bpt.py:434",
            vp["launches"], b4),
        row("gather_vlp", "gather_vlp.cu", f"{ref}/pallas_vlp.py:111",
            b6_launches + lp["gather_vlp"], b6),
        row("mega_blocked", "mega_blocked.cu", f"{ref}/pallas_super.py:2228",
            lp["mega_blocked"], b23),
        row("tri_closest", "tri_closest.cu", f"{ref}/pallas_tri.py:89",
            lp["tri_closest"], b7),
        row("mega_simple", "mega_simple.cu", f"{ref}/pallas_simple.py:352",
            sp["launches"], b5),
        row("diag_dda_closest", "diag_dda.cu", "tools/diag_dda_pallas.py:163",
            b8_closest["launches"], b8_closest),
        row("diag_dda_occ", "diag_dda.cu", "tools/diag_dda_pallas.py:198",
            b8_occ["launches"], b8_occ),
        row("diag_takelist", "diag_takelist.cu",
            "tools/diag_primitives.py:145", b8_prim["launches"], b8_prim),
        row("diag_loops", "diag_loops.cu",
            "tools/diag_loops.py:47, :70, :85, :103, :119, :136",
            b8_loops["launches"], b8_loops),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
