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
   demo scene's emitted 1024-row table, the dense-VLP scene's (~100% live)
   and the 4096-row Metropolis table, dense and grid;
4. B6 (``gather_vlp``) vs its plain version on 512x512 random shading points
   against 64, 1024 and 4096 VLPs (rtol = atol = 1e-5);
5. the super main path: ``api.render("super")`` on ``demo_scene()`` at
   1024x1024 with 1024 spp; the film is checked, quantised and written as a
   PAM file, and Mpaths/s is timed with CUDA events over 3 runs;
6. the VLP main paths: ``api.render`` at 512x512 with 256 spp -
   bidirectional, metropolis and metropolis_vlpgrid on ``demo_scene()``,
   bidirectional on ``dense_vlp_scene()`` - each timed over 3 runs, its
   light pass and render pass timed apart, and the Metropolis chain's
   device-busy share read from a profile;
7. the tier-1 VLP route: bidirectional under the REFERENCE_LMEM quirks
   (outside B4's gate) at 256x256x4 runs the plain wavefront on the card,
   whose gather is B6; its film is held to the contract against the same
   render with the plain scan gather;
8. CLI: ``super``, ``bidirectional`` and ``metropolis_vlpgrid`` at 256x256
   with 4 spp on a scene written to text files; each must exit 0 and write
   a valid PAM.

Every path phase (5, 6, 7) sets all launch counts to 0 just before it and
reads them just after; the counts in the ``kernels`` line come from those
runs.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the line before it is the card's name and power limit, the line
before that each kernel's launches, error and times.  The script imports no
JAX.  It exits non-zero, printing no result, without a GPU or without the
package beside it.
"""

from __future__ import annotations

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


def reset_counts():
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        gather_vlp, mega_super, mega_vlp)
    mega_super.LAUNCHES = mega_vlp.LAUNCHES = gather_vlp.LAUNCHES = 0


def read_counts() -> dict:
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        gather_vlp, mega_super, mega_vlp)
    return {"mega_super": mega_super.LAUNCHES, "mega_vlp": mega_vlp.LAUNCHES,
            "gather_vlp": gather_vlp.LAUNCHES}


def gpu_tests():
    """tests/test_torch_gpu.py, loaded by path (an installed package may
    also be named "tests"); it imports no JAX."""
    spec = importlib.util.spec_from_file_location(
        "_torch_gpu_cases", os.path.join(ROOT, "tests", "test_torch_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_crn(name, a, b, spp, failed) -> float:
    """Print the contract's statistics of two films; returns the max abs
    film difference and records a violation in ``failed``."""
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
    a = a.cpu().numpy()
    b = b.cpu().numpy()
    if a.shape != b.shape or not np.isfinite(a).all():
        raise RuntimeError(f"{name}: bad kernel film {a.shape}")
    ok, st = crn_ok(a, b, spp)
    print(f"  {name}: max {st['max']:.3e} p99.5 {st['q']:.3e} "
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
    print(f"  {tables[0][0]}, {VW}x{VH}x2: kernel {k_ms:.3f} ms, plain "
          f"PyTorch {p_ms:.1f} ms")
    return {"max_abs": worst, "ms": k_ms, "plain_ms": p_ms}


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
    return {"max_abs": worst_abs, "max_rel": worst_rel, "ms": times[4096][0],
            "plain_ms": times[4096][1]}


def phase_super_main_path(card: str) -> dict:
    import torch
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

    def main_path():
        return pt.render("super", scene, W, H, spp=SPP, seed=0,
                         device="cuda")

    main_path()                       # warm-up (first launch, allocator)
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_RUNS):
        film = main_path()
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    ms = start.elapsed_time(end) / TIMED_RUNS
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
    return {"launches": counts["mega_super"], "ms": times[(W, H, 4)][0],
            "plain_ms": times[(W, H, 4)][1], "render_ms": ms,
            "mpaths": mpaths}


def chain_profile(key, scn) -> str:
    """One warm Metropolis chain (512 chains per light x 8 rounds) under
    torch.profiler: host wall time, device kernel time, kernel count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mlt_vlps(key, scn, 512, 8, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not kernels:
        return (f"chain: {wall_ms:.1f} ms wall; device time not measured "
                "(the profiler recorded no kernel)")
    return (f"chain: {wall_ms:.1f} ms wall, {len(kernels)} kernels, "
            f"{dev_ms:.1f} ms device-busy ({100 * dev_ms / wall_ms:.2f}%), "
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
        def main_path():
            return pt.render(variant, scene, VW, VH, spp=VSPP, seed=0,
                             device="cuda")

        main_path()
        torch.cuda.synchronize()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_RUNS):
            film = main_path()
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        ms = start.elapsed_time(end) / TIMED_RUNS
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
        if variant == "metropolis":
            print("  " + chain_profile(key, scn))
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


def phase_cli():
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        procedural_super_scene, write_scene_files)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import load_pam
    runs = [["super", "256", "256"],
            ["bidirectional", "256", "256", "512"],
            ["metropolis_vlpgrid", "256", "256", "512", "8", "3.0"]]
    with tempfile.TemporaryDirectory() as tmp:
        write_scene_files(procedural_super_scene(), tmp)
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        for args in runs:
            out = os.path.join(tmp, f"{args[0]}.ppm")
            r = subprocess.run(
                [sys.executable, "-m", PKG, *args, "--spp", "4", "--seed",
                 "1", "--scene-dir", tmp, "--out", out], cwd=tmp, env=env,
                capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"CLI {args} exited {r.returncode}:\n"
                                   f"{r.stdout}\n{r.stderr}")
            img = load_pam(out)
            if (img.width, img.height, img.channels) != (256, 256, 4):
                raise RuntimeError(f"CLI {args[0]} wrote {img.width}x"
                                   f"{img.height}x{img.channels}")
            stage = [ln for ln in r.stdout.splitlines()
                     if "pixels in" in ln]
            print(f"cli {args[0]}: ok ({stage[0] if stage else ''})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    card = card_line()
    t0 = time.perf_counter()
    phase_card_and_build(card)
    gt = gpu_tests()
    b1_err = phase_super_kernel_vs_plain(gt)
    tables = vlp_bench_tables()
    b4 = phase_vlp_kernel_vs_plain(gt, tables)
    b6 = phase_gather_kernel_vs_plain()
    mp = phase_super_main_path(card)
    vp = phase_vlp_main_paths(card)
    b6_launches = phase_tier1_route(card)
    phase_cli()
    print(f"smoke: {time.perf_counter() - t0:.1f} s")
    src = f"{PKG}/csrc"
    ref = "opencl_montecarlo_path_tracing_tpu/ops"
    kernels = [
        {"name": "mega_super", "route": "cuda",
         "source": f"{src}/mega_super.cu",
         "replaces": f"{ref}/pallas_super.py:2228",
         "launches": mp["launches"], "max_abs_err": b1_err,
         "ms": mp["ms"], "plain_ms": mp["plain_ms"]},
        {"name": "mega_vlp", "route": "cuda",
         "source": f"{src}/mega_vlp.cu",
         "replaces": f"{ref}/pallas_bpt.py:434",
         "launches": vp["launches"], "max_abs_err": b4["max_abs"],
         "ms": b4["ms"], "plain_ms": b4["plain_ms"]},
        {"name": "gather_vlp", "route": "cuda",
         "source": f"{src}/gather_vlp.cu",
         "replaces": f"{ref}/pallas_vlp.py:111",
         "launches": b6_launches, "max_abs_err": b6["max_abs"],
         "ms": b6["ms"], "plain_ms": b6["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
