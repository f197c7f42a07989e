"""GPU smoke test of the PyTorch / CUDA port's main path (the `super` render).

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and skipped):

1. card and build: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the CUDA kernels built with nvcc from ``csrc/``;
2. kernel vs plain: the CUDA kernel against its plain PyTorch version on the
   same inputs, on the card, held to the common-random-number contract of
   ``tools/validate_crn_frame.py`` (per-pixel difference on the display
   scale: p99.5 < 1e-5 and a razor-edge tie fraction (> 1e-4) < 0.6%);
3. main path: ``api.render("super")`` on ``demo_scene()`` at 1024x1024 with
   1024 spp, with the kernel's launch count reset just before and read just
   after; the film is checked, quantised and written as a PAM file, and
   Mpaths/s is timed with CUDA events over 3 runs;
4. CLI: ``python -m opencl_montecarlo_path_tracing_tpu_torch super`` on a
   scene written to text files, which must exit 0 and write a valid PAM.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it carries each kernel's launches, error and times.  The script
imports no JAX.  It exits non-zero, printing no result, without a GPU or
without the package beside it.
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

W = H = 1024          # the main path: bench.py's headline super row
SPP = 1024
TIMED_RUNS = 3
Q, Q_LIMIT, TIE_THRESH, TIE_LIMIT = 0.995, 1e-5, 1e-4, 0.006


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def crn_stats(a: np.ndarray, b: np.ndarray, spp: int) -> dict:
    """tools/validate_crn_frame.py::stats on two films of ``spp`` samples."""
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        / spp * 64.0 / 255.0
    dm = np.abs(d).max(axis=-1)
    return {"q": float(np.quantile(dm, Q)), "max": float(dm.max()),
            "tie_frac": float((dm > TIE_THRESH).mean()),
            "max_abs": float(np.abs(np.asarray(a) - np.asarray(b)).max())}


def time_ms(fn, runs: int) -> float:
    """Mean ms per call of ``fn`` over ``runs`` calls, CUDA events, warm."""
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
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernel_vs_plain() -> float:
    """The GPU tests' cases plus the demo scene and the main path's film
    shape; returns the largest abs film error."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    # the cases of tests/test_megakernel.py:37-135, as the GPU tests run
    # them; loaded by path (an installed package may also be named "tests")
    spec = importlib.util.spec_from_file_location(
        "_torch_gpu_cases", os.path.join(ROOT, "tests", "test_torch_gpu.py"))
    gpu_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gpu_tests)
    cases = [(name, prep_scene(make_scene()), seed, shape, kw,
              gpu_tests.QUIRKS[q])
             for name, make_scene, seed, shape, kw, q in gpu_tests.CASES]
    demo = prep_scene(demo_scene()[0])
    cases += [
        ("demo scene 256x256x4", demo, 0, (256, 256, 4), {}, DEFAULT),
        ("demo scene 1024x1024, samples 0-1 of 1024", demo, 0,
         (W, H, 2), dict(spp_total=SPP), DEFAULT),
    ]
    worst = 0.0
    failed = []
    for name, scn, seed, (w, h, spp), kw, quirks in cases:
        key = make_key(seed)
        a = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", **kw).cpu().numpy()
        b = M.film_super_mega_plain(key, scn, w, h, spp, quirks=quirks,
                                    device="cuda", **kw).cpu().numpy()
        rows = kw.get("rows", h)
        if a.shape != (rows, w, 3) or not np.isfinite(a).all():
            raise RuntimeError(f"{name}: bad kernel film {a.shape}")
        st = crn_stats(a, b, spp)
        ok = st["q"] < Q_LIMIT and st["tie_frac"] < TIE_LIMIT
        worst = max(worst, st["max_abs"])
        print(f"  {name}: max {st['max']:.3e} p99.5 {st['q']:.3e} "
              f"ties {st['tie_frac'] * 100:.3f}% max_abs_film "
              f"{st['max_abs']:.3e} {'ok' if ok else 'VIOLATION'}")
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"kernel vs plain contract violated: {failed}")
    return worst


def phase_main_path(card: str) -> dict:
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
    M.LAUNCHES = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_RUNS):
        film = main_path()
    end.record()
    torch.cuda.synchronize()
    launches = M.LAUNCHES
    ms = start.elapsed_time(end) / TIMED_RUNS
    if launches < TIMED_RUNS:
        raise RuntimeError(f"main path launched the kernel {launches} times "
                           f"in {TIMED_RUNS} renders")
    f = film.cpu().numpy()
    mean = float(f.mean()) / SPP
    if f.shape != (H, W, 3) or not np.isfinite(f).all() \
            or not 0.5 < mean < 2.0:
        raise RuntimeError(f"bad main-path film: shape {f.shape}, "
                           f"mean/spp {mean}")
    mpaths = W * H * SPP / (ms / 1e3) / 1e6
    print(f"main path: super {W}x{H}x{SPP} on {tag}: {ms:.1f} ms/render, "
          f"{mpaths:.1f} Mpaths/s ({card}); film mean/spp {mean:.4f}, "
          f"{launches} launches in {TIMED_RUNS} renders")

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
    return {"launches": launches, "ms": times[(W, H, 4)][0],
            "plain_ms": times[(W, H, 4)][1], "render_ms": ms,
            "mpaths": mpaths}


def phase_cli():
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        procedural_super_scene, write_scene_files)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import load_pam
    with tempfile.TemporaryDirectory() as tmp:
        write_scene_files(procedural_super_scene(), tmp)
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run(
            [sys.executable, "-m", "opencl_montecarlo_path_tracing_tpu_torch",
             "super", "256", "256", "--spp", "4", "--seed", "1",
             "--scene-dir", tmp], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"CLI exited {r.returncode}:\n{r.stdout}\n"
                               f"{r.stderr}")
        img = load_pam(os.path.join(tmp, "result.ppm"))
        if (img.width, img.height, img.channels) != (256, 256, 4):
            raise RuntimeError(f"CLI wrote {img.width}x{img.height}x"
                               f"{img.channels}")
        render_line = [ln for ln in r.stdout.splitlines()
                       if ln.startswith("rendering")]
        print(f"cli: ok ({render_line[0] if render_line else ''})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    card = card_line()
    t0 = time.perf_counter()
    phase_card_and_build(card)
    max_abs = phase_kernel_vs_plain()
    mp = phase_main_path(card)
    phase_cli()
    print(f"smoke: {time.perf_counter() - t0:.1f} s")
    kernels = [{
        "name": "mega_super",
        "route": "cuda",
        "source": "opencl_montecarlo_path_tracing_tpu_torch/csrc/mega_super.cu",
        "replaces": "opencl_montecarlo_path_tracing_tpu/ops/pallas_super.py:1533",
        "launches": mp["launches"],
        "max_abs_err": max_abs,
        "ms": mp["ms"],
        "plain_ms": mp["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
