"""Kernels B1-B7, the B8 diagnostics and the light pass's L1 / L2 on the
card: each CUDA kernel == its plain PyTorch version, and each route
launches the kernels it names.

These tests need a CUDA GPU (the kernels have no CPU mode); without one
they skip with a reason.  The file imports neither JAX nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

The B1 cases are those of ``tests/test_megakernel.py:37-135`` (shared with
``tests/test_torch_mega_super.py``), the B4 cases those of
``tests/test_megakernel.py:705-894`` (shared with
``tests/test_torch_mega_vlp.py``), the B5 cases those of
``tests/test_megakernel.py:590-634`` (shared with
``tests/test_torch_simple.py``); those files hold the plain versions
against the JAX megakernels on the CPU.  Tolerances: for the films, the
per-family contract of ``tools/validate_crn_frame.py`` (utils/crn.py:
display-scale p99.5 < 1e-5 and razor-edge ties (> 1e-4) on < 0.6% of
pixels; for the simple family, whose mirror chain amplifies rounding, p95
< 1e-5 and ties on < 2%, plus atol 2e-5 where no pixel ties), since any
two float implementations may flip a razor-edge tie;
for B6, rtol = atol = 1e-5 (the same FP32 formula, no FMA, summed in the
same order on both sides; the kernel skips only dead rows, which add +0.0,
so at the render's shape it is held bit for bit as well).  B4's per-warp
triangle cull changes no bit of its film.  B2/B3 forced onto B1's cases
equals B1's film
at the same contract and at max abs 2e-5 where no tie shows.  For B7,
``t`` at rtol 2e-4 where both hit and the hit/miss and triangle index on
>= 99.9% of rays: the kernel sums the K=13 cancelling products in feature
order with no FMA, the plain version through cuBLAS in its own order (the
tolerance ``tests/test_mxu_triangles.py`` gives two such orders).  The B8
kernels (the grid cell-walk pair, the take-list primitives, the loop arms)
and the light pass's (L1, L2a, L2b: tables and seed states) equal their
plain versions bit for bit: the same float operations in the same order,
none contracted, below 2,048 triangles (the full warp scan repeats the
sequential scan's update in its order); from 2,048 the culled walk gives
the full-scan instantiation's (t, triangle index) on every trace; the
light pass's tables, read back to the host, also hold to the port's
NumPy oracles (``hold_light_pass_to_oracles``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE, REFERENCE_LMEM, Quirks)
from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G6
from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as GR
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_simple as M5
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M4
from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    demo_scene, dense_vlp_scene, ripple_sheet_mesh, torus_mesh)
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import SIMPLE, crn_ok

# the camera frame is fixed for 512x512; rows 300+ of the left 40 columns
# are floor with shading points at world x ~ 20-29, y ~ -89..-60 (the
# content band of tests/test_megakernel.py)
CONTENT_ROW = 300


def small_scene() -> Scene:
    """Every primitive class and material (the same scene as
    tests/test_render_super.py::small_scene)."""
    return Scene(
        sphere_centers=np.array([[10, 0, 4], [11, 0, 11]], np.float32),
        square_kj=np.array([[12, 0], [7, 6]], np.float32),
        triangles=np.array([
            [[8, 5, 10], [7.5, 5.3, 10.6], [7.6, 5.1, 10.7]],
            [[6, 4, 10.5], [6.3, 4.1, 10.9], [6.2, 4.0, 11.0]],
        ], np.float32),
        lights=np.array([[10, 4, 10, 200], [15, 2, 7, 150]], np.float32))


def sheet_scene(n_major: int, n_minor: int) -> Scene:
    """The demo scene's spheres, squares and lights with a ripple sheet of
    2 * n_major * n_minor triangles (scene/builtin.py::large_mesh_scene's
    mesh at another density)."""
    base = demo_scene()[0]
    return Scene(sphere_centers=base.sphere_centers,
                 square_kj=base.square_kj,
                 triangles=ripple_sheet_mesh(n_major, n_minor),
                 lights=base.lights)


def fan_scene() -> Scene:
    """B4's walk route on an overfull cell: 96 triangles fanned around a
    point 10 units down the camera's axis (radius 1.2, each wedge 0.002
    further back than the last), facing the camera, in front of a
    2,400-triangle sheet (2,496 triangles: the plain version's traces
    take B7's matmul form); every wedge holds the fan's centre, so that
    cell keeps 96 pairs where the reference grid keeps 62."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera)
    cam = make_camera(z_sign=-1.0)
    up, right, eyo, pos = (np.asarray(x, np.float64) for x in (
        cam.up, cam.right, cam.eye_offset, cam.pos))
    c = up * 256 + right * 256 + eyo
    c /= np.linalg.norm(c)
    u = up / np.linalg.norm(up)
    v = np.cross(c, u)
    p = pos + 10.0 * c
    a = np.linspace(0, 2 * np.pi, 97)
    rim = [p + 1.2 * (np.cos(t) * u + np.sin(t) * v) for t in a]
    fan = np.stack([np.stack([p, rim[k] + 0.002 * k * c,
                              rim[k + 1] + 0.002 * k * c])
                    for k in range(96)]).astype(np.float32)
    base = sheet_scene(40, 30)
    return Scene(sphere_centers=base.sphere_centers,
                 square_kj=base.square_kj,
                 triangles=np.concatenate([fan, base.triangles]),
                 lights=base.lights)


def tie_scene() -> Scene:
    """B4's walk route on exact ties: the 1,800-triangle sheet twice, each
    triangle again at index + 1,800 with the same row (every hit ties; the
    lower index wins in both the walk and the brute force)."""
    base = sheet_scene(30, 30)
    return Scene(sphere_centers=base.sphere_centers,
                 square_kj=base.square_kj,
                 triangles=np.concatenate([base.triangles] * 2),
                 lights=base.lights)


def soup_scene() -> Scene:
    """tests/test_megakernel.py::test_megakernel_blocked_random_soup's
    scene: random triangles on the view ray of pixel (20, 150), zero-area
    slivers and flat axis-aligned ones (zero-extent block boxes, whose
    slab tests meet 0 * inf), 24 of them."""
    rng = np.random.default_rng(31)
    c = np.array([17.959, 4.252, 10.25], np.float32)
    n = 96
    base = (c + rng.uniform(-1.2, 1.2, (n, 1, 3))).astype(np.float32)
    tris = base + rng.uniform(-0.35, 0.35, (n, 3, 3)).astype(np.float32)
    tris[:8, 2] = tris[:8, 1]
    for ax in range(3):
        tris[8 + ax::12, :, ax] = tris[8 + ax::12, :1, ax]
    return Scene(sphere_centers=np.zeros((0, 3), np.float32),
                 square_kj=np.zeros((0, 2), np.float32),
                 triangles=tris,
                 lights=np.array([[10, 4, 10, 200]], np.float32))


def window_torus() -> Scene:
    """A 120-triangle torus on the view ray of pixel (20, 150)."""
    return Scene(sphere_centers=np.zeros((0, 3), np.float32),
                 square_kj=np.zeros((0, 2), np.float32),
                 triangles=torus_mesh(center=(17.959, 4.252, 10.25),
                                      n_major=10, n_minor=6),
                 lights=np.array([[10, 4, 10, 200]], np.float32))


def carry_scene() -> Scene:
    """tests/test_megakernel.py::test_megakernel_carry_t_quirk's scene: a
    sphere wall beyond the primary-hit distance on the shadow path, so the
    _lmem carried t changes occlusions."""
    return Scene(
        sphere_centers=np.array([[20 + i, -75.0, 150.0] for i in range(10)],
                                np.float32),
        square_kj=np.zeros((0, 2), np.float32),
        triangles=np.zeros((0, 3, 3), np.float32),
        lights=np.array([[25.0, -75.0, 300.0, 400.0]], np.float32))


# the grid walk's cases (kernel B11w here; its NumPy twin, the plain walk
# and the JAX package's walk in tests/test_torch_grid_walk.py): scenes,
# camera windows of a 512x512 frame that see each mesh (rows, cols, step)
GRID_SCENES = {"torus": window_torus, "sheet": lambda: sheet_scene(12, 8)}
GRID_WINDOWS = {"torus": ((130, 168), (0, 64), 1),
                "sheet": ((0, 512), (0, 512), 97)}
GRID_KINDS = ["camera", "shadow", "short", "planes", "inside"]


def grid_camera_rays(name):
    """Primary rays (numpy) of the window of GRID_WINDOWS[name]."""
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    (r0, r1), (c0, c1), step = GRID_WINDOWS[name]
    ii, jj = C.pixel_grid(512, 512)
    keep = ((jj >= r0) & (jj < r1) & (ii >= c0) & (ii < c1))
    ii, jj = ii[keep][::step], jj[keep][::step]
    ray_id = (jj * 512 + ii).to(torch.int64) * 4 + 1
    r = R.randn_draws((7, 11), ray_id, C.SITE_CAMERA, 4)
    o, d = primary_rays(make_camera(z_sign=-1.0), ii, jj, *r)
    return o.numpy(), d.numpy()


def grid_rays(name, kind, scn, grid):
    """(o, d, t) float32 numpy of a grid case over ``grid`` (the scene's
    triangle grid): ``camera`` rays from t = 1e9; ``shadow`` rays from the
    camera rays' closest hits (the plain DDA trace, on the CPU) to each
    light, jittered, t = 1e9; ``short`` camera rays seeded with a t short
    of most hits; ``planes`` rays with a 0.0 or -0.0 component (two on
    every fifth) whose origin lies on a grid plane (the box's faces, where
    the slab meets 0 * inf, and inner planes); ``inside`` origins inside
    the grid, random directions."""
    import functools
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        trianglegrid as TG)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        trace_ray)
    f32, big = np.float32, np.float32(1e9)
    g = np.random.default_rng(5)
    frame = G.grid_frame(grid).cpu().numpy()
    vmin, vmax, cs = frame[0:3], frame[3:6], frame[6:9]
    res = np.asarray(grid.res)
    if kind in ("camera", "short", "shadow"):
        o, d = grid_camera_rays(name)
        t = np.full(len(o), big, f32)
        if kind == "short":
            t = g.uniform(2, 60, len(o)).astype(f32)
        if kind == "shadow":
            tr = trace_ray(torch.from_numpy(o), torch.from_numpy(d), scn,
                           tri_override=functools.partial(
                               TG._override, scn=scn, grid=grid,
                               quirks=DEFAULT, plain=True))
            x = o + d * tr.t.numpy()[:, None]
            x = x[tr.material.numpy() != 0]
            ls = []
            for light in scn.lights:
                jit = np.concatenate([g.random((len(x), 2)),
                                      np.zeros((len(x), 1))], 1)
                ls.append(light[:3] + jit.astype(f32) - x)
            d = np.concatenate(ls).astype(f32)
            d /= np.sqrt((d * d).sum(1, keepdims=True))
            o = np.concatenate([x] * len(scn.lights)).astype(f32)
            t = np.full(len(o), big, f32)
        return o.astype(f32), d.astype(f32), t
    n = 600
    if kind == "inside":
        o = g.uniform(vmin, vmax, (n, 3)).astype(f32)
        d = g.normal(size=(n, 3))
    else:   # planes
        o = g.uniform(vmin - 2 * cs, vmax + 2 * cs, (n, 3)).astype(f32)
        d = g.normal(size=(n, 3))
        ax = np.arange(n) % 3
        k = g.integers(0, res[ax] + 1)
        plane = vmin[ax] + cs[ax] * k.astype(f32)
        plane = np.where(k == 0, vmin[ax], plane)
        plane = np.where(k == res[ax], vmax[ax], plane)
        o[np.arange(n), ax] = plane
        d[np.arange(n), ax] = 0.0
        r5 = np.arange(0, n, 5)
        d[r5, (ax[r5] + 1) % 3] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f32)
    if kind == "planes":
        d[np.arange(n), ax] = np.where(np.arange(n) % 2, f32(-0.0), f32(0.0))
    return o, d, np.full(n, big, f32)


def grid_state(n, seed=3):
    """A running hit before the triangle stage (numpy): m 0, 1 or 3, a
    normal, needs on some rays (the walk keeps them where it finds
    nothing)."""
    g = np.random.default_rng(seed)
    m = g.choice(np.array([0, 1, 3], np.int32), n)
    nrm = g.normal(size=(n, 3)).astype(np.float32)
    needs = g.random(n) < 0.3
    return m, nrm, needs


QUIRKS = {"default": DEFAULT, "reference": REFERENCE,
          "reference_lmem": REFERENCE_LMEM}

# (name, scene, seed, (w, h, spp), window kwargs, quirks name)
CASES = [
    ("default_sky", small_scene, 3, (40, 12, 2), {}, "default"),
    ("default_content", small_scene, 3, (40, 308, 2),
     dict(row_offset=CONTENT_ROW, rows=8), "default"),
    ("reference_quirks", small_scene, 4, (16, 308, 2),
     dict(row_offset=CONTENT_ROW, rows=8), "reference"),
    ("odd_size", small_scene, 5, (33, 17, 2), {}, "default"),
    ("spp_window_rows", small_scene, 6, (16, 16, 2),
     dict(spp_offset=2, spp_total=6, row_offset=4, rows=4), "default"),
    ("carry_t", carry_scene, 18, (40, CONTENT_ROW + 12, 2),
     dict(row_offset=CONTENT_ROW, rows=12), "reference_lmem"),
]


# B5 cases (tests/test_megakernel.py:590-634) on the business-card scene:
# (name, seed, (w, h, spp), window kwargs, quirks name).  The sphere-field
# band (rows 192-207) is where mirror chains run; the 40x12 windows are sky.
SIMPLE_CASES = [
    ("sky_40x12x2", 20, (40, 12, 2), {}, "default"),
    ("reference_window", 21, (16, 16, 2),
     dict(spp_offset=1, spp_total=4, row_offset=4, rows=4), "reference"),
    ("sphere_field_band", 22, (48, 208, 1), dict(row_offset=192, rows=16),
     "default"),
    ("sky_40x12x5", 22, (40, 12, 5), {}, "default"),
]
SIMPLE_ATOL = 2e-5


def simple_close(got, want, spp):
    """The simple family's contract, and atol 2e-5 where no pixel ties;
    returns the contract's statistics."""
    ok, st = crn_ok(got, want, spp, SIMPLE)
    assert ok, st
    if st["tie_frac"] == 0.0:
        assert st["max_abs"] <= SIMPLE_ATOL, st
    return st


def synth_vlps(n_live=10, n_dead=14, seed=0):
    """tests/test_megakernel.py::synth_vlps as numpy: live rows over the
    content band's floor points, interleaved with dead (zero) rows."""
    rng = np.random.RandomState(seed)
    n = n_live + n_dead
    v = np.zeros((n, 4), np.float32)
    live_idx = rng.choice(n, n_live, replace=False)
    v[live_idx, 0] = rng.uniform(18.0, 30.0, n_live)
    v[live_idx, 1] = rng.uniform(-95.0, -55.0, n_live)
    v[live_idx, 2] = rng.uniform(1.0, 6.0, n_live)    # above the floor
    v[live_idx, 3] = rng.uniform(0.05, 0.9, n_live)
    return v


# B2/B3 cases against the plain film: (name, scene, seed, (w, h, spp),
# window kwargs, quirks name).  The sheet's 1800 triangles fill 15 blocks,
# not a whole macro of 8; the windows see the meshes.
BLOCKED_CASES = [
    ("sheet_1800", lambda: sheet_scene(30, 30), 3, (64, 96, 2),
     dict(row_offset=200, rows=32), "default"),
    ("sheet_1800_reference", lambda: sheet_scene(30, 30), 4, (64, 96, 2),
     dict(row_offset=300, rows=16), "reference"),
    ("sheet_1800_carry_t", lambda: sheet_scene(30, 30), 5, (64, 96, 2),
     dict(row_offset=300, rows=16), "reference_lmem"),
    ("soup_axis_aligned", soup_scene, 37, (40, 158, 2),
     dict(row_offset=150, rows=8), "default"),
    ("torus_window", window_torus, 23, (40, 158, 2),
     dict(row_offset=150, rows=8), "default"),
]

# B4 cases (tests/test_megakernel.py:705-894) on small_scene(): name ->
# (seed, table, grid, (w, h, spp), window kwargs).  table: the synth_vlps
# seed, or "mlt" for a Metropolis table (mlt_table); grid: None, "static"
# (the vlpgrid build) or "outside" (a tiny grid that misses the band)
VLP_CASES = {
    "synth_content": (7, 0, None, (40, CONTENT_ROW + 12, 2),
                      dict(row_offset=CONTENT_ROW, rows=12)),
    "mlt_window": (1, "mlt", None, (40, CONTENT_ROW + 16, 2),
                   dict(spp_offset=1, spp_total=4, row_offset=CONTENT_ROW + 4,
                        rows=12)),
    "grid": (10, 5, "static", (40, CONTENT_ROW + 12, 2),
             dict(row_offset=CONTENT_ROW, rows=12)),
    "grid_outside_box": (14, 8, "outside", (40, CONTENT_ROW + 12, 2),
                         dict(row_offset=CONTENT_ROW, rows=12)),
}


def mlt_table(seed, device="cpu"):
    """A Metropolis VLP table with live rows: the port's light pass on the
    demo scene, 64 chains x 2 rounds (small_scene's own chains emit no
    live VLP)."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    return mlt_vlps((seed, 0), prep_scene(demo_scene()[0]), 64, 2, DEFAULT,
                    1e-3, device=device)


def vlp_case_inputs(name, device):
    """The port's own inputs of a B4 case on ``device``: scene, key, VLP
    table (the Metropolis one from the port's light pass) and grid."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as TG
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    seed, table, use_grid, shape, kw = VLP_CASES[name]
    scn = prep_scene(small_scene())
    key = (seed, 0)
    if table == "mlt":
        vlps = mlt_table(seed, device)
    else:
        vlps = torch.from_numpy(synth_vlps(seed=table)).to(device)
    grid = None
    if use_grid == "static":
        grid = TV.build_vlp_grid(vlps, TV.vlp_grid_static_res(len(vlps)))
        # B4's mask is uncapped, the plain grid gather keeps `cap` a cell:
        # they agree where no cell overflows
        assert int(grid.counts.max()) < grid.items.shape[1]
    elif use_grid == "outside":
        amin, amax = TV.vlp_aabbs(vlps)
        zero = torch.zeros(3, device=device)
        grid = TG.build_grid_cellscan(amin, amax, zero, zero + 1.0,
                                      (2, 2, 2))
    return scn, key, vlps, grid, shape, kw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_gpu(case, cuda_device):
    _, make_scene, seed, (w, h, spp), kw, qname = case
    scn = prep_scene(make_scene())
    before = M.LAUNCHES
    got = M.film_super_mega((seed, 0), scn, w, h, spp, quirks=QUIRKS[qname],
                            device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert M.LAUNCHES == before + 1
    want = M.film_super_mega_plain((seed, 0), scn, w, h, spp,
                                   quirks=QUIRKS[qname], device=cuda_device,
                                   **kw)
    assert got.shape == want.shape == (kw.get("rows", h), w, 3)
    ok, st = crn_ok(got, want, spp)
    assert ok, st


@pytest.mark.gpu
def test_render_on_gpu_launches_the_kernel(cuda_device):
    """api.render on a CUDA device goes through the kernel, once."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    before = M.LAUNCHES
    film = pt.render("super", demo_scene()[0], 64, 64, spp=2, seed=1,
                     device=cuda_device)
    torch.cuda.synchronize()
    assert M.LAUNCHES == before + 1
    assert film.device.type == "cuda" and film.shape == (64, 64, 3)
    assert torch.isfinite(film).all()


def _traced_rgba8_frame(variant, scene, device):
    """The profiler's events of one 64x64x2 RGBA8 frame on the card."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        img = pt.render(variant, scene, 64, 64, spp=2, seed=3,
                        as_rgba8=True, device=device)
    assert img.shape == (64, 64, 4)
    return list(prof.events())


@pytest.mark.gpu
def test_frame_spans_on_gpu(cuda_device):
    """A traced super frame shows ``pt.kernel.mega_super`` with ``pt.pack``
    inside it, a traced sheet frame ``pt.kernel.mega_blocked`` without
    one, and a second sheet frame no ``pt.build``; every span's mirror on
    the device is a user annotation (which the benchmark's trace reduction
    leaves out of the device's busy time)."""
    def host(events, name):
        return [e for e in events if e.name == name
                and e.device_type.name == "CPU"]

    def inside(inner, outer):
        return (outer.time_range.start <= inner.time_range.start
                and inner.time_range.end <= outer.time_range.end)

    sheet = sheet_scene(144, 72)
    frames = {"super": _traced_rgba8_frame("super", demo_scene()[0],
                                           cuda_device),
              "sheet": _traced_rgba8_frame("trianglegrid", sheet,
                                           cuda_device),
              "sheet again": _traced_rgba8_frame("trianglegrid", sheet,
                                                 cuda_device)}
    (b1,) = host(frames["super"], "pt.kernel.mega_super")
    (pack,) = host(frames["super"], "pt.pack")
    assert inside(pack, b1)
    assert not host(frames["super"], "pt.kernel.mega_blocked")
    for name in ("sheet", "sheet again"):
        (b23,) = host(frames[name], "pt.kernel.mega_blocked")
        assert not host(frames[name], "pt.pack")
        assert not host(frames[name], "pt.kernel.mega_super")
        (render,) = host(frames[name], "pt.render")
        assert inside(b23, render)
    # the scene, its triangle-free buffer and the exact grid
    assert len(host(frames["sheet"], "pt.build")) == 3
    assert not host(frames["sheet again"], "pt.build")
    for events in frames.values():
        for e in events:
            if e.name.startswith("pt.") and e.device_type.name != "CPU":
                assert e.is_user_annotation, (e.name, e.device_type)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VLP_CASES))
def test_vlp_kernel_matches_plain_on_gpu(name, cuda_device):
    scn, key, vlps, grid, (w, h, spp), kw = vlp_case_inputs(name,
                                                            cuda_device)
    before = M4.LAUNCHES
    got = M4.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                           device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert M4.LAUNCHES == before + 1
    want = M4.film_vlp_mega_plain(key, scn, vlps, w, h, spp, grid=grid,
                                  device=cuda_device, **kw)
    assert got.shape == want.shape == (kw.get("rows", h), w, 3)
    ok, st = crn_ok(got, want, spp)
    assert ok, st


@pytest.mark.gpu
@pytest.mark.parametrize("grid_mode", [False, True])
def test_vlp_kernel_chunked_equals_one_piece(grid_mode, cuda_device):
    """A table of 700 live rows read in chunks of 256 rows gives the film
    of the same table read in one piece, bit for bit."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    scn = prep_scene(small_scene())
    vlps = torch.from_numpy(synth_vlps(n_live=700, n_dead=60, seed=9))
    vlps[:, 3] *= 0.01
    vlps = vlps.to(cuda_device)
    grid = (TV.build_vlp_grid(vlps, (4, 4, 4)) if grid_mode else None)
    kw = dict(grid=grid, row_offset=CONTENT_ROW, rows=8, device=cuda_device)
    a = M4.film_vlp_mega((21, 0), scn, vlps, 32, CONTENT_ROW + 8, 2,
                         chunk_rows=256, **kw)
    b = M4.film_vlp_mega((21, 0), scn, vlps, 32, CONTENT_ROW + 8, 2,
                         chunk_rows=1024, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VLP_CASES) + ["demo_emitted"])
def test_vlp_kernel_cull_is_bit_equal(name, cuda_device):
    """B4's per-warp triangle cull changes no film bit: the culled launch
    equals the instantiation that scans every triangle block, on the GPU
    tests' cases and on the demo scene's emitted table over the full
    frame (the torus and its shadows), with and without negative t."""
    if name == "demo_emitted":
        from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
        scn = prep_scene(demo_scene()[0])
        key = (5, 0)
        vlps = TV.emit_vlps(key, scn, 512, device=cuda_device)
        grid, (w, h, spp), kw = None, (512, 512, 2), {}
    else:
        scn, key, vlps, grid, (w, h, spp), kw = vlp_case_inputs(name,
                                                                cuda_device)
    for quirks in (DEFAULT, REFERENCE):
        a = M4.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                             quirks=quirks, device=cuda_device, **kw)
        b = M4.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                             quirks=quirks, device=cuda_device, cull=False,
                             **kw)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_vlp_stats_counts_the_render(cuda_device):
    """The counting launch's tallies: the cull changes no lit hit, cast or
    gather term and tests fewer pairs than the cull-free scan; a lit hit
    casts one ray a light and gathers one term a live VLP."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    scn = prep_scene(demo_scene()[0])
    key = (0, 0)
    vlps = TV.emit_vlps(key, scn, 512, device=cuda_device)
    n_live = int((vlps[:, 3] > 0).sum())
    on = M4.vlp_stats(key, scn, vlps, 512, 512, 1, spp_total=8,
                      device=cuda_device)
    off = M4.vlp_stats(key, scn, vlps, 512, 512, 1, spp_total=8, cull=False,
                       device=cuda_device)
    for k in ("lit", "casts", "casts_tri", "gather_pairs"):
        assert on[k] == off[k], k
    assert on["casts"] == on["lit"] * int(scn.lights.shape[0])
    assert on["gather_pairs"] == on["lit"] * n_live
    assert 0 < on["tested"] < off["tested"]
    # without the cull every warp scans every triangle for its camera rays
    assert off["tested"] >= 512 * 512 * int(scn.tri_v0.shape[0])


@pytest.mark.gpu
@pytest.mark.parametrize("via", ["live_table", "raw", "tier1"])
def test_gather_kernel_at_the_render_shape(via, cuda_device):
    """B6 on 65,536 points (a tier-1 render's call) against a table with
    few live rows: through the live-first table, from the raw table (the
    wrapper builds it) and through the tier-1 gather with the live-first
    table in place of the raw one (as a render passes it), one launch
    each, bit-equal to the plain version over the full table (the same
    sequential sum; the dead rows it skips add +0.0)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    rng = np.random.default_rng(12)
    R, V = 65536, 1024
    x = rng.normal(5, 3, (R, 3)).astype(np.float32)
    n = rng.normal(0, 1, (R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vlps = rng.normal(5, 3, (V, 4)).astype(np.float32)
    vlps[:, 3] = np.where(rng.random(V) < 0.05, np.abs(vlps[:, 3]), 0.0)
    tx, tn, tv = (torch.from_numpy(a).to(cuda_device) for a in (x, n, vlps))
    table = TV.live_table(tv)
    assert int(table.n_live) == int((vlps[:, 3] > 0).sum()) > 0
    before = G6.LAUNCHES
    if via == "tier1":
        got = TV.gather_vlps(tx, tn, table)
    else:
        got = G6.gather_vlps_mxu(tx, tn, table if via == "live_table"
                                 else tv)
    torch.cuda.synchronize()
    assert G6.LAUNCHES == before + 1
    want = G6.gather_vlps_mxu_plain(tx, tn, tv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("R,V", [(777, 130), (4096, 1024)])
def test_gather_kernel_matches_plain_on_gpu(R, V, cuda_device):
    rng = np.random.default_rng(11)
    x = rng.normal(5, 3, (R, 3)).astype(np.float32)
    n = rng.normal(0, 1, (R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vlps = rng.normal(5, 3, (V, 4)).astype(np.float32)
    vlps[:, 3] = np.abs(vlps[:, 3])
    vlps[::5, 3] = 0.0
    tx, tn, tv = (torch.from_numpy(a).to(cuda_device) for a in (x, n, vlps))
    before = G6.LAUNCHES
    got = G6.gather_vlps_mxu(tx, tn, tv)
    torch.cuda.synchronize()
    assert G6.LAUNCHES == before + 1
    want = G6.gather_vlps_mxu_plain(tx, tn, tv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_lmem_route_launches_gather_kernel_not_vlp_kernel(cuda_device):
    """bidirectional under REFERENCE_LMEM with 9 lights is outside B4's
    gate: the render runs the tier-1 wavefront on the card, whose gather is
    B6.  With the demo's lights REFERENCE_LMEM is inside it (the VLP family
    reads no shadow_carry_t): one B4 launch, the film of REFERENCE bit for
    bit."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    base = demo_scene()[0]
    nine = Scene(sphere_centers=base.sphere_centers,
                 square_kj=base.square_kj, triangles=base.triangles,
                 lights=np.tile(base.lights, (5, 1))[:9])
    kw = dict(spp=1, seed=2, n_vlp=64, device=cuda_device)
    b4, b6 = M4.LAUNCHES, G6.LAUNCHES
    film = pt.render("bidirectional", nine, 64, 64, quirks=REFERENCE_LMEM,
                     **kw)
    torch.cuda.synchronize()
    assert M4.LAUNCHES == b4 and G6.LAUNCHES > b6
    assert film.shape == (64, 64, 3) and torch.isfinite(film).all()
    b4, b6 = M4.LAUNCHES, G6.LAUNCHES
    lmem = pt.render("bidirectional", base, 64, CONTENT_ROW + 64,
                     quirks=REFERENCE_LMEM, **kw)
    torch.cuda.synchronize()
    assert M4.LAUNCHES == b4 + 1 and G6.LAUNCHES == b6
    assert torch.equal(lmem, pt.render("bidirectional", base, 64,
                                       CONTENT_ROW + 64, quirks=REFERENCE,
                                       **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["bidirectional", "metropolis",
                                     "metropolis_vlpgrid"])
def test_vlp_render_on_gpu_launches_the_kernel(variant, cuda_device):
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    kw = (dict(n_vlp=64) if variant == "bidirectional"
          else dict(n_seedpaths=16, mutation_rounds=2))
    before = M4.LAUNCHES
    film = pt.render(variant, demo_scene()[0], 64, 64, spp=2, seed=1,
                     device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert M4.LAUNCHES == before + 1
    assert film.shape == (64, 64, 3) and torch.isfinite(film).all()


def sheet_tables(sheet, table, device):
    """(scene arrays, key, VLP table, grid) of B4's walk cases on a ripple
    sheet: the emitted table (dense) or the Metropolis one with its grid."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    scn = prep_scene(sheet_scene(*sheet))
    key = (0, 0)
    if table == "dense":
        return scn, key, TV.emit_vlps(key, scn, 512, device=device), None
    vlps = mlt_vlps(key, scn, 512, 8, device=device)
    return scn, key, vlps, TV.build_vlp_grid(
        vlps, TV.vlp_grid_static_res(int(vlps.shape[0])))


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["default", "reference"])
@pytest.mark.parametrize("table", ["dense", "grid"])
@pytest.mark.parametrize("sheet", [(30, 30), (144, 72)],
                         ids=["1800", "20736"])
def test_vlp_walk_matches_plain_on_gpu(sheet, table, qname, cuda_device):
    """B4's walk route (past 512 triangles) against its plain version on
    the 1,800- and 20,736-triangle sheets, 512x512 samples 0-1 of 4, under
    the CRN contract; one launch each."""
    scn, key, vlps, grid = sheet_tables(sheet, table, cuda_device)
    assert M4.uses_walk(scn)
    kw = dict(spp_total=4, grid=grid, quirks=QUIRKS[qname],
              device=cuda_device)
    before = M4.LAUNCHES
    got = M4.film_vlp_mega(key, scn, vlps, 512, 512, 2, **kw)
    torch.cuda.synchronize()
    assert M4.LAUNCHES == before + 1
    want = M4.film_vlp_mega_plain(key, scn, vlps, 512, 512, 2, **kw)
    ok, st = crn_ok(got, want, 2)
    assert ok, st


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VLP_CASES) + ["demo_emitted"])
def test_vlp_force_walk_matches_smem_route(name, cuda_device):
    """``force_walk=True`` walks the exact grid on the shared-memory
    route's meshes: the same film under the CRN contract and within 2e-5
    where no pixel ties (as B2/B3 forced is held to B1), under the default
    and the reference quirks."""
    if name == "demo_emitted":
        from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
        scn = prep_scene(demo_scene()[0])
        key = (5, 0)
        vlps = TV.emit_vlps(key, scn, 512, device=cuda_device)
        grid, (w, h, spp), kw = None, (512, 512, 2), {}
    else:
        scn, key, vlps, grid, (w, h, spp), kw = vlp_case_inputs(name,
                                                                cuda_device)
    for quirks in (DEFAULT, REFERENCE):
        a = M4.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                             quirks=quirks, device=cuda_device,
                             force_walk=True, **kw)
        b = M4.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                             quirks=quirks, device=cuda_device, **kw)
        ok, st = crn_ok(a, b, spp)
        assert ok and (st["tie_frac"] > 0 or st["max_abs"] <= 2e-5), st
    with pytest.raises(ValueError, match="cull-free"):
        M4.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                         device=cuda_device, force_walk=True, cull=False,
                         **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fan", "ties", "sheet1048576_band"])
def test_vlp_walk_matches_plain_on_hard_meshes(case, cuda_device):
    """B4's walk route against its plain version under the CRN contract on
    the meshes that the exact grid exists for: 96 triangles through one
    cell (``fan_scene``), every hit an exact tie (``tie_scene``), and rows
    248-255 of the 1,048,576-triangle sheet, 512x512 samples 0-1 of 4,
    the default and the reference quirks; one launch each."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    scene, band = {"fan": (fan_scene, {}), "ties": (tie_scene, {}),
                   "sheet1048576_band": (lambda: large_mesh_scene(1024, 512),
                                         dict(row_offset=248, rows=8))}[case]
    scn = prep_scene(scene())
    assert M4.uses_walk(scn)
    key = (0, 0)
    vlps = TV.emit_vlps(key, scn, 512, device=cuda_device)
    for q in (DEFAULT, REFERENCE):
        kw = dict(spp_total=4, quirks=q, device=cuda_device, **band)
        before = M4.LAUNCHES
        got = M4.film_vlp_mega(key, scn, vlps, 512, 512, 2, **kw)
        torch.cuda.synchronize()
        assert M4.LAUNCHES == before + 1
        want = M4.film_vlp_mega_plain(key, scn, vlps, 512, 512, 2, **kw)
        ok, st = crn_ok(got, want, 2)
        assert ok, (q, st)
        assert float(want.mean()) > 0


@pytest.mark.gpu
def test_vlp_walk_stats_are_consistent(cuda_device):
    """The walk's counting launch on the 20,736 sheet: a walk for every
    camera ray of the frame and every cast that reaches the triangles,
    the lanes' pairs at most the pairs their warps pay (32 a pair
    iteration), empty cells among those visited, every stage of the
    clock64 split counted, a lit hit casting one ray a light and gathering
    one term a live VLP, and the film untouched by the count; on the
    shared-memory route the walk's slots stay 0, and ``force_walk`` on
    the demo counts the same lit hits, casts and terms."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    scn, key, vlps, _ = sheet_tables((144, 72), "dense", cuda_device)
    film = M4.film_vlp_mega(key, scn, vlps, 256, 256, 2, spp_total=16,
                            device=cuda_device)
    st = M4.vlp_stats(key, scn, vlps, 256, 256, 2, spp_total=16)
    again = M4.film_vlp_mega(key, scn, vlps, 256, 256, 2, spp_total=16,
                             device=cuda_device)
    assert torch.equal(film, again)
    n_live = int((vlps[:, 3] > 0).sum())
    assert st["walks"] == 256 * 256 * 2 + st["casts_tri"]
    assert st["walks"] >= st["entered"] > 0
    assert st["tested"] >= st["pairs"] > 0 and st["tested"] % 32 == 0
    assert st["cells"] > st["empty"] > 0
    for k in ("clk_setup", "clk_empty", "clk_loads", "clk_pairs",
              "clk_step"):
        assert st[k] > 0, k
    assert sum(st[k] for k in ("clk_setup", "clk_empty", "clk_loads",
                               "clk_pairs", "clk_step")) <= (
        st["cam_tri"] + st["shadow_tri"])
    assert st["casts"] == st["lit"] * int(scn.lights.shape[0])
    assert st["gather_pairs"] == st["lit"] * n_live
    demo = prep_scene(demo_scene()[0])
    dv = TV.emit_vlps(key, demo, 512, device=cuda_device)
    sm = M4.vlp_stats(key, demo, dv, 512, 512, 1, spp_total=8)
    assert sm["tested"] > 0 and sm["walks"] == sm["cells"] == 0
    fw = M4.vlp_stats(key, demo, dv, 512, 512, 1, spp_total=8,
                      force_walk=True)
    assert fw["tested"] >= fw["pairs"] > 0
    for k in ("lit", "casts", "casts_tri", "gather_pairs"):
        assert fw[k] == sm[k], k


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["bidirectional", "metropolis",
                                     "metropolis_vlpgrid"])
def test_vlp_render_on_the_sheet_launches_light_pass_and_b4(variant,
                                                            cuda_device):
    """On the 20,736-triangle sheet a VLP render is the light pass's kernels
    and one B4 launch (the walk), no B6, no B7."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    kw = (dict(n_vlp=64) if variant == "bidirectional"
          else dict(n_seedpaths=16, mutation_rounds=2))
    counts = lambda: (M4.LAUNCHES, G6.LAUNCHES, B7.LAUNCHES,  # noqa
                      L.EMIT_LAUNCHES, L.SEED_LAUNCHES, L.CHAIN_LAUNCHES)
    c0 = counts()
    film = pt.render(variant, sheet_scene(144, 72), 64, 64, spp=2, seed=1,
                     device=cuda_device, **kw)
    torch.cuda.synchronize()
    light = (1, 0, 0) if variant == "bidirectional" else (0, 1, 1)
    assert counts() == (c0[0] + 1, c0[1], c0[2]) + tuple(
        a + b for a, b in zip(c0[3:], light))
    assert film.shape == (64, 64, 3) and torch.isfinite(film).all()


@pytest.mark.gpu
def test_crn_frame_tool_on_gpu(cuda_device, monkeypatch, capsys):
    """The A14 tool at 64x64x2 on the card: every family within its
    contract (exit 0); a perturbed film violates it (exit 1)."""
    from opencl_montecarlo_path_tracing_tpu_torch import api
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        validate_crn_frame as V)
    assert V.main(["--size", "64", "--spp", "2"]) == 0
    assert "contract OK" in capsys.readouterr().out
    real = api.render
    monkeypatch.setattr(api, "render", lambda *a, **k: real(*a, **k) + 0.05)
    assert V.main(["--size", "64", "--spp", "2", "--families", "bidir"]) == 1
    assert "contract VIOLATED" in capsys.readouterr().out


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_blocked_kernel_forced_matches_smem_kernel(case, cuda_device):
    """B2/B3 forced onto B1's cases renders B1's film (a scene without
    triangles stays on B1, as in the JAX package)."""
    _, make_scene, seed, (w, h, spp), kw, qname = case
    scn = prep_scene(make_scene())
    blocked = int(scn.tri_v0.shape[0] > 0)
    before = M.LAUNCHES, M.BLOCKED_LAUNCHES
    got = M.film_super_mega((seed, 0), scn, w, h, spp, quirks=QUIRKS[qname],
                            device=cuda_device, force_blocked=True, **kw)
    want = M.film_super_mega((seed, 0), scn, w, h, spp, quirks=QUIRKS[qname],
                             device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert (M.LAUNCHES, M.BLOCKED_LAUNCHES) == (before[0] + 2 - blocked,
                                                before[1] + blocked)
    ok, st = crn_ok(got, want, spp)
    assert ok, st
    if st["tie_frac"] == 0.0:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", BLOCKED_CASES,
                         ids=[c[0] for c in BLOCKED_CASES])
def test_blocked_kernel_matches_plain_on_gpu(case, cuda_device):
    _, make_scene, seed, (w, h, spp), kw, qname = case
    scn = prep_scene(make_scene())
    before = M.BLOCKED_LAUNCHES
    got = M.film_super_mega((seed, 0), scn, w, h, spp, quirks=QUIRKS[qname],
                            device=cuda_device, force_blocked=True, **kw)
    torch.cuda.synchronize()
    assert M.BLOCKED_LAUNCHES == before + 1
    want = M.film_super_mega_plain((seed, 0), scn, w, h, spp,
                                   quirks=QUIRKS[qname], device=cuda_device,
                                   **kw)
    assert want.var() > 1e-5                   # the mesh is in the window
    ok, st = crn_ok(got, want, spp)
    assert ok, st


@pytest.mark.gpu
def test_blocked_kernel_matches_plain_on_a_1m_band(cuda_device):
    """B2/B3 on an 8-row band of the 1,048,576-triangle sheet (the stream
    tier's size; its node tree has three levels above the macros) against
    the tier-1 plain film."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    scn = prep_scene(large_mesh_scene(1024, 512))
    kw = dict(spp_total=4, row_offset=248, rows=8, device=cuda_device)
    before = M.BLOCKED_LAUNCHES
    got = M.film_super_mega((0, 0), scn, 512, 512, 1, **kw)
    torch.cuda.synchronize()
    assert M.BLOCKED_LAUNCHES == before + 1
    want = M.film_super_mega_plain((0, 0), scn, 512, 512, 1, **kw)
    assert want.var() > 1e-5                   # the sheet fills the band
    ok, st = crn_ok(got, want, 1)
    assert ok, st


# B2/B3's grid walk on the benchmark's sheet (large_mesh_scene(): 20,736
# triangles) against the tier-1 plain film: (name, (w, h, spp), window
# kwargs).  A band at a non-zero row offset, and a width and a band that
# are no multiple of the 16 x 8 block tile (ghost lanes in the warps).
SHEET_BANDS = [
    ("band_256", (512, 512, 2), dict(spp_total=4, row_offset=256, rows=64)),
    ("ghost_lanes", (509, 512, 2), dict(spp_total=4, row_offset=301,
                                        rows=37)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["default", "reference_lmem"])
@pytest.mark.parametrize("band", SHEET_BANDS, ids=[b[0] for b in SHEET_BANDS])
def test_blocked_kernel_matches_plain_on_the_sheet(band, qname,
                                                   cuda_device):
    """B2/B3 on the 20,736-triangle sheet (its uncapped any-hit shadow
    rays, and under REFERENCE_LMEM the carried closest-hit ones with
    negative t) against the tier-1 plain film under the contract; one
    launch each."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    _, (w, h, spp), kw = band
    scn = prep_scene(large_mesh_scene())
    assert M.uses_blocked(scn)
    kw = dict(kw, quirks=QUIRKS[qname], device=cuda_device)
    before = M.BLOCKED_LAUNCHES
    got = M.film_super_mega((2, 0), scn, w, h, spp, **kw)
    torch.cuda.synchronize()
    assert M.BLOCKED_LAUNCHES == before + 1
    want = M.film_super_mega_plain((2, 0), scn, w, h, spp, **kw)
    assert got.shape == want.shape == (kw["rows"], w, 3)
    assert want.var() > 1e-5                   # the sheet fills the band
    ok, st = crn_ok(got, want, spp)
    assert ok, st


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["default", "reference_lmem"])
def test_blocked_kernel_forced_on_the_torus_matches_b1(qname, cuda_device):
    """``force_blocked`` on the demo scene's 96-triangle torus: the grid
    walk's film is B1's (which scans every triangle in index order) under
    the contract, and within 2e-5 where no pixel ties."""
    scn = prep_scene(demo_scene()[0])
    assert int(scn.tri_v0.shape[0]) == 96 and not M.uses_blocked(scn)
    kw = dict(spp_total=4, row_offset=192, rows=128, quirks=QUIRKS[qname],
              device=cuda_device)
    before = M.LAUNCHES, M.BLOCKED_LAUNCHES
    got = M.film_super_mega((3, 0), scn, 512, 512, 2, force_blocked=True,
                            **kw)
    want = M.film_super_mega((3, 0), scn, 512, 512, 2, **kw)
    torch.cuda.synchronize()
    assert (M.LAUNCHES, M.BLOCKED_LAUNCHES) == (before[0] + 1,
                                                before[1] + 1)
    ok, st = crn_ok(got, want, 2)
    assert ok, st
    if st["tie_frac"] == 0.0:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.gpu
def test_blocked_kernel_matches_plain_on_a_262k_band(cuda_device):
    """B2/B3 on an 8-row band of the 262,144-triangle sheet (the stream
    tier; its grid reaches the 512-cell axis clamp) against the tier-1
    plain film."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    scn = prep_scene(large_mesh_scene(512, 256))
    kw = dict(spp_total=4, row_offset=248, rows=8, device=cuda_device)
    before = M.BLOCKED_LAUNCHES
    got = M.film_super_mega((0, 0), scn, 512, 512, 1, **kw)
    torch.cuda.synchronize()
    assert M.BLOCKED_LAUNCHES == before + 1
    want = M.film_super_mega_plain((0, 0), scn, 512, 512, 1, **kw)
    assert want.var() > 1e-5                   # the sheet fills the band
    ok, st = crn_ok(got, want, 1)
    assert ok, st


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["default", "reference_lmem"])
def test_blocked_stats_count_the_walks(qname, cuda_device):
    """B2/B3's counting launch on the 20,736 sheet: a walk for every
    camera ray of the film and every cast that reaches the triangles
    (under REFERENCE_LMEM every cast), a few dozen pairs a walk of the
    mesh's 20,736 (the cull engages), the lanes' pairs at most the pairs
    their warps pay (32 a pair iteration), empty cells among those
    visited, every stage of the clock64 split counted inside the walks'
    cycles, and the film untouched by the count."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    scn = prep_scene(large_mesh_scene())
    q = QUIRKS[qname]
    # the whole frame: its floor and diffuse hits cast past the spheres
    # and squares (the top-left quarter's all fall in their shadows)
    film = M.film_super_mega((0, 0), scn, 512, 512, 1, spp_total=16,
                             quirks=q, device=cuda_device)
    st = M.blocked_stats((0, 0), scn, 512, 512, 1, spp_total=16, quirks=q,
                         device=cuda_device)
    again = M.film_super_mega((0, 0), scn, 512, 512, 1, spp_total=16,
                              quirks=q, device=cuda_device)
    assert torch.equal(film, again)
    assert st["walks"] == 512 * 512 + st["casts_tri"], st
    assert 0 < st["casts_tri"] <= st["casts"], st
    if q.shadow_carry_t:
        assert st["casts_tri"] == st["casts"], st
    assert st["walks"] >= st["entered"] > 0, st
    assert 0 < st["pairs"] < 100 * st["walks"], st
    assert st["tested"] >= st["pairs"] and st["tested"] % 32 == 0, st
    assert st["cells"] > st["empty"] > 0, st
    split = ("clk_setup", "clk_empty", "clk_loads", "clk_pairs", "clk_step")
    for k in split:
        assert st[k] > 0, k
    assert sum(st[k] for k in split) <= st["cam_tri"] + st["shadow_tri"]
    assert st["cam_tri"] + st["shadow_tri"] < st["kernel"], st


@pytest.mark.gpu
@pytest.mark.parametrize("neg_t", [False, True])
def test_tri_closest_kernel_matches_plain_on_gpu(neg_t, cuda_device):
    scene = sheet_scene(32, 32)
    scn = prep_scene(scene)
    g = np.random.default_rng(5)
    tris = scene.triangles.astype(np.float64)
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera)
    cam = np.asarray(make_camera(z_sign=-1.0).pos, np.float64)
    o = cam + g.normal(0.0, 3.0, (4096, 3))
    p = tris[g.integers(0, len(tris), 4096)].mean(axis=1)
    d = p - o
    d[::8] = -d[::8]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
            for a in (o, d))
    quirks = REFERENCE if neg_t else DEFAULT
    before = B7.LAUNCHES
    t, i = B7.triangle_closest(o, d, scn, quirks)
    torch.cuda.synchronize()
    assert B7.LAUNCHES == before + 1
    tp, ip = B7.triangle_closest_plain(o, d, scn, quirks)
    hit, hitp = torch.isfinite(t), torch.isfinite(tp)
    assert hit.float().mean() > 0.5
    assert (hit == hitp).float().mean() >= 0.999
    both = hit & hitp
    torch.testing.assert_close(t[both], tp[both], rtol=2e-4, atol=0)
    assert (i[both] == ip[both]).float().mean() >= 0.999


@pytest.mark.gpu
def test_render_routes_launch_their_kernels(cuda_device):
    """super on a 1800-triangle sheet launches B2/B3; trianglegrid's auto
    accel launches it too and its DDA launches B11 once (and no B11w) and
    renders the same film under the contract; bidirectional on a
    2048-triangle sheet launches B4 once (its walk over the block tables)
    and neither B7 nor B6; a 9-light copy of that sheet (outside B4's
    gate) runs the tier-1 route with B7 and B6 and no B4."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G
    sheet = sheet_scene(30, 30)
    counts = lambda: (M.LAUNCHES, M.BLOCKED_LAUNCHES, B7.LAUNCHES,  # noqa
                      M4.LAUNCHES, G.LAUNCHES, GR.MEGA_LAUNCHES,
                      GR.WALK_LAUNCHES)
    c0 = counts()
    film = pt.render("super", sheet, 64, 64, spp=2, seed=1,
                     device=cuda_device)
    torch.cuda.synchronize()
    assert counts() == (c0[0], c0[1] + 1) + c0[2:]
    assert torch.isfinite(film).all()
    c0 = counts()
    auto = pt.render("trianglegrid", sheet, 64, 64, spp=2, seed=1,
                     device=cuda_device)
    dda = pt.render("trianglegrid", sheet, 64, 64, spp=2, seed=1,
                    accel="dda", device=cuda_device)
    torch.cuda.synchronize()
    assert counts() == (c0[0], c0[1] + 1) + c0[2:5] + (c0[5] + 1, c0[6])
    ok, st = crn_ok(auto, dda, 2)
    assert ok, st
    c0 = counts()
    film = pt.render("bidirectional", sheet_scene(32, 32), 64, 64, spp=1,
                     seed=2, n_vlp=64, device=cuda_device)
    torch.cuda.synchronize()
    # 2,048 triangles: B4 walks the block tables; no B7, no B6
    assert counts() == c0[:3] + (c0[3] + 1,) + c0[4:]
    assert film.shape == (64, 64, 3) and torch.isfinite(film).all()
    nine = sheet_scene(32, 32)
    nine = Scene(sphere_centers=nine.sphere_centers, square_kj=nine.square_kj,
                 triangles=nine.triangles,
                 lights=np.tile(nine.lights, (5, 1))[:9])
    c0 = counts()
    film = pt.render("bidirectional", nine, 64, 64, spp=1, seed=2, n_vlp=64,
                     device=cuda_device)
    torch.cuda.synchronize()
    # 9 lights: the tier-1 route, its traces on B7 (>= 2,048 triangles)
    c1 = counts()
    assert c1[:2] == c0[:2] and c1[3] == c0[3] and c1[5:] == c0[5:]
    assert c1[2] > c0[2] and c1[4] > c0[4]
    assert film.shape == (64, 64, 3) and torch.isfinite(film).all()


def walk_bit_equal(o, d, t, m, nrm, needs, scn, grid, quirks, device):
    """B11w (``traverse_triangles`` on CUDA tensors: one launch) == the
    plain walk (``plain=True``) on the card, bit for bit on t, m, the
    normal and needs; returns the rays that hit a triangle."""
    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    args = (to(o), to(d), to(t), to(m), to(nrm[:, 0]), to(nrm[:, 1]),
            to(nrm[:, 2]), to(needs))
    before = GR.WALK_LAUNCHES
    got = GR.traverse_triangles(*args, scn, grid, quirks)
    torch.cuda.synchronize()
    assert GR.WALK_LAUNCHES == before + 1
    want = GR.traverse_triangles(*args, scn, grid, quirks, plain=True)
    assert GR.WALK_LAUNCHES == before + 1
    for name, a, b in zip(("t", "m", "nx", "ny", "nz", "needs"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (name, int((a != b).sum()))
    return int((got[1] == 4).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["default", "reference"])
@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("name", list(GRID_SCENES))
def test_grid_walk_bit_equal_plain(name, kind, qname, cuda_device):
    """B11w == the plain walk, bit for bit: the cases that
    tests/test_torch_grid_walk.py holds the kernel's NumPy twin to, on the
    grid built on the card."""
    scn = prep_scene(GRID_SCENES[name]())
    grid, _ = GR.triangle_grid(scn, device=cuda_device)
    o, d, t = grid_rays(name, kind, scn, grid)
    m, nrm, needs = grid_state(len(o))
    hits = walk_bit_equal(o, d, t, m, nrm, needs, scn, grid, QUIRKS[qname],
                          cuda_device)
    assert hits > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["camera", "shadow"])
def test_grid_walk_bit_equal_plain_on_1800_sheet(kind, cuda_device):
    """B11w == the plain walk on a 1,800-triangle sheet's camera rays
    (every 97th pixel of 512x512) and their shadow rays."""
    scn = prep_scene(sheet_scene(30, 30))
    grid, _ = GR.triangle_grid(scn, device=cuda_device)
    o, d, t = grid_rays("sheet", kind, scn, grid)
    m, nrm, needs = grid_state(len(o), seed=9)
    hits = walk_bit_equal(o, d, t, m, nrm, needs, scn, grid, DEFAULT,
                          cuda_device)
    assert hits > 0.05 * len(o)


@pytest.mark.gpu
def test_grid_walk_debug_hook_on_gpu(cuda_device, monkeypatch, capsys):
    """PT_KERNEL_DEBUG=1: the walk on CUDA tensors (B11w's counting
    launch) prints the plain walk's statistics line, the same counts."""
    scn = prep_scene(sheet_scene(30, 30))
    grid, _ = GR.triangle_grid(scn, device=cuda_device)
    o, d, t = grid_rays("sheet", "camera", scn, grid)
    m, nrm, needs = grid_state(len(o))
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                 for a in (o, d, t, m, nrm[:, 0], nrm[:, 1], nrm[:, 2],
                           needs))
    monkeypatch.setenv("PT_KERNEL_DEBUG", "1")
    GR.traverse_triangles(*args, scn, grid, DEFAULT)
    kernel = capsys.readouterr().out
    GR.traverse_triangles(*args, scn, grid, DEFAULT, plain=True)
    assert "[grid DDA] rays=" in kernel
    assert kernel == capsys.readouterr().out


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["default", "reference_lmem"])
def test_mega_grid_holds_to_plain_dda_and_blocked(qname, cuda_device):
    """B11 at 64x64x2 on the 1,800-triangle sheet: one launch, no B11w;
    its film under the contract against the plain DDA film (every trace
    plain PyTorch) and against B2/B3's; REFERENCE_LMEM's carried shadow
    distance too."""
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        trianglegrid as TG)
    scn = prep_scene(sheet_scene(30, 30))
    quirks = QUIRKS[qname]
    tab = GR.triangle_tables(scn, 3.0, True, cuda_device)
    before = GR.MEGA_LAUNCHES, GR.WALK_LAUNCHES
    got = GR.film_grid_mega((1, 0), scn, tab, 64, 64, 2, quirks=quirks,
                            device=cuda_device)
    torch.cuda.synchronize()
    plain = TG.film_trianglegrid((1, 0), scn, tab.grid, 64, 64, 2, 0, 2,
                                 quirks, device=cuda_device, plain=True)
    assert (GR.MEGA_LAUNCHES, GR.WALK_LAUNCHES) == (before[0] + 1, before[1])
    blocked = M.film_super_mega((1, 0), scn, 64, 64, 2, quirks=quirks,
                                device=cuda_device)
    assert got.shape == (64, 64, 3) and torch.isfinite(got).all()
    for want in (plain, blocked):
        ok, st = crn_ok(got, want, 2)
        assert ok, st
    st = GR.mega_grid_stats((1, 0), scn, tab, 64, 64, 2, quirks=quirks,
                            device=cuda_device)
    assert st["walks"] >= 64 * 64 * 2 and 0 < st["entered"] <= st["walks"]
    assert st["cells"] >= st["entered"] and st["pairs"] > 0


@pytest.mark.gpu
def test_dda_render_launches_mega_grid_once(cuda_device):
    """api.render("trianglegrid", accel="dda") inside the gate: exactly one
    B11 launch a render and nothing else; the grid is built once for the
    prepared scene."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    sheet = sheet_scene(30, 30)
    counts = lambda: (M.LAUNCHES, M.BLOCKED_LAUNCHES, B7.LAUNCHES,  # noqa
                      GR.MEGA_LAUNCHES, GR.WALK_LAUNCHES)
    c0 = counts()
    for _ in range(3):
        film = pt.render("trianglegrid", sheet, 48, 40, spp=2, seed=4,
                         accel="dda", device=cuda_device)
    torch.cuda.synchronize()
    assert counts() == c0[:3] + (c0[3] + 3, c0[4])
    assert film.shape == (40, 48, 3) and torch.isfinite(film).all()
    scn = prep_scene(sheet)
    assert GR.triangle_tables(scn, 3.0, True, cuda_device) is \
        GR.triangle_tables(scn, 3.0, True, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("accel", ["dda", "auto"])
def test_dda_past_the_gate_walks_with_b11w(accel, cuda_device):
    """A 9-light copy of the 1,800-triangle sheet (outside the super
    kernels' gate) renders the tier-1 DDA wavefront on the card, whose
    every walk is B11w (two launches a sample: the camera rays, then every
    light's shadow rays in one), no B11, B1, B2/B3 or B7; its film is the
    plain DDA film's bit for bit."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        trianglegrid as TG)
    base = sheet_scene(30, 30)
    nine = Scene(sphere_centers=base.sphere_centers,
                 square_kj=base.square_kj, triangles=base.triangles,
                 lights=np.tile(base.lights, (5, 1))[:9])
    scn = prep_scene(nine)
    assert TG.route(scn, 5, accel, cuda_device) == "wavefront"
    counts = lambda: (M.LAUNCHES, M.BLOCKED_LAUNCHES, B7.LAUNCHES,  # noqa
                      GR.MEGA_LAUNCHES, GR.WALK_LAUNCHES)
    c0 = counts()
    film = pt.render("trianglegrid", nine, 32, 24, spp=2, seed=6,
                     accel=accel, device=cuda_device)
    torch.cuda.synchronize()
    assert counts() == c0[:4] + (c0[4] + 4,)
    tab = GR.triangle_tables(scn, 3.0, True, cuda_device)
    plain = TG.film_trianglegrid(make_key(6), scn, tab.grid, 32, 24, 2, 0,
                                 2, DEFAULT, device=cuda_device, plain=True)
    assert torch.equal(film, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("row", [248, 480])
@pytest.mark.parametrize("qname", ["default", "reference_lmem"])
def test_mega_grid_band_bit_equal_to_the_dda_wavefront(qname, row,
                                                       cuda_device):
    """B11 on 8 rows of a 512x512 frame of the 1,800-triangle sheet
    (samples 0-1 of 4) against the DDA wavefront's band whose every walk
    is B11w: rows 248-255 see the sheet, whose shading is the same
    arithmetic on both sides, bit for bit; rows 480-487 see the floor and
    cast shadow rays, whose light sampling and shading the eager
    wavefront rounds differently, under the contract (as phase 10b holds
    whole frames); and on both bands == its counting launch's film (the
    lockstep walk that takes the tally), bit for bit."""
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        trianglegrid as TG)
    scn = prep_scene(sheet_scene(30, 30))
    quirks = QUIRKS[qname]
    tab = GR.triangle_tables(scn, 3.0, True, cuda_device)
    band = dict(row_offset=row, rows=8)
    got = GR.film_grid_mega((5, 0), scn, tab, 512, 512, 2, 0, 4, quirks,
                            device=cuda_device, **band)
    wave = TG.film_trianglegrid((5, 0), scn, tab.grid, 512, 512, 2, 0, 4,
                                quirks, device=cuda_device, **band)
    stats = torch.zeros(len(GR.STAT_NAMES), dtype=torch.int64,
                        device=cuda_device)
    counted = GR.film_grid_mega((5, 0), scn, tab, 512, 512, 2, 0, 4, quirks,
                                device=cuda_device, stats=stats, **band)
    assert got.shape == (8, 512, 3) and got.var() > 1e-5
    if row == 248:
        assert torch.equal(got, wave)
    else:
        ok, st = crn_ok(got, wave, 2)
        assert ok, st
    assert torch.equal(got, counted)


@pytest.mark.gpu
def test_grid_walk_takes_broadcast_inputs(cuda_device):
    """B11w with a Python-scalar t, a 0-d m, one-element normals and a 0-d
    needs (stride 0) == B11w with the columns materialised == the plain
    walk, bit for bit, on the 1,800-triangle sheet's camera rays; a
    strided view of t reads through its stride."""
    scn = prep_scene(sheet_scene(30, 30))
    grid, _ = GR.triangle_grid(scn, device=cuda_device)
    tab = GR.grid_tables(scn, grid, cuda_device)
    o, d, _ = grid_rays("sheet", "camera", scn, grid)
    o = torch.from_numpy(o).to(cuda_device)
    d = torch.from_numpy(d).to(cuda_device)
    n = o.shape[0]

    def dev(*a, **kw):
        return torch.tensor(*a, device=cuda_device, **kw)
    one = (1e9, dev(3, dtype=torch.int32), dev([0.0]), dev([0.0]),
           dev([1.0]), dev(True))
    full = (torch.full((n,), 1e9, device=cuda_device),
            torch.full((n,), 3, dtype=torch.int32, device=cuda_device),
            torch.zeros(n, device=cuda_device),
            torch.zeros(n, device=cuda_device),
            torch.ones(n, device=cuda_device),
            torch.ones(n, dtype=torch.bool, device=cuda_device))
    wide = torch.full((2 * n,), 1e9, device=cuda_device)[::2]
    before = GR.WALK_LAUNCHES
    a = GR.grid_walk(o, d, *one, tab, DEFAULT)
    b = GR.grid_walk(o, d, *full, tab, DEFAULT)
    c = GR.grid_walk(o, d, wide, *full[1:], tab, DEFAULT)
    torch.cuda.synchronize()
    assert GR.WALK_LAUNCHES == before + 3
    want = GR.traverse_triangles(o, d, *full, scn, grid, DEFAULT, plain=True)
    for x, y, z, w in zip(a, b, c, want):
        assert x.shape == (n,) and x.dtype == w.dtype
        if x.dtype == torch.float32:
            x, y, z, w = (v.view(torch.int32) for v in (x, y, z, w))
        assert torch.equal(x, w) and torch.equal(y, w) and torch.equal(z, w)
    assert int((b[1] == 4).sum()) > 0.05 * n


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["default", "reference_lmem"])
def test_grid_tallies_are_consistent(qname, cuda_device):
    """The counting launches' tallies (ops/grid.py::STAT_NAMES) hold
    together: B11 on rows 448-511 of a 512x512x2 frame of the
    1,800-triangle sheet (the floor shows there: shadow walks) - the lanes'
    camera and shadow cells sum to the visited cells, the empty cells are
    among them, lane cells <= 32 x warp steps and pairs <= 32 x pair
    iterations, a per-lane schedule pays no more warp steps than the
    lockstep and no fewer than its largest lane's, the clock split sums to
    the kernel's cycles; B11w on the sheet's camera rays: every walk a
    camera walk, the same bounds."""
    scn = prep_scene(sheet_scene(30, 30))
    tab = GR.triangle_tables(scn, 3.0, True, cuda_device)
    st = GR.mega_grid_stats((1, 0), scn, tab, 512, 512, 2,
                            quirks=QUIRKS[qname], row_offset=448, rows=64,
                            device=cuda_device)
    o, d, t = grid_rays("sheet", "camera", scn, tab.grid)
    m, nrm, needs = grid_state(len(o))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
            for a in (o, d, t, m, nrm[:, 0], nrm[:, 1], nrm[:, 2], needs)]
    stats = torch.zeros(len(GR.STAT_NAMES), dtype=torch.int64,
                        device=cuda_device)
    counted = GR.grid_walk(*args, tab, QUIRKS[qname], stats)
    plain = GR.grid_walk(*args, tab, QUIRKS[qname])
    for x, y in zip(counted, plain):
        assert torch.equal(x, y)
    wst = dict(zip(GR.STAT_NAMES, stats.tolist()))
    assert wst["walks"] == len(o) and wst["shadow_cells"] == 0
    assert wst["shadow_warp_steps"] == 0 and wst["sched_shadow"] == 0
    clocks = [k for k in GR.STAT_NAMES if k.startswith("clk_")
              and k != "clk_kernel"]
    for s in (st, wst):
        assert s["walks"] >= s["entered"] > 0 and s["pairs"] > 0
        assert s["cam_cells"] + s["shadow_cells"] == s["cells"]
        assert 0 < s["empty"] < s["cells"]
        assert s["cam_cells"] <= 32 * s["cam_warp_steps"]
        assert s["shadow_cells"] <= 32 * s["shadow_warp_steps"]
        assert s["pairs"] <= 32 * s["warp_pair_iters"]
        assert s["sched_all"] <= s["cam_warp_steps"] + s["shadow_warp_steps"]
        assert s["sched_all"] >= max(s["sched_cam"], s["sched_shadow"])
        assert s["sched_all"] * 32 >= s["cells"]
        assert sum(s[k] for k in clocks) == s["clk_kernel"] > 0
    assert st["walks"] > 512 * 64 * 2 and st["shadow_cells"] > 0


@pytest.mark.gpu
def test_mesh_past_the_gate_renders_the_tier1_route(cuda_device):
    """2^20 + 2048 triangles: outside the super kernels' gate, the film is
    the tier-1 wavefront on the card, whose traces are B7 - decided before
    any launch, no fallback."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.super import (
        cuda_route)
    scn = prep_scene(sheet_scene(1024, 513))
    assert scn.tri_v0.shape[0] > M.MAX_TRIANGLES
    assert cuda_route(scn) == "tier1"
    before = M.LAUNCHES, M.BLOCKED_LAUNCHES, B7.LAUNCHES
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    film = pt.render("super", scn, 32, 32, spp=1, seed=3,
                     device=cuda_device)
    torch.cuda.synchronize()
    assert (M.LAUNCHES, M.BLOCKED_LAUNCHES) == before[:2]
    assert B7.LAUNCHES > before[2]
    assert film.shape == (32, 32, 3) and torch.isfinite(film).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bounces", [None, 0, 1], ids=["5", "0", "1"])
@pytest.mark.parametrize("case", SIMPLE_CASES,
                         ids=[c[0] for c in SIMPLE_CASES])
def test_simple_kernel_matches_plain_on_gpu(case, bounces, cuda_device):
    """B5 == its plain version on the four cases, at the default 5 bounces
    and at max_bounces 0 and 1."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
        simple_arrays)
    _, seed, (w, h, spp), kw, qname = case
    if bounces is not None:
        kw = dict(kw, max_bounces=bounces)
    scn = simple_arrays()
    before = M5.LAUNCHES
    got = M5.film_simple_mega((seed, 0), scn, w, h, spp, quirks=QUIRKS[qname],
                              device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert M5.LAUNCHES == before + 1
    want = M5.film_simple_mega_plain((seed, 0), scn, w, h, spp,
                                     quirks=QUIRKS[qname],
                                     device=cuda_device, **kw)
    assert got.shape == want.shape == (kw.get("rows", h), w, 3)
    simple_close(got, want, spp)


@pytest.mark.gpu
def test_simple_kernel_bit_equal_at_five_bounces(cuda_device):
    """B5 at max_bounces 5 on a 256x256 frame (mirror chains included)
    equals its plain version bit for bit: the same float operations in the
    same order, none contracted, and a cull that never skips a hit."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
        simple_arrays)
    scn = simple_arrays()
    kw = dict(spp_total=8, device=cuda_device)
    got = M5.film_simple_mega((4, 0), scn, 256, 256, 2, max_bounces=5, **kw)
    want = M5.film_simple_mega_plain((4, 0), scn, 256, 256, 2,
                                     max_bounces=5, **kw)
    assert torch.equal(got, want)
    one = M5.film_simple_mega((4, 0), scn, 256, 256, 2, max_bounces=1, **kw)
    assert not torch.equal(one, got)           # some path bounces


@pytest.mark.gpu
def test_simple_render_on_gpu_launches_the_kernel(cuda_device):
    """api.render("simple") on a CUDA device is one launch of B5."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    before = M5.LAUNCHES, M.LAUNCHES
    film = pt.render("simple", None, 64, 64, spp=2, seed=1,
                     device=cuda_device)
    torch.cuda.synchronize()
    assert (M5.LAUNCHES, M.LAUNCHES) == (before[0] + 1, before[1])
    assert film.device.type == "cuda" and film.shape == (64, 64, 3)
    assert torch.isfinite(film).all()


@pytest.mark.gpu
def test_nodof_render_on_gpu_launches_the_super_kernel(cuda_device):
    """api.render("nodof") on a CUDA device is one launch of B1, whose
    image is within one step of the sample-buffer route's."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.models.sample_parallel \
        import render_sample_parallel
    scene = demo_scene()[0]
    before = M.LAUNCHES, M.BLOCKED_LAUNCHES, M5.LAUNCHES
    img = pt.render("nodof", scene, 64, 64, spp=16, seed=1,
                    device=cuda_device)
    torch.cuda.synchronize()
    assert (M.LAUNCHES, M.BLOCKED_LAUNCHES, M5.LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    assert img.dtype == np.uint8 and img.shape == (64, 64, 4)
    ref, _ = render_sample_parallel((1, 0), scene, 64, 64, 4,
                                    return_samples=True, device=cuda_device)
    d = np.abs(img.astype(np.int32) - ref.cpu().numpy().astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("structure", ["cell", "morton", "dense"])
def test_diag_dda_kernels_match_plain_on_gpu(structure, cuda_device):
    """B8-dda-closest and B8-dda-occ on a 1,800-triangle sheet at 128x128
    (8 tiles): the t and m maps and each light's occlusion map equal the
    plain version's bit for bit (the same float operations, no FMA); the
    three structures give the same t map."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K8
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_host as H8)
    size = 128
    scn = prep_scene(sheet_scene(30, 30))
    o, d = H8.primary_rays(size)
    boxes = {"cell": lambda: H8.cell_boxes(scn)[2],
             "morton": lambda: H8.morton_boxes(scn),
             "dense": lambda: H8.dense_boxes(scn)}[structure]()
    lists = (H8.dense_lists(len(boxes.start), size, size)
             if structure == "dense"
             else H8.tile_lists(o, d, boxes, size, size, device=cuda_device))
    ls, tb = K8.lists_on(lists, cuda_device), K8.table_on(boxes, cuda_device)
    before = K8.CLOSEST_LAUNCHES, K8.OCC_LAUNCHES
    t, m = K8.closest(ls, tb, size, size)
    torch.cuda.synchronize()
    pt_, pm = K8.closest_plain(ls, tb, size, size)
    assert torch.equal(t, pt_) and torch.equal(m, pm)
    assert float((m == 4).float().mean()) > 0.99     # the sheet fills it
    dense = H8.dense_boxes(scn)
    t_d, _ = K8.closest_plain(K8.lists_on(H8.dense_lists(
        len(dense.start), size, size), cuda_device),
        K8.table_on(dense, cuda_device), size, size)
    assert torch.equal(t, t_d)
    x = H8.hit_points(t.cpu().numpy(), m.cpu().numpy(), o, d)
    for light in np.asarray(scn.lights, np.float64):
        sd, dist = H8.shadow_rays(x, light)
        sl = (lists if structure == "dense" else H8.tile_lists(
            x, sd, boxes, size, size, tmax_cap=dist, sort_near=False,
            device=cuda_device))
        rays = [torch.from_numpy(a).to(cuda_device)
                for a in H8.shadow_inputs(x, sd, dist, size, size)]
        sl = K8.lists_on(sl, cuda_device)
        occ = K8.occluded(sl, tb, *rays)
        torch.cuda.synchronize()
        assert torch.equal(occ, K8.occluded_plain(sl, tb, *rays))
    assert (K8.CLOSEST_LAUNCHES, K8.OCC_LAUNCHES) == (
        before[0] + 1, before[1] + len(scn.lights))


def dda_sheet_inputs(size, device, n_major=30, n_minor=30):
    """A sheet's cell boxes and lists at size x size, the closest maps'
    hit points and light 0's shadow rays, lists and table (the B8-dda
    cases below)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K8
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_host as H8)
    scn = prep_scene(sheet_scene(n_major, n_minor))
    o, d = H8.primary_rays(size)
    cells = H8.cell_boxes(scn)[2]
    lists = H8.tile_lists(o, d, cells, size, size, device=device)
    t, m = K8.closest_plain(K8.lists_on(lists, device),
                            K8.table_on(cells, device), size, size)
    x = H8.hit_points(t.cpu().numpy(), m.cpu().numpy(), o, d)
    shadows = []
    for light in np.asarray(scn.lights, np.float64):
        sd, dist = H8.shadow_rays(x, light)
        shadows.append((K8.lists_on(H8.tile_lists(
            x, sd, cells, size, size, tmax_cap=dist, sort_near=False,
            device=device), device), [torch.from_numpy(a).to(device)
                                      for a in H8.shadow_inputs(
                                          x, sd, dist, size, size)]))
    return scn, cells, lists, shadows


def dda_equal_plain(lists, table, size, shadow_rays=()):
    """B8-dda-closest on (lists, table) and B8-dda-occ on each (lists,
    rays) of ``shadow_rays`` over ``table``, the tiles in index order and
    ranked (``ops/diag_dda.py::ranked``), each == its plain version bit
    for bit; returns the closest maps."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K8
    pt_, pm = K8.closest_plain(lists, table, size, size)
    for ls in (lists, K8.ranked(lists, table)):
        t, m = K8.closest(ls, table, size, size)
        torch.cuda.synchronize()
        assert torch.equal(t, pt_) and torch.equal(m, pm)
    for sl, rays in shadow_rays:
        plain = K8.occluded_plain(sl, table, *rays)
        for ls in (sl, K8.ranked(sl, table)):
            occ = K8.occluded(ls, table, *rays)
            torch.cuda.synchronize()
            assert torch.equal(occ, plain)
    return t, m


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["box past a stage", "empty lists",
                                  "mid-stage ends", "past a list chunk"])
def test_diag_dda_stage_edges_match_plain_on_gpu(case, cuda_device):
    """B8-dda's staging at its edges, on the 1,800-triangle sheet at
    128x128 (8 tiles), each map == plain bit for bit: one box of all 1,800
    rows (14 stages and 8 rows); the cell lists with every other tile's
    list emptied; 37-row boxes, so that every tile's rows end inside a
    stage; 600 boxes of 3 rows, a list of 600 entries (past the 256 a block
    holds at a time)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K8
    size = 128
    _, cells, lists, shadows = dda_sheet_inputs(size, cuda_device)
    table = K8.table_on(cells, cuda_device)
    n_tiles = (size // 64) * (size // 32)
    rows, nrows = table.rows, int(table.rows.shape[0])
    if case == "empty lists":
        lists = K8.lists_on(lists, cuda_device)
        keep = (torch.arange(n_tiles, device=cuda_device) % 2 == 0)
        lists = K8.Lists((lists.llen * keep).to(torch.int32), lists.ids)
        shadows = [(K8.Lists((sl.llen * keep).to(torch.int32), sl.ids), r)
                   for sl, r in shadows]
    else:
        per = {"box past a stage": nrows, "mid-stage ends": 37,
               "past a list chunk": 3}[case]
        start = torch.arange(0, nrows, per, dtype=torch.int32,
                             device=cuda_device)
        count = torch.clamp(nrows - start, max=per).to(torch.int32)
        table = K8.Table(rows, start, count)
        ids = torch.arange(start.shape[0], dtype=torch.int32,
                           device=cuda_device).expand(n_tiles, -1)
        lists = K8.Lists(torch.full((n_tiles,), start.shape[0],
                                    dtype=torch.int32, device=cuda_device),
                         ids.contiguous())
        shadows = [(lists, r) for _, r in shadows]
    t, m = dda_equal_plain(lists, table, size, shadows)
    if case != "empty lists":
        assert float((m == 4).float().mean()) > 0.99


@pytest.mark.gpu
def test_diag_dda_rays_occluded_by_their_first_row_on_gpu(cuda_device):
    """Every ray of every tile occluded by the first row of its list (a
    large triangle across all of them), the sheet's 1,800 rows after it:
    B8-dda-occ leaves the walk at its warps' first vote after that row
    (the vote is taken every second row), its map (all 1) == plain."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K8
    size = 128
    _, cells, _, _ = dda_sheet_inputs(size, cuda_device)
    n = size * size
    g = np.random.default_rng(3)
    o = np.zeros((size, size, 3), np.float32)
    o[..., :2] = g.uniform(-1, 1, (size, size, 2))
    dv = np.zeros((size, size, 3), np.float32)
    dv[..., 2] = 1.0
    tl = np.full((size, size), 10.0, np.float32)
    # the first row: v0 (-100, -100, 1), e0 (400, 0, 0), e2 (0, 400, 0),
    # the normal +z, index 0
    big = np.zeros((1, 16), np.float32)
    big[0, :12] = [-100, -100, 1, 400, 0, 0, 0, 400, 0, 0, 0, 1]
    rows = torch.from_numpy(np.concatenate([big, cells.rows])).to(
        cuda_device)
    table = K8.Table(rows, torch.tensor([0, 1], dtype=torch.int32,
                                        device=cuda_device),
                     torch.tensor([1, rows.shape[0] - 1], dtype=torch.int32,
                                  device=cuda_device))
    n_tiles = n // 2048
    lists = K8.Lists(torch.full((n_tiles,), 2, dtype=torch.int32,
                                device=cuda_device),
                     torch.tensor([[0, 1]] * n_tiles, dtype=torch.int32,
                                  device=cuda_device))
    rays = [torch.from_numpy(a).to(cuda_device) for a in (o, dv, tl)]
    occ = K8.occluded(lists, table, *rays)
    torch.cuda.synchronize()
    assert torch.equal(occ, K8.occluded_plain(lists, table, *rays))
    assert int(occ.sum()) == n
    st = K8.occluded_stats(lists, table, *rays)
    assert st["needed"] == n                 # one row a ray
    assert st["tested"] == 2 * n             # rows 0 and 1, then the vote


@pytest.mark.gpu
def test_diag_dda_20k_cell_lists_match_plain_on_gpu(cuda_device):
    """The smoke's size: the 20,736-triangle sheet's cell lists at 512x512
    (``tools/diag_dda.py``'s 20k scene), the closest maps and both
    lights' occlusion maps == plain bit for bit; the counting launch's
    tally counts every listed pair, and the occlusion call's needed pairs
    are the plain walk's."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K8
    size = 512
    _, cells, lists, shadows = dda_sheet_inputs(size, cuda_device, 144, 72)
    table = K8.table_on(cells, cuda_device)
    lists = K8.ranked(K8.lists_on(lists, cuda_device), table)
    t, m = dda_equal_plain(lists, table, size, shadows)
    assert float((m == 4).float().mean()) > 0.99
    st = K8.closest_stats(lists, table, size, size)
    listed = int(K8.tile_rows(lists, table).sum()) * 2048
    assert st["tested"] == st["needed"] == listed
    sl, rays = shadows[0]
    st = K8.occluded_stats(sl, table, *rays)
    assert st["needed"] == K8.needed_pairs(sl, table, *rays)
    assert st["needed"] <= st["tested"]


PRIM_ARMS = ["noop", "anycond", "scalarcond", "takelist"]
LOOP_ARMS = ["flat1", "flat4", "flat16", "flat64", "chunk32", "chunk128",
             "nested", "bcast", "reduce_full", "reduce_lane", "reduce_sub",
             "copy", "scalar"]


def prim_equal_plain(arm, x, nb, reps, flags):
    """One B8-prim launch against its plain version: out bit for bit and
    the count; returns the count."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_takelist as P8)
    before = P8.LAUNCHES
    out, cnt = P8.run(arm, x, nb, reps, flags)
    torch.cuda.synchronize()
    assert P8.LAUNCHES == before + 1
    p_out, p_cnt = P8.run_plain(arm, x, nb, reps, flags)
    assert torch.equal(out, p_out)
    assert int(cnt[0]) == int(p_cnt[0])
    return int(cnt[0])


@pytest.mark.gpu
@pytest.mark.parametrize("nb, reps", [(128, 3), (100, 2), (1000, 2),
                                      (4096, 2), (128, 0)])
@pytest.mark.parametrize("arm", PRIM_ARMS)
def test_diag_takelist_kernel_matches_plain_on_gpu(arm, nb, reps,
                                                   cuda_device):
    """B8-prim at NB = 128 (3 repetitions), at 100, 1,000 and 4,096 (the
    limit) fake blocks, and with no repetition: out bit-equal to the plain
    version; the take-list's count the flagged blocks (64 of 128), -1 with
    no repetition, 0 from the other arms."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_takelist as P8)
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_primitives as TP8)
    x, flags = TP8.inputs(cuda_device, nb)
    cnt = prim_equal_plain(arm, x, nb, reps, flags)
    if arm != "takelist":
        assert cnt == 0
    elif reps == 0:
        assert cnt == -1
    else:
        assert cnt == int(P8.flagged(x, nb).sum())
        assert nb != 128 or cnt == 64


@pytest.mark.gpu
@pytest.mark.parametrize("arm", PRIM_ARMS)
def test_diag_takelist_kernel_with_nan_in_the_tile(arm, cuda_device):
    """B8-prim on a tile with NaNs - scattered, and filling all 32
    elements one lane holds - is bit-equal to the plain version: a NaN
    flags no block (the lane's fmaxf drops it, as x > thr is false)."""
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_primitives as TP8)
    x, flags = TP8.inputs(cuda_device)
    x = x.clone().flatten()
    x[3::32] = float("nan")            # every element of lane 3
    x[[0, 70, 511, 1023]] = float("nan")
    x[100] = 1.5                      # one element flags every block
    cnt = prim_equal_plain(arm, x.reshape(8, 128), 128, 2, flags)
    assert cnt == (128 if arm == "takelist" else 0)


def loops_inputs(seed, device, low=0.0, high=1.0):
    """(x, acc0, table) of B8-loops, uniform in [low, high)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L8
    rng = np.random.RandomState(seed)
    x, acc0 = (torch.from_numpy(rng.uniform(low, high, (8, 128))
                                .astype(np.float32)).to(device)
               for _ in range(2))
    table = torch.from_numpy(rng.rand(*L8.TABLE_SHAPE).astype(np.float32)
                             ).to(device)
    return x, acc0, table


@pytest.mark.gpu
@pytest.mark.parametrize("trips", ["hundredth", (0, 0), (1, 0), (1, 1),
                                   (0, 5), (3, 0)], ids=str)
@pytest.mark.parametrize("arm", LOOP_ARMS)
def test_diag_loops_kernel_matches_plain_on_gpu(arm, trips, cuda_device):
    """B8-loops at 1/100 of the JAX tool's trip counts, and with no
    iteration, one and three (the nested arm also with an empty inner
    loop), from a random start and over a random table: bit-equal to the
    plain version; with no iteration, acc0 + x (x for copy and scalar)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L8
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_loops as TL8)
    x, acc0, table = loops_inputs(5, cuda_device)
    if trips == "hundredth":
        n1, n2 = TL8.COUNTS[arm]
        n1 = max(1, n1 // 100)
    else:
        n1, n2 = trips
    before = L8.LAUNCHES
    out = L8.run(arm, x, n1, n2, acc0, table)
    torch.cuda.synchronize()
    assert L8.LAUNCHES == before + 1
    assert torch.equal(out, L8.run_plain(arm, x, n1, n2, acc0, table))
    if n1 == 0 or (arm == "nested" and n2 == 0):
        start = 0.0 if arm in ("copy", "scalar") else acc0
        assert torch.equal(out, x + start)


@pytest.mark.gpu
@pytest.mark.parametrize("arm", LOOP_ARMS[:11])
def test_diag_loops_kernel_every_element_runs_its_own_chain(arm,
                                                            cuda_device):
    """B8-loops from a start drawn for each element in [-1000, 1000): the
    1,024 outputs are bit-equal to the plain version's and all distinct,
    so no element took another's chain under the kernel's layout (copy and
    scalar, which add one value to the tile, are left out)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L8
    x, acc0, table = loops_inputs(11, cuda_device, -1000.0, 1000.0)
    x = torch.zeros_like(x)
    n2 = 3 if arm == "nested" else 0
    out = L8.run(arm, x, 7, n2, acc0, table)
    torch.cuda.synchronize()
    assert torch.equal(out, L8.run_plain(arm, x, 7, n2, acc0, table))
    assert int(torch.unique(out).numel()) == 1024


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 37, 74, 111])
@pytest.mark.parametrize("arm", ["reduce_full", "reduce_lane", "reduce_sub"])
def test_diag_loops_reduce_max_shows_in_every_output(arm, shift,
                                                     cuda_device):
    """B8-loops' reduce arms on ``reduce_probe``'s tile, where each
    increment max * 1e-9 is thousands of ulps and every group's max is
    distinct: bit-equal to the plain version, and every background output
    names its own group's max, so the exchange across threads, lanes and
    warps read the right group whole (the shifts put the tile's max in
    each of the full reduce's warps and the rows' in each lane slot)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L8
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_loops as TL8)
    assert shift in TL8.PROBE_SHIFTS
    x, acc0 = (torch.from_numpy(a).to(cuda_device)
               for a in TL8.reduce_probe(shift))
    out = L8.run(arm, x, 64, 0, acc0)
    torch.cuda.synchronize()
    assert torch.equal(out, L8.run_plain(arm, x, 64, 0, acc0))
    assert TL8.probe_decodes(arm, out.cpu(), x.cpu(), acc0.cpu(), 64)


# spp windows (utils/checkpoint.py): each window a launch keyed on its own
# global samples; the windows' sum against the one-shot film
@pytest.mark.gpu
def test_super_kernel_windows_equal_one_shot(cuda_device):
    """B1 at 256x256x16 in windows of 4 (spp_offset 0, 4, 8, 12) against
    one launch of 16: the super family's contract."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.super import (
        render_super)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.checkpoint import (
        render_resumable)
    scene = demo_scene()[0]
    before = M.LAUNCHES
    ck = render_resumable(lambda *a, **kw: render_super(
        *a, device=cuda_device, **kw), (9, 0), scene, 256, 256, 16,
        spp_per_step=4, seed=9)
    assert M.LAUNCHES == before + 4
    one = render_super((9, 0), scene, 256, 256, spp=16, device=cuda_device)
    ok, st = crn_ok(ck.film, one, 16)
    assert ok, st


@pytest.mark.gpu
def test_simple_kernel_windows_equal_one_shot(cuda_device):
    """B5 at 256x256x8 in windows of 2 against one launch of 8."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
        render_simple)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.checkpoint import (
        render_resumable)
    before = M5.LAUNCHES
    ck = render_resumable(lambda k, _s, w, h, **kw: render_simple(
        k, w, h, device=cuda_device, **kw), (10, 0), None, 256, 256, 8,
        spp_per_step=2, seed=10)
    assert M5.LAUNCHES == before + 4
    one = render_simple((10, 0), 256, 256, spp=8, device=cuda_device)
    simple_close(ck.film, one.cpu().numpy(), 8)


@pytest.mark.gpu
def test_staged_vlp_render_equals_unstaged(cuda_device):
    """The CLI's --profile-stages --dynamic-grid-res pipeline (VLPs, box
    and grid built in earlier stages, handed to B4) renders the same film
    as render_metropolis(dynamic_grid_res=True), bit for bit."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        render_metropolis)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.cli import (
        _staged_vlp_render)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.profiling import (
        StageTimer)
    scene = demo_scene()[0]
    timer = StageTimer(cuda_device)
    before = M4.LAUNCHES
    staged, _ = _staged_vlp_render(timer, (11, 0), scene, 64, 64, 4,
                                   DEFAULT, "mlt", cuda_device, n_seed=64,
                                   rounds=2, use_grid=True, dynamic_res=True)
    assert M4.LAUNCHES == before + 1
    assert [st.name for st in timer.stages][-1] == "rendering"
    assert len(timer.stages) == 6
    one = render_metropolis((11, 0), scene, 64, 64, spp=4, n_seedpaths=64,
                            mutation_rounds=2, use_grid=True,
                            dynamic_grid_res=True, device=cuda_device)
    assert torch.equal(staged, one)


@pytest.mark.gpu
def test_super_kernel_holds_to_oracle(cuda_device):
    """B1 at 32x32x2 on the content band (rows 372+: floor and diffuse)
    against oracle_super in its CRN mode: tests/test_crn.py's contract."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.oracle_super import (
        render_oracle_super)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import ORACLE
    row = 372
    film = M.film_super_mega((5, 0), prep_scene(small_scene()), 32,
                             row + 32, 2, 0, 2, DEFAULT, row_offset=row,
                             rows=32, device=cuda_device)
    orc = render_oracle_super(small_scene(), 32, 32, spp=2, key=(5, 0),
                              row_offset=row)
    assert float(orc.var()) > 1e-2
    ok, st = crn_ok(film, orc, 2, ORACLE)
    assert ok, st


@pytest.mark.gpu
def test_vlp_kernel_holds_to_oracle(cuda_device):
    """B4 at 32x32x2 with a table live over the content band's floor
    against oracle_bpt.render_with_vlps on the same table."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.oracle_bpt import (
        render_with_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import ORACLE
    v = synth_vlps(seed=3)
    film = M4.film_vlp_mega((6, 0), prep_scene(small_scene()),
                            torch.from_numpy(v).to(cuda_device), 32,
                            CONTENT_ROW + 32, 2, 0, 2, DEFAULT,
                            row_offset=CONTENT_ROW, rows=32,
                            device=cuda_device)
    orc = render_with_vlps(small_scene(), v, 32, 32, spp=2, key=(6, 0),
                           row_offset=CONTENT_ROW)
    zero = render_with_vlps(small_scene(), 0 * v, 32, 32, spp=2, key=(6, 0),
                            row_offset=CONTENT_ROW)
    assert np.abs(orc - zero).max() > 1e-3        # the gather contributes
    ok, st = crn_ok(film, orc, 2, ORACLE)
    assert ok, st


@pytest.mark.gpu
def test_one_rank_nccl_sharded_super_equals_render_super(cuda_device):
    """The collective path on the card: one spawned rank in an NCCL group
    renders super through ``render_super_sharded`` (B1 for its window, a
    real all-reduce of one rank), bit for bit ``render_super``."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        validate_sharded as V)
    [[r]] = V.run_ranks(V.run_checks, 1, [("check_super", dict(
        spec=(1,), key=make_key(3), scene=demo_scene()[0], width=256,
        height=256, spp=16))], device="cuda", backend="nccl", timeout=300)
    assert r["ok"] and r["detail"] == "bit-equal", r["detail"]
    assert r["counts"]["mega_super"] == 1


# the light pass's cases (kernels L1, L2a, L2b against plain=True): the
# full run, a window, the reference's exact verify under REFERENCE_LMEM
# (negative t accepted) and the reused light direction
LIGHT_CASES = {
    "full": {},
    "window": dict(window=(70, 37)),
    "exact verify, REFERENCE_LMEM": dict(quirks=REFERENCE_LMEM,
                                         verify_eps=0.0),
    "reuse_light_direction": dict(quirks=Quirks(reuse_light_direction=True)),
}
LIGHT_N, LIGHT_ROUNDS = 128, 4


def light_counts():
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    return L.EMIT_LAUNCHES, L.SEED_LAUNCHES, L.CHAIN_LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(LIGHT_CASES))
@pytest.mark.parametrize("scene", ["demo", "dense"])
def test_light_pass_kernels_bit_equal_plain(scene, case, cuda_device):
    """L1, L2a and L2b each launch once and equal their plain versions bit
    for bit; a window equals the same rows of the full kernel run."""
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as TM)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    scn = prep_scene(demo_scene()[0] if scene == "demo"
                     else dense_vlp_scene())
    kw = LIGHT_CASES[case]
    q, eps = kw.get("quirks", DEFAULT), kw.get("verify_eps", 1e-3)
    w = kw.get("window")
    ew = {} if w is None else dict(gi0=w[0], count=w[1])
    cw = {} if w is None else dict(chain0=w[0], chains=w[1])
    key, n, rounds = (13, 0), LIGHT_N, LIGHT_ROUNDS
    c0 = light_counts()
    emitted = TV.emit_vlps(key, scn, n, q, device=cuda_device, **ew)
    seed = TM.mlt_seed(key, scn, n, q, device=cuda_device, **cw)
    table = TM.mlt_mutate_emit(key, scn, n, rounds, q, eps, seed,
                               device=cuda_device, **cw)
    torch.cuda.synchronize()
    assert light_counts() == tuple(c + 1 for c in c0)
    plain = dict(device=cuda_device, plain=True)
    assert torch.equal(emitted, TV.emit_vlps(key, scn, n, q, **ew, **plain))
    pv, pl = TM.mlt_seed(key, scn, n, q, **cw, **plain)
    assert torch.equal(seed[0], pv) and torch.equal(seed[1], pl)
    assert torch.equal(table, TM.mlt_mutate_emit(key, scn, n, rounds, q,
                                                 eps, seed, **cw, **plain))
    assert light_counts() == tuple(c + 1 for c in c0)
    if scene == "dense":
        assert int((table[:, 3] > 0).sum()) >= 16
    if w is not None:
        nl = int(scn.lights.shape[0])
        full = TV.emit_vlps(key, scn, n, q, device=cuda_device)
        rows = np.concatenate([np.arange(w[0], w[0] + w[1]) + n * blk
                               for blk in range(nl)])
        assert torch.equal(emitted, full[torch.from_numpy(rows)])
        full = TM.mlt_vlps(key, scn, n, rounds, q, eps, device=cuda_device)
        rows = np.concatenate([np.arange(w[0], w[0] + w[1]) + n * blk
                               for blk in range(nl * 4)])
        assert torch.equal(table, full[torch.from_numpy(rows)])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["bidirectional", "metropolis",
                                     "metropolis_vlpgrid"])
def test_vlp_render_launches_the_light_pass_kernels(variant, cuda_device):
    """A VLP render's passes are L1 (bidirectional) or L2a and L2b
    (metropolis*), then B4, once each; its film is film_vlp's on the plain
    light pass's table, bit for bit."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
        film_vlp)
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as TM)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    bpt = variant == "bidirectional"
    kw = (dict(n_vlp=64) if bpt
          else dict(n_seedpaths=16, mutation_rounds=2))
    c0 = light_counts() + (M4.LAUNCHES,)
    film = pt.render(variant, demo_scene()[0], 64, 64, spp=2, seed=1,
                     device=cuda_device, **kw)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(light_counts() + (M4.LAUNCHES,), c0))
    assert got == ((1, 0, 0, 1) if bpt else (0, 1, 1, 1))
    scn = prep_scene(demo_scene()[0])
    key, grid = (1, 0), None
    if bpt:
        vlps = TV.emit_vlps(key, scn, 64, device=cuda_device, plain=True)
    else:
        vlps = TM.mlt_vlps(key, scn, 16, 2, device=cuda_device, plain=True)
        if variant.endswith("vlpgrid"):
            grid = TV.build_vlp_grid(vlps, TV.vlp_grid_static_res(
                int(vlps.shape[0]), 3.0))
    want = film_vlp(key, scn, vlps, grid, 64, 64, 2, 0, 2, DEFAULT,
                    device=cuda_device)
    assert torch.equal(film, want)


@pytest.mark.gpu
def test_light_pass_reads_a_large_scene_in_place(cuda_device):
    """A 544-triangle sheet is past the kernels' shared-memory stage: L1,
    L2a and L2b read it in place from global memory, launch once each and
    equal their plain versions bit for bit (below 2,048 triangles both
    scan the triangles with the same det-scaled test), in a window too."""
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as TM)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    scn = prep_scene(sheet_scene(16, 17))
    assert scn.tri_v0.shape[0] == 544 > M.MAX_SMEM_TRIANGLES
    assert L.light_route(cuda_device) == "light_pass"
    key, plain = (2, 0), dict(device=cuda_device, plain=True)
    hits = None
    for w in ({}, dict(chain0=3, chains=5)):
        ew = {} if not w else dict(gi0=w["chain0"], count=w["chains"])
        c0 = light_counts()
        a = TV.emit_vlps(key, scn, 32, device=cuda_device, **ew)
        seed = TM.mlt_seed(key, scn, 8, device=cuda_device, **w)
        b = TM.mlt_mutate_emit(key, scn, 8, 2, seed_state=seed,
                               device=cuda_device, **w)
        torch.cuda.synchronize()
        assert light_counts() == tuple(c + 1 for c in c0)
        assert torch.equal(a, TV.emit_vlps(key, scn, 32, **ew, **plain))
        pv, pl = TM.mlt_seed(key, scn, 8, **w, **plain)
        assert torch.equal(seed[0], pv) and torch.equal(seed[1], pl)
        assert torch.equal(b, TM.mlt_mutate_emit(key, scn, 8, 2,
                                                 seed_state=seed, **w,
                                                 **plain))
        if hits is None:
            # the full run's rows that hit something (a triangle's VLP is
            # dead, its position kept) and chains with a vertex
            hits = (int((a.abs().sum(1) > 0).sum()),
                    int((seed[1] > 0).sum()))
    assert min(hits) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["default", "REFERENCE_LMEM, verify_eps 0"])
def test_light_pass_below_the_walk_bit_equal_plain(case, cuda_device):
    """An 1,800-triangle sheet (between the shared-memory stage's 512 and
    the culled walk's 2,048): the warp design's full scan, read in place,
    equals the plain light pass bit for bit, and its counting
    instantiation gives the same tables and tests every row of each
    trace."""
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as TM)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    from opencl_montecarlo_path_tracing_tpu_torch.ops.mega_super import (
        scene_buffer)
    scn = prep_scene(sheet_scene(30, 30))
    assert 512 < scn.tri_v0.shape[0] == 1800 < 2048
    assert L.triangle_route(scn) == "scan"
    q, eps = (DEFAULT, 1e-3) if case == "default" else (REFERENCE_LMEM, 0.0)
    key, n, rounds = (6, 0), 64, 3
    plain = dict(device=cuda_device, plain=True)
    c0 = light_counts()
    a = TV.emit_vlps(key, scn, n, q, device=cuda_device)
    seed = TM.mlt_seed(key, scn, n, q, device=cuda_device)
    b = TM.mlt_mutate_emit(key, scn, n, rounds, q, eps, seed,
                           device=cuda_device)
    torch.cuda.synchronize()
    assert light_counts() == tuple(c + 1 for c in c0)
    assert torch.equal(a, TV.emit_vlps(key, scn, n, q, **plain))
    pv, pl = TM.mlt_seed(key, scn, n, q, **plain)
    assert torch.equal(seed[0], pv) and torch.equal(seed[1], pl)
    assert torch.equal(b, TM.mlt_mutate_emit(key, scn, n, rounds, q, eps,
                                             seed, **plain))
    assert int((seed[1] > 0).sum()) > 0 and int((a.abs().sum(1) > 0).sum())
    st = [L.new_stats(cuda_device) for _ in range(3)]
    kw = dict(device=cuda_device)
    sd = L.mlt_seed(key, scn, n, q, stats=st[1], **kw)
    got = (L.emit(key, scn, n, q, stats=st[0], **kw), *sd,
           L.mlt_mutate_emit(key, scn, n, rounds, q, eps, seed, stats=st[2],
                             **kw))
    for x, y in zip(got, (a, *seed, b)):
        assert torch.equal(x, y)
    ntp = scene_buffer(scn, cuda_device)[1]     # the padded table's rows
    for tally in map(L.read_stats, st):
        assert tally["traces"] > 0
        assert tally["rows"] == tally["traces"] * ntp


@pytest.mark.gpu
def test_light_pass_culled_walk_equals_the_full_scan(cuda_device):
    """On the 20,736-triangle sheet (the culled walk's route) every trace
    of one light pass - L1, L2a and L2b, logged by the counting launch -
    gives the (t, triangle index) of the same kernel's full-scan
    instantiation (culled=False), and so the tables are equal; the walk
    tests a small share of the rows."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    scn = prep_scene(large_mesh_scene())
    nt = int(scn.tri_v0.shape[0])
    assert L.triangle_route(scn) == "walk" and nt == 20736
    key, n, rounds = (4, 0), 64, 3
    nl = int(scn.lights.shape[0])
    caps = (1, 4, 4 + 11 * rounds)
    runs = {}
    for culled in (True, False):
        logs = [(torch.full((nl * n, c), -1.0, device=cuda_device),
                 torch.full((nl * n, c), -2, dtype=torch.int32,
                            device=cuda_device)) for c in caps]
        st = [L.new_stats(cuda_device) for _ in caps]
        kw = dict(device=cuda_device, culled=culled)
        e = L.emit(key, scn, n, DEFAULT, stats=st[0], log=logs[0], **kw)
        sd = L.mlt_seed(key, scn, n, DEFAULT, stats=st[1], log=logs[1],
                        **kw)
        t = L.mlt_mutate_emit(key, scn, n, rounds, DEFAULT, 1e-3, sd,
                              stats=st[2], log=logs[2], **kw)
        runs[culled] = ((e, sd[0], sd[1], t), logs,
                        [L.read_stats(x) for x in st])
    (tw, lw, sw), (ts, ls, ss) = runs[True], runs[False]
    for (a_t, a_i), (b_t, b_i) in zip(lw, ls):
        assert torch.equal(a_i, b_i)
        assert torch.equal(a_t, b_t)
    for a, b in zip(tw, ts):
        assert torch.equal(a, b)
    hits = int((ls[2][1] >= 0).sum())
    assert hits > 50
    for w, f in zip(sw, ss):
        assert w["traces"] == f["traces"] > 0
        assert f["rows"] == f["traces"] * nt
        assert w["rows"] < 0.05 * f["rows"]
        assert w["node_tests"] > 0 and f["node_tests"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_vlpgrid_render_builds_only_the_grid_frame(dynamic, cuda_device,
                                                   monkeypatch):
    """On B4's route a metropolis_vlpgrid render builds only the grid's
    frame: it launches L2a, L2b and B4 once each and never the item-list
    build, and its film is bit-equal to the render pass over the fully
    built grid."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
        film_vlp)
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as TM)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as TG
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    builds, real = [], TG.build_grid_cellscan
    monkeypatch.setattr(TG, "build_grid_cellscan",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    scene = demo_scene()[0]
    c0 = light_counts() + (M4.LAUNCHES,)
    film = TM.render_metropolis(make_key(1), scene, 64, 64, spp=2,
                                n_seedpaths=16, mutation_rounds=2,
                                use_grid=True, dynamic_grid_res=dynamic,
                                device=cuda_device)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(light_counts() + (M4.LAUNCHES,), c0))
    assert got == (0, 1, 1, 1) and builds == []
    scn = prep_scene(scene)
    vlps = TM.mlt_vlps(make_key(1), scn, 16, 2, device=cuda_device)
    if dynamic:
        vmin, vmax = (b.cpu().numpy() for b in TV.vlp_bounds(vlps))
        res = TV.vlp_grid_dynamic_res(vmin, vmax, int(vlps.shape[0]))
    else:
        res = TV.vlp_grid_static_res(int(vlps.shape[0]))
    full = TV.build_vlp_grid(vlps, res)
    assert builds == [1]
    want = film_vlp(make_key(1), scn, vlps, full, 64, 64, 2, 0, 2, DEFAULT,
                    device=cuda_device)
    assert torch.equal(film, want)


# the light pass against the port's NumPy oracles (models/oracle_bpt.py::
# emit_vlps_oracle, models/oracle_mlt.py::mlt_vlps_oracle: the reference's
# kernels transcribed one ray or one chain at a time on the NumPy tracer of
# models/oracle_super.py, np.array_equal to the JAX package's oracles in
# tests/test_torch_oracles.py) on the same key and scene: work items and
# chains a light, rounds, and a window of both
ORACLE_N = {"demo": (512, 32), "dense": (128, 32)}
ORACLE_ROUNDS, ORACLE_WINDOW = 4, (5, 10)


def chain_match(tv, ov, n_chains, atol=1e-4):
    """tests/test_mlt_oracle.py::chain_match: the share of chains whose VLP
    rows (all lights x depths) agree."""
    tc = tv.reshape(-1, n_chains, 4)
    oc = ov.reshape(-1, n_chains, 4)
    ok = (np.abs(tc - oc) <= atol + 1e-4 * np.abs(oc)).all(axis=(0, 2))
    return ok.mean()


def hold_light_pass_to_oracles(device, scene_name, qname):
    """The light pass on ``device`` (kernels L1, L2a + L2b on a CUDA device,
    the plain version on the CPU) against the oracles, read back to the
    host.  Emitted table: the live mask equal and rtol = atol = 1e-5 (one
    trace a row; cos / sin / sqrt may differ by an ulp between float
    libraries), the JAX parity tolerance of tests/test_torch_bpt_mlt.py.
    Metropolis table: the oracle contract of tests/test_torch_oracles.py,
    a chain match >= 0.9 (a borderline verification may flip between two
    float implementations and fork that one chain).  Under the reference
    quirks (negative t accepted, the light direction reused) the chain
    verifies exactly (verify_eps 0).  Returns what was compared: the live
    rows and the max abs difference of the emitted table, the live rows
    and the chain match of the Metropolis table (full run, window)."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as TM, oracle_bpt as OB, oracle_mlt as OM)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    scene = demo_scene()[0] if scene_name == "demo" else dense_vlp_scene()
    scn = prep_scene(scene)
    q, eps = (DEFAULT, 1e-3) if qname == "default" else (REFERENCE, 0.0)
    key, (n_vlp, n_chain) = make_key(9), ORACLE_N[scene_name]
    g0, cnt = ORACLE_WINDOW
    nl = scene.n_lights

    def rows(n, blocks):
        return np.concatenate([np.arange(g0, g0 + cnt) + n * b
                               for b in range(blocks)])

    def host(t):
        return t.cpu().numpy()

    want = OB.emit_vlps_oracle(scene, n_vlp, None, q, key=key)
    assert (want[:, 3] > 0).sum() >= 3
    out = dict(emit_live=int((want[:, 3] > 0).sum()), emit_max_abs=0.0)
    for got, w in ((host(TV.emit_vlps(key, scn, n_vlp, q, device=device)),
                    want),
                   (host(TV.emit_vlps(key, scn, n_vlp, q, gi0=g0, count=cnt,
                                      device=device)),
                    want[rows(n_vlp, nl)])):
        assert got.shape == w.shape
        np.testing.assert_array_equal(got[:, 3] > 0, w[:, 3] > 0)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
        out["emit_max_abs"] = max(out["emit_max_abs"],
                                  float(np.abs(got - w).max()))

    want = OM.mlt_vlps_oracle(scene, key, n_chain, ORACLE_ROUNDS, q, eps)
    assert (want[:, 3] > 0).sum() >= 2
    got = host(TM.mlt_vlps(key, scn, n_chain, ORACLE_ROUNDS, q, eps,
                           device=device))
    assert got.shape == want.shape
    match = [chain_match(got, want, n_chain)]
    got = host(TM.mlt_vlps(key, scn, n_chain, ORACLE_ROUNDS, q, eps,
                           chain0=g0, chains=cnt, device=device))
    match.append(chain_match(got, want[rows(n_chain, 4 * nl)], cnt))
    assert min(match) >= 0.9, match
    return dict(out, mlt_live=int((want[:, 3] > 0).sum()),
                chain_match=tuple(float(m) for m in match))


@pytest.mark.gpu
@pytest.mark.parametrize("qname", ["default", "reference"])
@pytest.mark.parametrize("scene", ["demo", "dense"])
def test_light_pass_kernels_hold_to_the_oracles(scene, qname, cuda_device):
    """L1 and L2a + L2b on the card, read back to the host, against the
    NumPy oracles on the same key and scene (the tables every VLP render
    on the card is drawn from; tests/test_torch_light_pass.py holds the
    plain light pass on the CPU to the same oracles)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    c0 = light_counts()
    hold_light_pass_to_oracles(cuda_device, scene, qname)
    torch.cuda.synchronize()
    assert light_counts() == (c0[0] + 2, c0[1] + 2, c0[2] + 2)
    assert L.light_route(cuda_device) == "light_pass"


def test_file_imports_no_jax():
    """This file runs where only the port is installed: loading it imports
    neither JAX nor the JAX package."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('g', {__file__!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'opencl_montecarlo_path_tracing_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
