"""Kernels B1-B7 and the B8 diagnostics on the card: each CUDA kernel ==
its plain PyTorch version, and each route launches the kernels it names.

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
same order on both sides).  B2/B3 forced onto B1's cases equals B1's film
at the same contract and at max abs 2e-5 where no tie shows.  For B7,
``t`` at rtol 2e-4 where both hit and the hit/miss and triangle index on
>= 99.9% of rays: the kernel sums the K=13 cancelling products in feature
order with no FMA, the plain version through cuBLAS in its own order (the
tolerance ``tests/test_mxu_triangles.py`` gives two such orders).  The B8
kernels (the grid cell-walk pair, the take-list primitives, the loop arms)
equal their plain versions bit for bit: the same float operations in the
same order, none contracted.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE, REFERENCE_LMEM)
from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G6
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_simple as M5
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M4
from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    demo_scene, ripple_sheet_mesh, torus_mesh)
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
    """bidirectional under REFERENCE_LMEM is outside B4's gate: the render
    runs the tier-1 wavefront on the card, whose gather is B6."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    b4, b6 = M4.LAUNCHES, G6.LAUNCHES
    film = pt.render("bidirectional", demo_scene()[0], 64, 64, spp=1,
                     seed=2, quirks=REFERENCE_LMEM, n_vlp=64,
                     device=cuda_device)
    torch.cuda.synchronize()
    assert M4.LAUNCHES == b4 and G6.LAUNCHES > b6
    assert film.shape == (64, 64, 3) and torch.isfinite(film).all()


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


# blocked_stats' "needed" on large_mesh_scene() (20,736 triangles) at
# 512x512x4, key (0, 0): the count the kernel printed before its node tree
# and sub-blocks (PERF.md §5), when its walk was the near-to-far macro
# walk; the counting launch now replays that walk block by block for this
# yardstick (a macro no lane passed held no block a lane passes)
NEEDED_20K_512x512x4 = 1036254336


@pytest.mark.gpu
def test_blocked_stats_needed_keeps_its_definition(cuda_device):
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    st = M.blocked_stats((0, 0), prep_scene(large_mesh_scene()), 512, 512,
                         4, device=cuda_device)
    assert st["needed"] == NEEDED_20K_512x512x4, st
    assert 0 < st["sub_needed"] <= st["tested"], st
    assert 0 < st["walk_cycles"] < st["kernel_cycles"], st


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
    accel launches it too and its DDA launches nothing and renders the
    same film under the contract; bidirectional on a 2048-triangle sheet
    (outside B4's gate) runs the tier-1 route with B7 and B6."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G
    sheet = sheet_scene(30, 30)
    counts = lambda: (M.LAUNCHES, M.BLOCKED_LAUNCHES, B7.LAUNCHES,  # noqa
                      M4.LAUNCHES, G.LAUNCHES)
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
    assert counts() == (c0[0], c0[1] + 1) + c0[2:]
    ok, st = crn_ok(auto, dda, 2)
    assert ok, st
    c0 = counts()
    film = pt.render("bidirectional", sheet_scene(32, 32), 64, 64, spp=1,
                     seed=2, n_vlp=64, device=cuda_device)
    torch.cuda.synchronize()
    c1 = counts()
    assert c1[:2] == c0[:2] and c1[3] == c0[3]
    assert c1[2] > c0[2] and c1[4] > c0[4]
    assert film.shape == (64, 64, 3) and torch.isfinite(film).all()


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


@pytest.mark.gpu
@pytest.mark.parametrize("arm", ["noop", "anycond", "scalarcond",
                                 "takelist"])
def test_diag_takelist_kernel_matches_plain_on_gpu(arm, cuda_device):
    """B8-prim at NB = 128, 3 repetitions: out bit-equal to the plain
    version, the take-list's count the 64 flagged blocks, 0 elsewhere."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_takelist as P8)
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_primitives as TP8)
    x, flags = TP8.inputs(cuda_device)
    before = P8.LAUNCHES
    out, cnt = P8.run(arm, x, P8.NB, 3, flags)
    torch.cuda.synchronize()
    assert P8.LAUNCHES == before + 1
    p_out, p_cnt = P8.run_plain(arm, x, P8.NB, 3, flags)
    assert torch.equal(out, p_out)
    assert int(cnt[0]) == int(p_cnt[0]) == (64 if arm == "takelist" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arm", ["flat1", "flat4", "flat16", "flat64",
                                 "chunk32", "chunk128", "nested", "bcast",
                                 "reduce_full", "reduce_lane", "reduce_sub",
                                 "copy", "scalar"])
def test_diag_loops_kernel_matches_plain_on_gpu(arm, cuda_device):
    """B8-loops at 1/100 of the JAX tool's trip counts, from a random
    start and over a random table: bit-equal to the plain version."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L8
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_loops as TL8)
    rng = np.random.RandomState(5)
    x, acc0 = (torch.from_numpy(rng.rand(8, 128).astype(np.float32))
               .to(cuda_device) for _ in range(2))
    table = torch.from_numpy(rng.rand(*L8.TABLE_SHAPE).astype(np.float32)
                             ).to(cuda_device)
    n1, n2 = TL8.COUNTS[arm]
    n1 = max(1, n1 // 100)
    before = L8.LAUNCHES
    out = L8.run(arm, x, n1, n2, acc0, table)
    torch.cuda.synchronize()
    assert L8.LAUNCHES == before + 1
    assert torch.equal(out, L8.run_plain(arm, x, n1, n2, acc0, table))


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
