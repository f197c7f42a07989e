"""Kernels B1, B4 and B6 on the card: each CUDA kernel == its plain
PyTorch version.

These tests need a CUDA GPU (the kernels have no CPU mode); without one
they skip with a reason.  The file imports neither JAX nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

The B1 cases are those of ``tests/test_megakernel.py:37-135`` (shared with
``tests/test_torch_mega_super.py``), the B4 cases those of
``tests/test_megakernel.py:705-894`` (shared with
``tests/test_torch_mega_vlp.py``); those files hold the plain versions
against the JAX megakernels on the CPU.  Tolerances: for the films, the
per-family contract of ``tools/validate_crn_frame.py`` (utils/crn.py:
display-scale p99.5 < 1e-5 and razor-edge ties (> 1e-4) on < 0.6% of
pixels), since any two float implementations may flip a razor-edge tie;
for B6, rtol = atol = 1e-5 (the same FP32 formula, no FMA, summed in the
same order on both sides).
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE, REFERENCE_LMEM)
from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G6
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M4
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import demo_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok

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
