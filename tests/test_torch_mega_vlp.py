"""Kernel B4 (ops/mega_vlp.py): its plain version == the JAX VLP megakernel.

``film_vlp_mega_plain`` (plain PyTorch on the CPU) is held against the JAX
package's ``ops/pallas_bpt.py::film_vlp_mega(..., interpret=True)`` on the
cases of ``tests/test_megakernel.py:705-894``: a synthetic VLP table over
the content band, a Metropolis table with an spp window and a row band,
the grid-limited gather, and a grid that misses the shading points.  Each
VLP table (and grid) is made once and given to both sides (``convert.py``
carries the JAX grid across), so both gather the same table.

Tolerances, each with its reason:

* against the JAX kernel: the CRN contract of
  ``tools/validate_crn_frame.py`` (utils/crn.py: display-scale p99.5 <
  1e-5, ties > 1e-4 on < 0.6% of pixels).  XLA:CPU contracts the
  kernel's multiply-adds into FMAs; in the expanded distance
  |p|^2 - 2x.p + |x|^2 (|x|^2 ~ 6e3 on the content band) that moves single
  film values by up to ~1e-4, so a plain max-abs bound does not hold;
* against the same composition in the JAX package, ``film_bidirectional``
  with the precomputed table, evaluated op by op (``jax.disable_jit``, no
  contraction, like the port): ``ATOL_VLP = 6e-5``, the JAX package's own
  bound between the kernel (rsqrt) and the scan (division),
  ``tests/test_megakernel.py:665-668``.

The CUDA kernel runs only on a GPU: ``tests/test_torch_gpu.py`` holds it
against this plain version on the same cases (``gpu`` marker).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT as J_DEFAULT
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
    film_bidirectional)
from opencl_montecarlo_path_tracing_tpu.ops import grid as JG
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.ops import pallas_bpt as JB
from opencl_montecarlo_path_tracing_tpu.ops import vlp as JV
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    grid_from_numpy, key_from_jax, scene_arrays_from_numpy, vlps_from_numpy)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE, REFERENCE_LMEM)
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.ops.vlp import vlp_aabbs
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_torch_gpu import (CONTENT_ROW, VLP_CASES, mlt_table,
                                  small_scene, synth_vlps)

ATOL_VLP = 6e-5


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(key, scene arrays, vlps, JAX grid, (w, h, spp), window kwargs, JAX
    kernel film, JAX op-by-op composition film) of one case; the JAX side
    runs once per case."""
    seed, table, use_grid, shape, kw = VLP_CASES[name]
    jscn = JI.prep_scene(small_scene())
    key = make_key(seed)
    if table == "mlt":
        vlps = mlt_table(seed).numpy()
    else:
        vlps = synth_vlps(seed=table)
    grid = None
    if use_grid == "static":
        res = JV.vlp_grid_static_res(vlps.shape[0])
        grid = JV.build_vlp_grid(jnp.asarray(vlps), res)
        # the kernel's masked scan is uncapped: equal where no cell
        # overflows (pallas_bpt.py:34-38)
        assert np.asarray(grid.counts).max() < grid.items.shape[1]
    elif use_grid == "outside":
        # a tiny grid nowhere near the shading points
        amin, amax = (np.asarray(a) for a in vlp_aabbs(
            torch.from_numpy(vlps)))
        grid = JG.build_grid_cellscan(
            jnp.asarray(amin), jnp.asarray(amax),
            jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32), (2, 2, 2))
    w, h, spp = shape
    kernel = np.asarray(JB.film_vlp_mega(key, jscn, jnp.asarray(vlps), w, h,
                                         spp, quirks=J_DEFAULT,
                                         interpret=True, grid=grid, **kw))
    with jax.disable_jit():
        ieee = np.asarray(film_bidirectional(
            key, jscn, w, h, spp, kw.get("spp_offset", 0),
            kw.get("spp_total", spp), 8, J_DEFAULT,
            use_grid=grid is not None, precomputed_vlps=jnp.asarray(vlps),
            precomputed_grid=grid, row_offset=kw.get("row_offset", 0),
            rows=kw.get("rows")))
    return (key, scene_arrays_from_numpy(jscn), vlps, grid, shape, kw,
            kernel, ieee)


@pytest.mark.parametrize("name", list(VLP_CASES))
def test_plain_matches_jax_vlp_megakernel(name):
    key, scn, vlps, jgrid, (w, h, spp), kw, kernel, ieee = jax_case(name)
    grid = None if jgrid is None else grid_from_numpy(jgrid)
    got = M.film_vlp_mega_plain(key_from_jax(key), scn, vlps_from_numpy(vlps),
                                w, h, spp, quirks=DEFAULT, grid=grid,
                                device="cpu", **kw).numpy()
    assert got.shape == kernel.shape == ieee.shape == (kw.get("rows", h), w,
                                                       3)
    ok, st = crn_ok(got, kernel, spp)
    assert ok, st
    np.testing.assert_allclose(got, ieee, rtol=0, atol=ATOL_VLP)
    # the gather reaches the band: the film moves with the table, and a
    # grid that misses the band masks the whole table out
    outside = VLP_CASES[name][2] == "outside"
    other = M.film_vlp_mega_plain(
        key_from_jax(key), scn,
        vlps_from_numpy(vlps) * (1.0 if outside else 0.0), w, h, spp,
        quirks=DEFAULT, grid=None if outside else grid, device="cpu",
        **kw).numpy()
    assert np.abs(got - other).max() > 1e-3


def test_dead_rows_bit_identical():
    """Dead VLPs (I == 0) add exactly +0.0: the table with dead rows and the
    live rows alone give the same film, bit for bit."""
    scn = prep_scene(small_scene())
    vlps = synth_vlps(seed=3)
    live_only = vlps[vlps[:, 3] > 0]
    kw = dict(quirks=DEFAULT, row_offset=CONTENT_ROW, rows=8, device="cpu")
    a = M.film_vlp_mega((17, 0), scn, torch.from_numpy(vlps), 24,
                        CONTENT_ROW + 8, 2, **kw)
    b = M.film_vlp_mega((17, 0), scn, torch.from_numpy(live_only), 24,
                        CONTENT_ROW + 8, 2, **kw)
    assert a.abs().max() > 1e-3
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu():
    scn = prep_scene(small_scene())
    vlps = torch.from_numpy(synth_vlps(seed=4))
    before = M.LAUNCHES
    a = M.film_vlp_mega((9, 0), scn, vlps, 16, CONTENT_ROW + 4, 2,
                        row_offset=CONTENT_ROW, rows=4, device="cpu")
    b = M.film_vlp_mega_plain((9, 0), scn, vlps, 16, CONTENT_ROW + 4, 2,
                              row_offset=CONTENT_ROW, rows=4)
    assert M.LAUNCHES == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_vlp_table_layout():
    """Live rows first in their original order, (px, py, pz, max(I,0),
    |p|^2) padded to 8 floats; grid mode adds the clipped cell-index box
    exactly as pallas_bpt.py:376-391 and pads to 12."""
    vlps = synth_vlps(seed=6)
    live = vlps[:, 3] > 0
    tab, n_live, gridp = M.vlp_table(torch.from_numpy(vlps))
    assert gridp is None and tab.shape == (len(vlps), M.DENSE_STRIDE)
    assert int(n_live) == live.sum()
    order = np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)])
    v = vlps[order]
    t = tab.numpy()
    np.testing.assert_array_equal(t[:, :3], v[:, :3])
    np.testing.assert_array_equal(t[:, 3], np.maximum(v[:, 3], 0))
    np.testing.assert_array_equal(
        t[:, 4], v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    assert not t[:, 5:].any()
    res = JV.vlp_grid_static_res(len(vlps))
    jgrid = JV.build_vlp_grid(jnp.asarray(vlps), res)
    gtab, _, gridp = M.vlp_table(torch.from_numpy(vlps),
                                 grid_from_numpy(jgrid))
    assert gtab.shape == (len(vlps), M.GRID_STRIDE)
    np.testing.assert_array_equal(gtab[:, :5].numpy(), t[:, :5])
    r = 16.0 * np.sqrt(np.maximum(v[:, 3], 0)).astype(np.float32)
    far = np.float32(3e38)
    amin = np.where((v[:, 3] > 0)[:, None], v[:, :3] - r[:, None], far)
    vmin, cell = np.asarray(jgrid.vmin), np.asarray(jgrid.cell_size)
    clo = np.clip(np.floor((amin - vmin) / cell), 0.0,
                  np.float32(res[0]) - 1)
    np.testing.assert_array_equal(gtab[:, 5:8].numpy(), clo)
    np.testing.assert_array_equal(
        gridp.numpy(), np.concatenate([vmin, cell, np.float32(res)]))
    empty, n0, _ = M.vlp_table(torch.zeros((0, 4)))
    assert empty.shape == (1, M.DENSE_STRIDE) and int(n0) == 0


def _with(n_tri=None, n_lights=None):
    base = small_scene()
    g = np.random.default_rng(0)
    tri = base.triangles if n_tri is None else \
        g.uniform(0, 10, (n_tri, 3, 3)).astype(np.float32)
    lights = base.lights if n_lights is None else \
        np.tile(base.lights, (5, 1))[:n_lights]
    return prep_scene(Scene(sphere_centers=base.sphere_centers,
                            square_kj=base.square_kj, triangles=tri,
                            lights=lights))


def test_gate():
    """pallas_bpt.supported()'s cases (tests/test_megakernel.py:794-800)
    plus the triangle bound and max_bounces."""
    scn = prep_scene(small_scene())
    assert M.unsupported_reason(scn, DEFAULT) is None
    assert M.unsupported_reason(scn, REFERENCE) is None
    assert "shadow_carry_t" in M.unsupported_reason(scn, REFERENCE_LMEM)
    assert "lights" in M.unsupported_reason(_with(n_lights=9), DEFAULT)
    assert M.unsupported_reason(_with(n_lights=8), DEFAULT) is None
    assert M.unsupported_reason(_with(n_tri=512), DEFAULT) is None
    assert "triangles" in M.unsupported_reason(_with(n_tri=513), DEFAULT)
    assert "max_bounces" in M.unsupported_reason(scn, DEFAULT, 0)
    vlps = torch.from_numpy(synth_vlps())
    for s, q in ((scn, REFERENCE_LMEM), (_with(n_lights=9), DEFAULT)):
        with pytest.raises(NotImplementedError):
            M.film_vlp_mega((0, 0), s, vlps, 8, 8, 1, quirks=q,
                            device="cuda")
