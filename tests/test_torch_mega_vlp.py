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

The gate: the port's differs from ``pallas_bpt.supported()`` only where
the film is provably the same - REFERENCE_LMEM (the plain films under it
and under REFERENCE are bit-equal, and the JAX package's op-by-op film
under it holds to ATOL_VLP) and meshes past 512 triangles (the walk route
over ``mega_super.block_tables``, whose cached tensors the wrapper
reuses).

The CUDA kernel runs only on a GPU: ``tests/test_torch_gpu.py`` holds it
against this plain version on the same cases and on the ripple sheets
(``gpu`` marker).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT as J_DEFAULT
from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    REFERENCE_LMEM as J_REFERENCE_LMEM)
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
from opencl_montecarlo_path_tracing_tpu_torch.models import (
    bidirectional as TB, metropolis as TM)
from opencl_montecarlo_path_tracing_tpu_torch.ops import exact_grid as XG
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as MS
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.ops.vlp import vlp_aabbs
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_torch_gpu import (CONTENT_ROW, VLP_CASES, mlt_table,
                                  sheet_scene, small_scene, synth_vlps)

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
    plus the triangle count and max_bounces.  The port's gate differs from
    the JAX one only where the film is provably the same: REFERENCE_LMEM
    passes (its one extra quirk, shadow_carry_t, is read by no VLP-family
    function: test_lmem_vlp_film_is_the_reference_film), and so does a
    mesh past 512 triangles (the walk route); more than 8 lights and
    max_bounces < 1 stay on tier 1."""
    scn = prep_scene(small_scene())
    assert M.unsupported_reason(scn, DEFAULT) is None
    assert M.unsupported_reason(scn, REFERENCE) is None
    assert M.unsupported_reason(scn, REFERENCE_LMEM) is None
    assert "lights" in M.unsupported_reason(_with(n_lights=9), DEFAULT)
    assert M.unsupported_reason(_with(n_lights=8), DEFAULT) is None
    assert M.unsupported_reason(_with(n_tri=512), DEFAULT) is None
    assert M.unsupported_reason(_with(n_tri=513), DEFAULT) is None
    assert not M.uses_walk(_with(n_tri=512))
    assert M.uses_walk(_with(n_tri=513))
    assert M.uses_walk(_with(n_tri=512), force_walk=True)
    assert not M.uses_walk(_with(n_tri=0), force_walk=True)
    assert "max_bounces" in M.unsupported_reason(scn, DEFAULT, 0)
    vlps = torch.from_numpy(synth_vlps())
    with pytest.raises(NotImplementedError):
        M.film_vlp_mega((0, 0), _with(n_lights=9), vlps, 8, 8, 1,
                        device="cuda")
    # inside the gate a CUDA request launches the kernel, never the CPU
    if torch.cuda.is_available():
        film = M.film_vlp_mega((0, 0), scn, vlps, 8, 8, 1,
                               quirks=REFERENCE_LMEM, device="cuda")
        assert film.shape == (8, 8, 3)
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            M.film_vlp_mega((0, 0), scn, vlps, 8, 8, 1,
                            quirks=REFERENCE_LMEM, device="cuda")


def test_walk_route_reads_the_cached_block_tables():
    """Past 512 triangles the wrapper's inputs are the scene without
    triangles and the very ``exact_grid.ExactGrid`` object that
    ``exact_grid.exact_grid`` caches (one host preparation per prepared
    scene and device), no block boxes; up to 512 the scene buffer and the
    32-row block boxes, no grid."""
    scn = prep_scene(sheet_scene(30, 30))
    inputs = M.kernel_inputs(scn, "cpu", walk=True)
    buf, ntp, boxes, xg = inputs
    assert ntp == 0 and boxes is None
    assert xg is XG.exact_grid(scn, "cpu")
    assert isinstance(xg, XG.ExactGrid)
    assert all(a is b for a, b in zip(M.kernel_inputs(scn, "cpu", True),
                                      inputs))
    assert buf.numel() == MS.pack_scene(scn, triangles=False)[0].size
    assert xg.rows.shape == (xg.ids.shape[0], 12)
    assert int(xg.span[:, 1].sum()) == xg.ids.shape[0]
    small = prep_scene(small_scene())
    buf, ntp, boxes, *tables = M.kernel_inputs(small, "cpu")
    assert buf is MS.scene_buffer(small, "cpu")[0] and ntp == 8
    assert boxes.shape == (2, 8) and tables == [None]


@pytest.mark.parametrize("variant,scene", [
    ("bidirectional", "demo"), ("metropolis", "demo"),
    ("bidirectional", "sheet_600")])
def test_lmem_vlp_film_is_the_reference_film(variant, scene):
    """Both passes of a VLP render in plain PyTorch under REFERENCE_LMEM
    give the film of REFERENCE, bit for bit: shadow_carry_t, the one quirk
    between them, is read only by the super family's direct light
    (models/super.py::illum_direct), never by the light pass, illum_vlp or
    any_hit.  On the demo scene and on a mesh past 512 triangles."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    scn = prep_scene(demo_scene()[0] if scene == "demo"
                     else sheet_scene(15, 20))
    kw = dict(row_offset=CONTENT_ROW, rows=4, device="cpu")

    def film(quirks):
        if variant == "bidirectional":
            return TB.film_bidirectional((9, 0), scn, 64, CONTENT_ROW + 4, 2,
                                         0, 2, 32, quirks, **kw)
        return TM.film_metropolis((9, 0), scn, 64, CONTENT_ROW + 4, 2, 0, 2,
                                  16, 2, quirks, **kw)

    a = film(REFERENCE)
    assert a.abs().max() > 1e-3
    assert torch.equal(a, film(REFERENCE_LMEM))


# (scene, seed, first row), both under REFERENCE_LMEM: the content band of
# small_scene, and a ripple sheet past 512 triangles (the walk route's
# meshes; below 2,048 both sides trace them with the plain scan; op by op
# the JAX side takes ~30 s at 600 triangles, ~70 s at 1,800)
PLAIN_CASES = {
    "content": (small_scene, 7, CONTENT_ROW),
    "sheet_600": (lambda: sheet_scene(15, 20), 3, 200),
}


@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_plain_film_matches_jax_op_by_op(name):
    """B4's plain version against the JAX package's film_bidirectional -
    the program render_bidirectional compiles - evaluated op by op
    (``jax.disable_jit``), on the same Metropolis table, at ATOL_VLP, under
    REFERENCE_LMEM (which the JAX gate sends to that composition): on the
    content band and on a sheet past 512 triangles."""
    make, seed, row = PLAIN_CASES[name]
    jscn = JI.prep_scene(make())
    vlps = mlt_table(seed).numpy()
    key = make_key(seed)
    w, rows, spp = 40, 8, 2
    with jax.disable_jit():
        want = np.asarray(film_bidirectional(
            key, jscn, w, row + rows, spp, 0, spp, 8, J_REFERENCE_LMEM,
            precomputed_vlps=jnp.asarray(vlps), row_offset=row, rows=rows))
    got = M.film_vlp_mega_plain(
        key_from_jax(key), scene_arrays_from_numpy(jscn),
        vlps_from_numpy(vlps), w, row + rows, spp, quirks=REFERENCE_LMEM,
        row_offset=row, rows=rows, device="cpu").numpy()
    assert got.shape == want.shape == (rows, w, 3)
    assert np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VLP)
