"""The grid cell-walk diagnostic (``tools/diag_host.py``, ``ops/diag_dda.py``,
``tools/diag_dda.py`` of the port) == the JAX package's
``tools/diag_dda_pallas.py``.

The JAX tool runs as it is, its Pallas kernels in interpret mode
(``PT_DIAG_INTERPRET=1``, read when a kernel is made).  Two scenes: the
demo scene's prepared tables, and the demo's spheres, squares and lights
with a 576-triangle ``ripple_sheet_mesh(24, 12)`` and a two-triangle
occluder that shadows part of the sheet from light 0, at 64x64 (2 tiles),
where every pixel hits a triangle (at 64x64 no demo pixel sees the
torus).
Tolerances, each with its reason:

* the host arrays - the cell rows, occupied cells, counts, cell boxes,
  primary rays, Morton boxes and rows, every tile list (primary and
  shadow) - are the same float64 arithmetic: equal;
* the port's plain closest maps against the JAX kernel: hit masks and m
  equal, t within rtol 1e-5 where both hit - XLA:CPU contracts
  multiply-adds into FMAs in the interpret-mode kernel, the port rounds
  each operation (measured: up to 4 ulp, 3.8e-7 relative, on 2,432 of the
  4,096 pixels), and the port sends an exact cross-multiplied tie to the
  lowest triangle index where the JAX kernel keeps the first tested;
* the occlusion maps agree on >= 99.9% of pixels (a razor-edge test may
  flip under the FMAs; measured: every pixel agrees, 38% of the frame in
  light 0's shadow);
* within the port, the cell, Morton and dense t maps are equal bit for
  bit (the same triangle with the same arithmetic, ties to the lowest
  index), and so are the cell and Morton occlusion maps.

The CUDA kernels run only on a GPU: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold them against these plain versions.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.ops import pallas_super as JM
from opencl_montecarlo_path_tracing_tpu.ops.intersect import (
    prep_scene as j_prep_scene)
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import demo_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.tools import diag_dda as T
from opencl_montecarlo_path_tracing_tpu_torch.tools import diag_host as H
from tests.test_torch_gpu import sheet_scene
from tools import diag_dda_pallas as JD
from tools.diag_blocked_host import primary_rays as j_primary_rays

SIZE = 64
RTOL = 1e-5
OCC_AGREE = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_thread_warm_sqrt():
    """One torch thread: the tensors here are small, and test workers that
    share a host's cores slow each other down many times over when each
    spins a full thread pool.  And a first torch.sqrt call in a process
    has been seen to return one 2,048-element segment off by ~2e-4
    relative (torch 2.13.0+cpu on an AVX-512 CPU, in 3 of 16 fresh
    processes; never on a later call): take the first call here, so that
    the camera rays below are not it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.sqrt(torch.rand(16384) * 400.0)
    yield
    torch.set_num_threads(threads)


def shadowed_sheet() -> Scene:
    """The 576-triangle sheet plus a two-triangle occluder halfway from the
    64x64 frame's hit points to light 0, whose shadow covers part of the
    frame (the sheet alone shadows none of it)."""
    scene = sheet_scene(24, 12)
    dense = H.dense_boxes(prep_scene(scene))
    t, _ = K.closest_plain(K.lists_on(H.dense_lists(
        len(dense.start), SIZE, SIZE), "cpu"), K.table_on(dense, "cpu"),
        SIZE, SIZE)
    o, d = H.primary_rays(SIZE)
    x = o + d * t.numpy().astype(np.float64).ravel()[:, None]
    centre = x.mean(axis=0)
    light = scene.lights[0, :3].astype(np.float64) + [0.5, 0.5, 0.0]
    n = (light - centre) / np.linalg.norm(light - centre)
    u = np.cross(n, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    s = 0.25 * np.abs(x - centre).max()
    c = 0.5 * (centre + light)
    q = [c - s * u - s * v, c + s * u - s * v, c + s * u + s * v,
         c - s * u + s * v]
    occluder = np.array([[q[0], q[1], q[2]], [q[0], q[2], q[3]]])
    return Scene(sphere_centers=scene.sphere_centers,
                 square_kj=scene.square_kj,
                 triangles=np.concatenate([scene.triangles, occluder])
                 .astype(np.float32), lights=scene.lights)


def _scenes():
    return {"demo": demo_scene()[0], "sheet": shadowed_sheet()}


def _j(scene) -> JScene:
    return JScene(scene.sphere_centers, scene.square_kj, scene.triangles,
                  scene.lights)


@pytest.fixture(scope="module")
def host():
    """Per scene: the JAX tool's host arrays and the port's."""
    out = {}
    for name, scene in _scenes().items():
        jscn, scn = j_prep_scene(_j(scene)), prep_scene(scene)
        jgrid, rowsT, occ, cnts, blo, bhi = JD.build_tables(jscn)
        tblT, baabbs, _ = JM._tri_blocks(jscn)
        real = np.isfinite(baabbs).all(axis=1)
        mb_lo = np.where(real[:, None], baabbs[:, :3], 1e30)
        mb_hi = np.where(real[:, None], baabbs[:, 3:], -1e30)
        o, d = j_primary_rays(SIZE)
        grid, p_occ, cells = H.cell_boxes(scn)
        out[name] = dict(
            jscn=jscn, scn=scn, rowsT=rowsT, occ=occ, cnts=cnts, blo=blo,
            bhi=bhi, tblT=tblT, mb_lo=mb_lo, mb_hi=mb_hi, o=o, d=d,
            p_occ=p_occ, cells=cells, morton=H.morton_boxes(scn),
            j_cell=JD.tile_lists(o, d, blo, bhi, SIZE, SIZE),
            j_mort=JD.tile_lists(o, d, mb_lo, mb_hi, SIZE, SIZE))
    return out


def _same_lists(p: H.TileLists, j) -> None:
    llen, ids, lens = j
    np.testing.assert_array_equal(p.llen, llen[:, 0])
    np.testing.assert_array_equal(p.llen, np.asarray(lens))
    np.testing.assert_array_equal(p.ids, ids)


@pytest.mark.parametrize("name", ["demo", "sheet"])
def test_host_arrays_equal_jax(host, name):
    h = host[name]
    po, pd = H.primary_rays(SIZE)
    np.testing.assert_array_equal(po, h["o"])
    np.testing.assert_array_equal(pd, h["d"])
    cells = h["cells"]
    np.testing.assert_array_equal(h["p_occ"], h["occ"])
    np.testing.assert_array_equal(cells.count, h["cnts"])
    np.testing.assert_array_equal(cells.lo, h["blo"])
    np.testing.assert_array_equal(cells.hi, h["bhi"])
    for p, (s, n) in enumerate(zip(cells.start, cells.count)):
        np.testing.assert_array_equal(cells.rows[s:s + n, :12],
                                      h["rowsT"][:12, p * 128:p * 128 + n].T)
    mort = h["morton"]
    np.testing.assert_array_equal(mort.lo, h["mb_lo"])
    np.testing.assert_array_equal(mort.hi, h["mb_hi"])
    np.testing.assert_array_equal(mort.rows[:, :12], h["tblT"][:12].T)
    np.testing.assert_array_equal(mort.rows[:, 12], h["tblT"][12])
    _same_lists(H.tile_lists(h["o"], h["d"], cells, SIZE, SIZE), h["j_cell"])
    _same_lists(H.tile_lists(h["o"], h["d"], mort, SIZE, SIZE), h["j_mort"])


@pytest.fixture(scope="module")
def sheet_jax(host):
    """The JAX kernels' maps on the sheet (interpret mode): closest over
    cells and Morton blocks, then each light's occlusion from the Morton
    hit points over both."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PT_DIAG_INTERPRET", "1")
    try:
        h = host["sheet"]
        llen, ids, _ = h["j_cell"]
        out_l = np.asarray(JD.make_pallas_fn(
            llen, ids, h["cnts"][ids].astype(np.int32), h["rowsT"], SIZE,
            SIZE)())
        llen_m, ids_m, _ = h["j_mort"]
        out_m = np.asarray(JD.make_pallas_fn(
            llen_m, ids_m, np.full(ids_m.shape, 128, np.int32),
            h["tblT"][:16], SIZE, SIZE)())

        def maps(out):
            t = JD.reassemble(out, SIZE, SIZE)
            m = JD.reassemble(out.reshape(-1, 2 * JM._SUB, 128)[:, JM._SUB:]
                              .reshape(-1, 128), SIZE, SIZE, rows_per_tile=1)
            return t, m

        t_m, m_m = maps(out_m)
        lights = np.asarray(h["jscn"].lights, np.float64)
        occ = {"cell": [], "morton": []}
        for lx, ly, lz, _ in lights:
            # JD.shadow_arm's inputs, one kernel call each (it times 4)
            x = h["o"] + h["d"] * t_m.ravel()[:, None]
            x[~((m_m == 4) & (t_m < 1e30)).ravel()] = np.nan
            seg = np.array([lx + 0.5, ly + 0.5, lz])[None] - x
            dist = np.linalg.norm(seg, axis=1)
            with np.errstate(invalid="ignore"):
                sd = seg / dist[:, None]
            packed = [np.stack([JD.tile_pack(SIZE, SIZE, a[:, c].reshape(
                SIZE, SIZE)).reshape(-1, JM._SUB, 128) for c in range(3)],
                axis=1).reshape(-1, 128).astype(np.float32)
                for a in (np.nan_to_num(x, nan=1e9),
                          np.nan_to_num(sd, nan=1.0))]
            tl = JD.tile_pack(SIZE, SIZE, np.nan_to_num(dist, nan=-1.0)
                              .reshape(SIZE, SIZE)).astype(np.float32)
            for tag, table, lo, hi in (
                    ("cell", h["rowsT"], h["blo"], h["bhi"]),
                    ("morton", h["tblT"][:16], h["mb_lo"], h["mb_hi"])):
                llen, ids, _ = JD._lists_from_boxes(
                    x, sd, lo, hi, SIZE, SIZE, tmax_cap=dist,
                    sort_near=False)
                cnt = (h["cnts"][ids].astype(np.int32) if tag == "cell"
                       else np.full(ids.shape, 128, np.int32))
                out = np.asarray(JD.make_occ_fn(
                    llen, ids, cnt, table.astype(np.float32), *packed, tl,
                    SIZE, SIZE)())
                occ[tag].append(JD.reassemble(out, SIZE, SIZE,
                                              rows_per_tile=1))
        return {"cell": maps(out_l), "morton": (t_m, m_m), "occ": occ,
                "lights": lights}
    finally:
        mp.undo()


def _plain_closest(h, boxes):
    lists = H.tile_lists(h["o"], h["d"], boxes, SIZE, SIZE)
    t, m = K.closest_plain(K.lists_on(lists, "cpu"), K.table_on(boxes, "cpu"),
                           SIZE, SIZE)
    return t.numpy(), m.numpy()


@pytest.mark.parametrize("structure", ["cell", "morton"])
def test_closest_plain_matches_jax_kernel(host, sheet_jax, structure):
    h = host["sheet"]
    t, m = _plain_closest(h, h["cells"] if structure == "cell"
                          else h["morton"])
    jt, jm = sheet_jax[structure]
    hit = jt < 1e30
    assert hit.all()            # every pixel of the 64x64 frame hits
    np.testing.assert_array_equal(t < 1e30, hit)
    np.testing.assert_array_equal(m, jm.astype(np.int32))
    np.testing.assert_allclose(t[hit], jt[hit], rtol=RTOL, atol=0)


def test_shadow_lists_and_occlusion_match_jax(host, sheet_jax):
    h = host["sheet"]
    jt, jm = sheet_jax["morton"]
    x = H.hit_points(jt, jm, h["o"], h["d"])
    for li, light in enumerate(sheet_jax["lights"]):
        sd, dist = H.shadow_rays(x, light)
        for tag, boxes, lo, hi in (("cell", h["cells"], h["blo"], h["bhi"]),
                                   ("morton", h["morton"], h["mb_lo"],
                                    h["mb_hi"])):
            lists = H.tile_lists(x, sd, boxes, SIZE, SIZE, tmax_cap=dist,
                                 sort_near=False)
            _same_lists(lists, JD._lists_from_boxes(
                x, sd, lo, hi, SIZE, SIZE, tmax_cap=dist, sort_near=False))
            rays = [torch.from_numpy(a)
                    for a in H.shadow_inputs(x, sd, dist, SIZE, SIZE)]
            occ = K.occluded_plain(K.lists_on(lists, "cpu"),
                                   K.table_on(boxes, "cpu"), *rays).numpy()
            j_occ = sheet_jax["occ"][tag][li] != 0
            if li == 0:
                assert 0.05 < j_occ.mean() < 0.95    # not vacuous
            assert ((occ != 0) == j_occ).mean() >= OCC_AGREE


def test_plain_structures_bit_equal(host):
    h = host["sheet"]
    scn = h["scn"]
    t_c, m_c = _plain_closest(h, h["cells"])
    t_m, m_m = _plain_closest(h, h["morton"])
    dense = H.dense_boxes(scn)
    t_d, m_d = (v.numpy() for v in K.closest_plain(
        K.lists_on(H.dense_lists(len(dense.start), SIZE, SIZE), "cpu"),
        K.table_on(dense, "cpu"), SIZE, SIZE))
    for t, m in ((t_m, m_m), (t_d, m_d)):
        np.testing.assert_array_equal(t, t_c)
        np.testing.assert_array_equal(m, m_c)
    x = H.hit_points(t_m, m_m, h["o"], h["d"])
    for light in np.asarray(scn.lights, np.float64):
        sd, dist = H.shadow_rays(x, light)
        rays = [torch.from_numpy(a)
                for a in H.shadow_inputs(x, sd, dist, SIZE, SIZE)]
        occ = [K.occluded_plain(K.lists_on(H.tile_lists(
            x, sd, b, SIZE, SIZE, tmax_cap=dist, sort_near=False), "cpu"),
            K.table_on(b, "cpu"), *rays).numpy()
            for b in (h["cells"], h["morton"])]
        np.testing.assert_array_equal(occ[0], occ[1])


def test_wrapper_on_cpu_is_the_plain_version(host):
    h = host["sheet"]
    lists = K.lists_on(H.tile_lists(h["o"], h["d"], h["cells"], SIZE, SIZE),
                       "cpu")
    table = K.table_on(h["cells"], "cpu")
    before = K.CLOSEST_LAUNCHES
    a = K.closest(lists, table, SIZE, SIZE)
    b = K.closest_plain(lists, table, SIZE, SIZE)
    assert K.CLOSEST_LAUNCHES == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="whole number"):
        K.closest(lists, table, SIZE + 1, SIZE)


def test_tool_runs_on_cpu(capsys):
    """The tool's main path on the CPU: every arm, the checks, the dense
    scan and the per-lane DDA, on the sheet at 64x64."""
    T.SHEETS["tiny"] = (24, 12)
    try:
        res = T.run_scene("tiny", SIZE, "cpu")
    finally:
        del T.SHEETS["tiny"]
    out = capsys.readouterr().out
    assert "miss masks equal: True" in out and "occ L1 equal: True" in out
    t_c = res["closest"]["cell"].out[0]
    for arm in ("morton", "dense"):
        assert torch.equal(res["closest"][arm].out[0], t_c)
    assert res["dda_ms"] is not None and "per-lane DDA vs morton" in out
