"""Kernel B7's route (ops/tri_closest.py, ops/intersect.py) == the JAX
package's matmul triangle path.

On a 2048-triangle ripple sheet (``ripple_sheet_mesh(32, 32)``, the
smallest mesh that takes the route) with seeded rays aimed at it, the
port's ``triangle_closest_plain`` is held against the JAX
``ops/pallas_tri.py::triangle_closest`` (its Pallas kernel in interpret
mode, as the JAX package's own tests run it on the CPU), and the port's
``trace_ray`` / ``any_hit`` against the JAX ones.  Tolerances, each with
its reason:

* the weight tables (``prep_scene().tri_w``, ``_padded_weights``) are the
  same numpy arithmetic: equal bit for bit;
* ``t`` where both hit: rtol 2e-4 - the two sides sum the cancelling K=13
  products of the matmul in different orders (XLA's dot, torch's), the
  tolerance ``tests/test_mxu_triangles.py`` gives the scan-vs-matmul pair;
* hit/miss and the triangle index agree on >= 99.9% of rays (a razor-edge
  u/v test may flip in any two float implementations);
* traces: materials agree on all but <= 0.5% of rays, as in
  ``tests/test_torch_intersect.py``; where they agree, ``t`` at rtol 2e-4
  and the normals at rtol 2e-4 on all but 0.5% of rays (a ray through a
  shared mesh edge may take either neighbour at the same ``t``).

The CUDA kernel itself runs only on a GPU: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold it against the plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT as J_DEFAULT, REFERENCE as J_REFERENCE)
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.ops import pallas_tri as JT
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu_torch.core.camera import make_camera
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE)
from opencl_montecarlo_path_tracing_tpu_torch.ops import intersect as TI
from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import demo_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from tests.test_torch_gpu import sheet_scene

RTOL = 2e-4
AGREE = 0.999
FLIP_BUDGET = 0.005
N_RAYS = 4096
QUIRKS = {"default": (J_DEFAULT, DEFAULT), "reference": (J_REFERENCE,
                                                         REFERENCE)}


def j_scene(scene: Scene) -> JScene:
    return JScene(scene.sphere_centers, scene.square_kj, scene.triangles,
                  scene.lights)


def sheet_rays(scene: Scene, seed: int, n: int = N_RAYS):
    """Origins around the camera, each aimed at a random point of a random
    triangle (points past an edge included); every 8th ray turned away,
    so both hits and misses occur."""
    g = np.random.default_rng(seed)
    tris = scene.triangles.astype(np.float64)
    cam = np.asarray(make_camera(z_sign=-1.0).pos, np.float64)
    o = cam + g.normal(0.0, 3.0, (n, 3))
    bary = g.dirichlet((1.0, 1.0, 1.0), n) * 1.1 - 0.033
    p = (tris[g.integers(0, len(tris), n)] * bary[:, :, None]).sum(axis=1)
    d = p - o
    d[::8] = -d[::8]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_weights_match_jax():
    for scene in (demo_scene()[0], sheet_scene(8, 4)):
        mine = TI.prep_scene(scene)
        theirs = JI.prep_scene(j_scene(scene))
        assert mine.tri_w.shape == (13, 4 * scene.n_triangles)
        np.testing.assert_array_equal(mine.tri_w, theirs.tri_w)
        w, ntp = B7._padded_weights(mine)
        wj, ntpj = JT._padded_weights(theirs)
        assert ntp == ntpj and ntp % B7.TRI_CHUNK == 0
        np.testing.assert_array_equal(w, wj)


def test_scene_and_its_tables_are_prepared_once():
    """A Scene is prepared once; B7's weights, the light pass's block
    tables and B2/B3's exact grid are built once per prepared scene and
    device."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import exact_grid as X
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    scene = sheet_scene(8, 4)
    scn = TI.prep_scene(scene)
    assert TI.prep_scene(scene) is scn
    other = TI.prep_scene(dataclasses.replace(scene))
    assert other is not scn
    for a, b in zip(other, scn):
        np.testing.assert_array_equal(a, b)
    w = B7.weights_on(scn, "cpu")
    assert B7.weights_on(scn, "cpu") is w
    assert B7.weights_on(other, "cpu") is not w
    tables = M.block_tables(scn, "cpu")
    assert M.block_tables(scn, "cpu") is tables
    for a, b in zip(M.block_tables(other, "cpu"), tables):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    grid = X.exact_grid(scn, "cpu")
    assert X.exact_grid(scn, "cpu") is grid
    assert X.exact_grid(other, "cpu") is not grid


def test_weights_reproduce_quads():
    """features x weights == the direct Moller-Trumbore scalars (det,
    u*det, v*det, t*det) of the scan, to the cancellation's rounding."""
    scene = sheet_scene(4, 4)
    scn = TI.prep_scene(scene)
    o, d = sheet_rays(scene, seed=3, n=64)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    det, un, vn, tn = TI._mxu_quads(*ot.unbind(-1), *dt.unbind(-1), scn)
    for j, r in enumerate(TI._rows(TI._tri_table(scn))):
        dd, un_s, vn_s, tn_s = TI._mt_quads(*ot.unbind(-1), *dt.unbind(-1),
                                            r)
        sg = torch.where(det[:, j] >= 0, 1.0, -1.0)
        for a, b in ((det[:, j] * sg, dd), (un[:, j] * sg, un_s),
                     (vn[:, j] * sg, vn_s), (tn[:, j] * sg, tn_s)):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("quirks", ["default", "reference"])
def test_triangle_closest_plain_matches_jax(quirks):
    jq, tq = QUIRKS[quirks]
    scene = sheet_scene(32, 32)
    assert scene.n_triangles == 2048
    o, d = sheet_rays(scene, seed=5)
    jt, ji = JT.triangle_closest(o, d, JI.prep_scene(j_scene(scene)), jq)
    jt, ji = np.asarray(jt), np.asarray(ji)
    tt, ti = B7.triangle_closest_plain(torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       TI.prep_scene(scene), tq)
    tt, ti = tt.numpy(), ti.numpy()
    assert tt.shape == ti.shape == (N_RAYS,)
    hit_j, hit_t = np.isfinite(jt), np.isfinite(tt)
    assert hit_j.mean() > 0.5
    if quirks == "default":                   # reversed rays miss (t < 0)
        assert hit_j.mean() < 0.95
    assert (hit_j == hit_t).mean() >= AGREE
    both = hit_j & hit_t
    np.testing.assert_allclose(tt[both], jt[both], rtol=RTOL)
    assert (ti[both] == ji[both]).mean() >= AGREE
    assert ti.min() >= 0 and ti.max() < scene.n_triangles


def test_wrapper_takes_plain_version_on_cpu():
    scene = sheet_scene(32, 32)
    scn = TI.prep_scene(scene)
    o, d = (torch.from_numpy(a) for a in sheet_rays(scene, seed=6, n=256))
    before = B7.LAUNCHES
    a = B7.triangle_closest(o, d, scn, DEFAULT)
    b = B7.triangle_closest_plain(o, d, scn, DEFAULT)
    assert B7.LAUNCHES == before
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("quirks", ["default", "reference"])
def test_trace_ray_takes_b7_route_and_matches_jax(quirks, monkeypatch):
    jq, tq = QUIRKS[quirks]
    scene = sheet_scene(32, 32)
    o, d = sheet_rays(scene, seed=7)
    want = JI.trace_ray(o, d, JI.prep_scene(j_scene(scene)), quirks=jq,
                        sphere_material=3)
    calls = []
    plain = B7.triangle_closest_plain
    monkeypatch.setattr(B7, "triangle_closest_plain",
                        lambda *a: calls.append(1) or plain(*a))
    got = TI.trace_ray(torch.from_numpy(o), torch.from_numpy(d),
                       TI.prep_scene(scene), quirks=tq, sphere_material=3)
    assert calls == [1]                       # one B7 call per trace
    jm, tm = np.asarray(want.material), got.material.numpy()
    same = jm == tm
    assert (~same).mean() <= FLIP_BUDGET
    assert (tm == 4).mean() > 0.5             # the sheet is really hit
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same],
                               rtol=RTOL)
    # a ray through a shared edge may take either neighbour (same t)
    n_ok = np.isclose(got.normal.numpy(), np.asarray(want.normal),
                      rtol=RTOL, atol=1e-6).all(axis=-1)
    assert (~n_ok[same]).mean() <= FLIP_BUDGET


@pytest.mark.parametrize("with_limit", [False, True])
def test_any_hit_takes_b7_route_and_matches_jax(with_limit):
    scene = sheet_scene(32, 32)
    o, d = sheet_rays(scene, seed=8)
    g = np.random.default_rng(9)
    tl = (g.uniform(5.0, 200.0, N_RAYS).astype(np.float32) if with_limit
          else np.float32(1e9))
    want = np.asarray(JI.any_hit(o, d, JI.prep_scene(j_scene(scene)),
                                 t_limit=tl, quirks=J_DEFAULT))
    got = TI.any_hit(torch.from_numpy(o), torch.from_numpy(d),
                     TI.prep_scene(scene),
                     t_limit=torch.from_numpy(np.asarray(tl)),
                     quirks=DEFAULT).numpy()
    assert 0.05 < want.mean() < 0.99
    assert (got != want).mean() <= FLIP_BUDGET
