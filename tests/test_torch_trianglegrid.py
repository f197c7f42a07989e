"""The port's ``trianglegrid`` slice against the JAX package: the triangle
grid builds, the DDA walk, the render and the CLI.

Tolerances, each with its reason:

* grid builds (pairs and host), the resolution heuristic and the occupancy
  histogram are integer or numpy arithmetic on the same inputs: equal;
* the DDA walk on rays aimed at a torus: materials agree on all but 0.5%
  of rays and, where they agree, ``t`` and normals at rtol 1e-5 - the JAX
  walk runs compiled, where XLA:CPU contracts multiply-adds in the
  division-form Moller-Trumbore test; the port's DDA equals its own
  brute-force scan on hits as the JAX package's does
  (``tests/test_grid.py``, atol 1e-4);
* films: the common-random-number contract of
  ``tools/validate_crn_frame.py`` (utils/crn.py);
* CLI images: equal on >= 99.5% of pixels, as ``test_torch_slice.py``.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT as J_DEFAULT
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models import trianglegrid as JTG
from opencl_montecarlo_path_tracing_tpu.ops import grid as JG
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu.utils import pam as JP
import opencl_montecarlo_path_tracing_tpu_torch as tpt
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    grid_from_numpy, key_from_jax)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
from opencl_montecarlo_path_tracing_tpu_torch.models import trianglegrid as TG
from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
from opencl_montecarlo_path_tracing_tpu_torch.ops import intersect as TI
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    torus_mesh, write_scene_files)
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils import cli
from opencl_montecarlo_path_tracing_tpu_torch.utils import pam as TP
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_torch_gpu import sheet_scene, window_torus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
FLIP_BUDGET = 0.005


def torus_scene() -> Scene:
    """tests/test_grid.py::torus_scene."""
    return Scene(sphere_centers=np.zeros((0, 3), np.float32),
                 square_kj=np.zeros((0, 2), np.float32),
                 triangles=torus_mesh(n_major=10, n_minor=6),
                 lights=np.array([[10, 4, 10, 200], [15, 2, 7, 150]],
                                 np.float32))


def j_scene(scene: Scene) -> JScene:
    return JScene(scene.sphere_centers, scene.square_kj, scene.triangles,
                  scene.lights)


def aimed_rays(scene: Scene, seed: int, n: int = 512):
    """tests/test_grid.py's rays: from one point at random points of random
    triangles, plus the reversed rays (guaranteed misses)."""
    tris = np.asarray(scene.triangles, np.float64)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, tris.shape[0], n)
    bary = rng.dirichlet((1.0, 1.0, 1.0), n)
    pts = (tris[idx] * bary[:, :, None]).sum(axis=1)
    o = np.broadcast_to(np.array([17, 16, 8], np.float64), (n, 3))
    d = pts - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (np.concatenate([o, o]).astype(np.float32),
            np.concatenate([d, -d]).astype(np.float32))


@pytest.mark.parametrize("scene_fn", [torus_scene, lambda: sheet_scene(8, 8)],
                         ids=["torus", "sheet"])
@pytest.mark.parametrize("device_build", [True, False])
def test_triangle_grid_matches_jax(scene_fn, device_build):
    scene = scene_fn()
    tscn, jscn = TI.prep_scene(scene), JI.prep_scene(j_scene(scene))
    mine, box = G.triangle_grid(tscn, modifier=3.0,
                                device_build=device_build)
    theirs, jbox = JG.triangle_grid(jscn, modifier=3.0, device=device_build)
    assert mine.res == tuple(theirs.res)
    assert int(mine.counts.max()) > 1          # cells really share items
    np.testing.assert_array_equal(mine.items.numpy(),
                                  np.asarray(theirs.items))
    np.testing.assert_array_equal(mine.counts.numpy(),
                                  np.asarray(theirs.counts))
    np.testing.assert_array_equal(mine.vmin.numpy(), np.asarray(theirs.vmin))
    np.testing.assert_array_equal(mine.cell_size.numpy(),
                                  np.asarray(theirs.cell_size))
    for a, b in zip(box, jbox):
        np.testing.assert_array_equal(a, b)
    assert G.grid_stats(mine) == JG.grid_stats(theirs)


def test_resolution_and_occupancy_match_jax():
    for lo, hi, n in (([0, 0, 0], [4, 2, 1], 96), ([0, 0, 0], [1, 1, 1], 0),
                      ([-3, 1, 2], [40, 9, 7.5], 20736)):
        assert G.grid_resolution(lo, hi, n) == JG.grid_resolution(lo, hi, n)
    tris = torus_mesh(n_major=7, n_minor=5)
    amin, amax = tris.min(axis=1), tris.max(axis=1)
    vmin, vmax = amin.min(axis=0), amax.max(axis=0)
    res = G.grid_resolution(vmin, vmax, tris.shape[0])
    cell = ((vmax - vmin) / np.asarray(res, np.float32)).astype(np.float32)
    assert (G.max_cell_occupancy(amin, amax, vmin, cell, res)
            == JG.max_cell_occupancy(amin, amax, vmin, cell, res))


def test_cap_overflow_drops_extras():
    """100 identical boxes in one cell, cap 8: both builds keep the first
    8 item ids and count 8 (tests/test_grid.py)."""
    n = 100
    amin = np.zeros((n, 3), np.float32)
    amax = np.full((n, 3), 0.5, np.float32)
    args = (np.zeros(3, np.float32), np.ones(3, np.float32), (1, 1, 1))
    host = G.build_grid_host(amin, amax, *args, cap=8)
    pairs = G.build_grid_pairs(torch.from_numpy(amin), torch.from_numpy(amax),
                               *args, cap=8, max_span=(1, 1, 1))
    for g in (host, pairs):
        assert int(g.counts[0]) == 8
        np.testing.assert_array_equal(g.items[0].numpy(), np.arange(8))


def test_traverse_matches_jax_and_brute_force():
    scene = torus_scene()
    tscn, jscn = TI.prep_scene(scene), JI.prep_scene(j_scene(scene))
    o, d = aimed_rays(scene, seed=5)
    jgrid, _ = JG.triangle_grid(jscn, modifier=3.0, device=False)
    jgrid = jgrid._replace(items=jnp.asarray(jgrid.items),
                           counts=jnp.asarray(jgrid.counts),
                           vmin=jnp.asarray(jgrid.vmin),
                           cell_size=jnp.asarray(jgrid.cell_size))
    want = JI.trace_ray(o, d, jscn, quirks=J_DEFAULT, sphere_material=3,
                        tri_override=functools.partial(
                            JTG._override, scn=jscn, grid=jgrid,
                            quirks=J_DEFAULT))
    grid = grid_from_numpy(jgrid)              # the JAX cells, carried over
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = TI.trace_ray(ot, dt, tscn, quirks=DEFAULT, sphere_material=3,
                       tri_override=functools.partial(
                           TG._override, scn=tscn, grid=grid,
                           quirks=DEFAULT))
    jm, tm = np.asarray(want.material), got.material.numpy()
    same = jm == tm
    assert (tm == 4).sum() > 300 and (~same).mean() <= FLIP_BUDGET
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same],
                               rtol=RTOL)
    np.testing.assert_allclose(got.normal.numpy()[same],
                               np.asarray(want.normal)[same], rtol=RTOL,
                               atol=1e-6)
    brute = TI.trace_ray(ot, dt, tscn, quirks=DEFAULT, sphere_material=3)
    np.testing.assert_array_equal(got.material.numpy(),
                                  brute.material.numpy())
    np.testing.assert_allclose(got.t.numpy(), brute.t.numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("device_build", [True, False])
def test_render_dda_matches_jax(device_build):
    """The DDA render of a window where the torus is visible (rows 150+ of
    a 40-wide frame) against the JAX package's, which runs its DDA on the
    CPU."""
    scene = window_torus()
    key = make_key(23)
    want = np.asarray(JTG.render_trianglegrid(key, j_scene(scene), 40, 158,
                                              spp=2,
                                              device_build=device_build))
    got = TG.render_trianglegrid(key_from_jax(key), scene, 40, 158, spp=2,
                                 device_build=device_build, accel="dda",
                                 device="cpu")
    assert got.device.type == "cpu" and got.shape == (158, 40, 3)
    assert want[150:].var() > 1e-5
    ok, st = crn_ok(got.numpy(), want, 2)
    assert ok, st
    if device_build:                             # the CPU takes the DDA
        auto = tpt.render("trianglegrid", scene, 40, 158, spp=2, seed=23,
                          device="cpu")
        torch.testing.assert_close(auto, got, rtol=0, atol=0)


def test_render_rejects_unknown_accel():
    with pytest.raises(ValueError, match="accel"):
        TG.render_trianglegrid((0, 0), torus_scene(), 8, 8, spp=1,
                               accel="bvh", device="cpu")


def _run_cli(module, args, cwd):
    env = dict(os.environ)
    env["PT_PLATFORM"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_trianglegrid_matches_jax(tmp_path, monkeypatch, capsys):
    """``trianglegrid [w] [h] [CELL_SIZE_MODIFIER]`` with the mesh swapped
    in by ``--triangles-file`` (the reference's torus.txt idiom), on a
    frame that sees it."""
    scene_dir = tmp_path / "scene"
    write_scene_files(window_torus(), str(scene_dir))
    os.replace(scene_dir / "triangles.txt", scene_dir / "torus.txt")
    write_scene_files(Scene(np.zeros((0, 3), np.float32),
                            np.zeros((0, 2), np.float32),
                            torus_mesh(n_major=4, n_minor=3),
                            np.zeros((0, 4), np.float32)),
                      str(tmp_path / "decoy"))
    os.replace(tmp_path / "decoy" / "triangles.txt",
               scene_dir / "triangles.txt")
    args = ["trianglegrid", "40", "158", "2.0", "--spp", "2", "--seed", "3",
            "--scene-dir", str(scene_dir), "--triangles-file", "torus.txt"]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    monkeypatch.chdir(tmp_path / "t")
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Number of triangles: 120" in out
    assert "grid init + rendering" in out and "GB/s" in out
    rj = _run_cli("opencl_montecarlo_path_tracing_tpu", args,
                  str(tmp_path / "j"))
    assert rj.returncode == 0, rj.stderr
    t = TP.load_pam(str(tmp_path / "t" / "result.ppm"))
    j = JP.load_pam(str(tmp_path / "j" / "result.ppm"))
    assert (t.width, t.height, t.channels) == (40, 158, 4)
    assert np.asarray(j.data)[150:].std() > 0      # the torus is in frame
    agree = (np.asarray(t.data) == np.asarray(j.data)).all(axis=-1).mean()
    assert agree >= 0.995
