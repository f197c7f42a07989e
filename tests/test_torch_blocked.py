"""Kernels B2/B3 (ops/mega_super.py + ops/tri_blocks.py): host tables and
plain film against the JAX package's blocked and stream tiers.

* ``tri_blocks._tri_blocks`` == the JAX ``pallas_super._tri_blocks``
  bit for bit, NaN padding boxes included, on sheets whose block count is
  not a multiple of the macro size; ``large_mesh_scene()`` == the JAX one;
* ``walk_tables`` - what ``csrc/mega_blocked.cu`` walks - holds every
  triangle exactly once with its original index, live blocks only, boxes
  that contain their triangles, and macros (the node tree's leaves) that
  contain their boxes (its sub-blocks and node tree:
  ``tests/test_torch_culls.py``);
* the port's plain film (``film_super_mega_plain``) against the JAX
  ``film_super_mega(interpret=True, force_blocked=True)`` and
  ``force_stream=True`` on the sizes of ``tests/test_megakernel.py:142-177``
  and on a window where a mesh is visible, under the common-random-number
  contract of ``tools/validate_crn_frame.py`` (utils/crn.py) - the JAX
  tiers scan Morton blocks with an original-index tie-break, the plain
  film scans in file order, so only razor-edge ties may differ - and, when
  a case shows no tie, at atol 2e-5 (the JAX megakernel tests' own).

The CUDA kernel runs only on a GPU: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold it against B1's film and the plain film.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT as J_DEFAULT, REFERENCE as J_REFERENCE)
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.ops import pallas_super as JM
from opencl_montecarlo_path_tracing_tpu.scene import builtin as JB
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    key_from_jax, scene_arrays_from_numpy)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE)
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_blocks as TB
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene import builtin as PB
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_torch_gpu import sheet_scene, small_scene, window_torus

ATOL = 2e-5


def j_prep(scene: Scene):
    return JI.prep_scene(JScene(scene.sphere_centers, scene.square_kj,
                                scene.triangles, scene.lights))


# 1800 triangles -> 15 blocks -> 16 (one NaN block); 260 -> 3 -> 8 (five)
@pytest.mark.parametrize("shape", [(30, 30), (10, 13)])
def test_tri_blocks_match_jax(shape):
    scene = sheet_scene(*shape)
    mine = TB._tri_blocks(prep_scene(scene))
    theirs = JM._tri_blocks(j_prep(scene))
    n_blocks = mine[1].shape[0]
    assert n_blocks % TB._MACRO == 0
    assert -(-scene.n_triangles // TB._TRI_BLOCK) % TB._MACRO != 0
    assert np.isnan(mine[1]).any(axis=1).sum() > 0
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)     # NaN == NaN here


def test_large_mesh_scene_matches_jax():
    a, b = PB.large_mesh_scene(), JB.large_mesh_scene()
    assert a.n_triangles == 20736
    for f in ("sphere_centers", "square_kj", "triangles", "lights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_kernel_tables_structure():
    scn = prep_scene(sheet_scene(30, 30))
    tblT, aabbs, _ = TB._tri_blocks(scn)
    rows, boxes, macros, _ = TB._kernel_tables(TB._tri_blocks_ordered(scn))
    for a, b in zip((rows, boxes), TB.walk_tables(scn)):
        np.testing.assert_array_equal(a, b)
    live = aabbs[:, 0] <= aabbs[:, 3]
    assert boxes.shape == (live.sum(), 8) and not np.isnan(boxes).any()
    assert rows.shape == (live.sum() * TB._TRI_BLOCK, 16)
    idx = rows[:, 12].view(np.int32)
    real = idx >= 0
    np.testing.assert_array_equal(np.sort(idx[real]),
                                  np.arange(scn.tri_v0.shape[0]))
    np.testing.assert_array_equal(rows[real, :3], scn.tri_v0[idx[real]])
    np.testing.assert_array_equal(rows[real, 9:12], scn.tri_n[idx[real]])
    assert not rows[~real, :12].any()          # padding rows: det = 0
    v = rows[:, :3].reshape(-1, TB._TRI_BLOCK, 3)
    for k in (0, 3, 6):                        # v0, v0 + e0, v0 + e2
        p = (rows[:, :3] + (rows[:, k:k + 3] if k else 0)).reshape(v.shape)
        r = real.reshape(v.shape[:2])
        assert ((p >= boxes[:, None, 0:3]) | ~r[..., None]).all()
        assert ((p <= boxes[:, None, 4:7]) | ~r[..., None]).all()
    first = macros[:, 3].view(np.int32)
    count = macros[:, 7].view(np.int32)
    np.testing.assert_array_equal(first, np.concatenate([[0], np.cumsum(
        count)[:-1]]))
    assert count.sum() == boxes.shape[0] and (count <= TB._MACRO).all()
    for m in range(macros.shape[0]):
        sl = boxes[first[m]:first[m] + count[m]]
        assert (sl[:, 0:3] >= macros[m, 0:3]).all()
        assert (sl[:, 4:7] <= macros[m, 4:7]).all()


def test_global_box_contains_every_block():
    _, aabbs, _ = TB._tri_blocks(prep_scene(sheet_scene(10, 13)))
    g = TB.global_box(aabbs)
    live = aabbs[:, 0] <= aabbs[:, 3]
    assert (aabbs[live, :3] > np.asarray(g[:3])).all()
    assert (aabbs[live, 3:] < np.asarray(g[3:])).all()


# (name, scene, seed, (w, h, spp), window kwargs, quirks, JAX tier flag)
CASES = [
    ("blocked_small", small_scene, 12, (40, 12, 2), {}, "default",
     "force_blocked"),
    ("stream_small", small_scene, 12, (40, 12, 2), {}, "default",
     "force_stream"),
    ("blocked_reference", small_scene, 13, (16, 16, 2), {}, "reference",
     "force_blocked"),
    ("blocked_torus_window", window_torus, 23, (40, 158, 2),
     dict(row_offset=150, rows=8), "default", "force_blocked"),
]
QUIRKS = {"default": (J_DEFAULT, DEFAULT), "reference": (J_REFERENCE,
                                                         REFERENCE)}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_blocked_tiers(case):
    name, make_scene, seed, (w, h, spp), kw, qname, tier = case
    jq, tq = QUIRKS[qname]
    jscn = j_prep(make_scene())
    key = make_key(seed)
    want = np.asarray(JM.film_super_mega(key, jscn, w, h, spp, quirks=jq,
                                         interpret=True, **{tier: True},
                                         **kw))
    got = M.film_super_mega(key_from_jax(key), scene_arrays_from_numpy(jscn),
                            w, h, spp, quirks=tq, device="cpu",
                            force_blocked=True, **kw).numpy()
    assert got.shape == want.shape == (kw.get("rows", h), w, 3)
    if "torus" in name:
        assert want.var() > 1e-5              # the mesh is in the window
    ok, st = crn_ok(got, want, spp)
    assert ok, st
    if st["tie_frac"] == 0.0:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_force_blocked_on_cpu_is_the_plain_film():
    scn = prep_scene(small_scene())
    before = M.LAUNCHES, M.BLOCKED_LAUNCHES
    a = M.film_super_mega((3, 0), scn, 16, 8, 1, device="cpu",
                          force_blocked=True)
    b = M.film_super_mega_plain((3, 0), scn, 16, 8, 1)
    assert (M.LAUNCHES, M.BLOCKED_LAUNCHES) == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)
