"""Kernel B1 (ops/mega_super.py): its plain version == the JAX megakernel.

``film_super_mega_plain`` (plain PyTorch on the CPU) is held against the
JAX package's ``ops/pallas_super.py::film_super_mega(..., interpret=True)``
on the cases of ``tests/test_megakernel.py``: default quirks (sky window
and content band), reference quirks, odd-size padding, the spp window with
a row band, and the _lmem carry-t quirk.  Both consume the same threefry
streams, so the residual is float rounding only.

Tolerance: the per-family contract of ``tools/validate_crn_frame.py`` -
on the display scale ((film/spp*64)/255), the per-pixel difference's p99.5
< 1e-5 and razor-edge ties (> 1e-4) on < 0.6% of pixels, because any two
float implementations may flip a razor-edge tie (XLA:CPU contracts
multiply-adds, the port does not).  When a case shows no tie at these tiny
sizes, the film must also agree to atol 2e-5 (the JAX megakernel test's
own tolerance).

The CUDA kernel itself runs only on a GPU: ``tests/test_torch_gpu.py``
holds it against this plain version on the same cases (``gpu`` marker;
skipped without a GPU), as does ``python3 chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT as J_DEFAULT, REFERENCE as J_REFERENCE,
    REFERENCE_LMEM as J_REFERENCE_LMEM)
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.ops import pallas_super as JM
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    key_from_jax, scene_arrays_from_numpy)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_torch_gpu import CASES, CONTENT_ROW, QUIRKS, small_scene

ATOL = 2e-5
J_QUIRKS = {"default": J_DEFAULT, "reference": J_REFERENCE,
            "reference_lmem": J_REFERENCE_LMEM}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_megakernel(case):
    _, make_scene, seed, (w, h, spp), kw, qname = case
    jq, tq = J_QUIRKS[qname], QUIRKS[qname]
    scene = make_scene()
    jscn = JI.prep_scene(JScene(scene.sphere_centers, scene.square_kj,
                                scene.triangles, scene.lights))
    key = make_key(seed)
    want = np.asarray(JM.film_super_mega(key, jscn, w, h, spp, quirks=jq,
                                         interpret=True, **kw))
    got = M.film_super_mega_plain(key_from_jax(key),
                                  scene_arrays_from_numpy(jscn), w, h, spp,
                                  quirks=tq, device="cpu", **kw).numpy()
    assert got.shape == want.shape == (kw.get("rows", h), w, 3)
    if "row_offset" in kw and qname != "reference_lmem":
        assert want.var() > 1e-5   # the band has content, not only sky
    ok, st = crn_ok(got, want, spp)
    assert ok, st
    if st["tie_frac"] == 0.0:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU device the wrapper returns the plain version's film and
    launches nothing."""
    scn = prep_scene(small_scene())
    before = M.LAUNCHES
    a = M.film_super_mega((5, 0), scn, 16, 308, 2, quirks=DEFAULT,
                          row_offset=CONTENT_ROW, rows=4, device="cpu")
    b = M.film_super_mega_plain((5, 0), scn, 16, 308, 2, quirks=DEFAULT,
                                row_offset=CONTENT_ROW, rows=4)
    assert M.LAUNCHES == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _sized(n_triangles, n_lights=2):
    """SceneArrays of the given sizes without the memory: the gate reads
    shapes only."""
    base = prep_scene(small_scene())
    z3 = np.broadcast_to(np.zeros(3, np.float32), (n_triangles, 3))
    return base._replace(tri_v0=z3, tri_e0=z3, tri_e2=z3, tri_n=z3,
                         lights=np.tile(base.lights, (5, 1))[:n_lights])


def test_gate():
    """The JAX gate (<= 8 lights, <= 2^20 triangles); B1 up to 512
    triangles, B2/B3 above (or forced)."""
    from opencl_montecarlo_path_tracing_tpu_torch.models.super import (
        cuda_route)
    small = prep_scene(small_scene())
    assert M.unsupported_reason(small) is None
    assert not M.uses_blocked(small) and M.uses_blocked(small, True)
    assert M.uses_blocked(_sized(0), True) is False
    for n, blocked in ((512, False), (513, True), (1 << 20, True)):
        scn = _sized(n)
        assert M.unsupported_reason(scn) is None
        assert M.uses_blocked(scn) is blocked
        assert cuda_route(scn) == ("mega_blocked" if blocked
                                   else "mega_super")
    assert cuda_route(small, max_bounces=0) == "tier1"
    big, many = _sized((1 << 20) + 1), _sized(2, n_lights=9)
    assert "stream tier" in M.unsupported_reason(big)
    assert "lights" in M.unsupported_reason(many)
    for scn in (big, many):
        assert cuda_route(scn) == "tier1"
        with pytest.raises(NotImplementedError):
            M.film_super_mega((0, 0), scn, 8, 8, 1, device="cuda")


def test_pack_scene_layout():
    """Triangle rows pad to a multiple of 8 with zero rows (det = 0 never
    hits); camera, lights, spheres and squares follow in that order."""
    scn = prep_scene(small_scene())
    buf, ntp = M.pack_scene(scn)
    assert buf.dtype == np.float32 and ntp == 8
    tbl = buf[:ntp * 12].reshape(ntp, 12)
    np.testing.assert_array_equal(tbl[:2, :3], scn.tri_v0)
    np.testing.assert_array_equal(tbl[:2, 9:], scn.tri_n)
    assert not tbl[2:].any()
    rest = buf[ntp * 12 + 12:]
    nl, ns, nq = len(scn.lights), len(scn.sphere_centers), len(scn.square_k)
    np.testing.assert_array_equal(rest[:nl * 4], scn.lights.reshape(-1))
    np.testing.assert_array_equal(rest[nl * 4:nl * 4 + ns * 3],
                                  scn.sphere_centers.reshape(-1))
    np.testing.assert_array_equal(rest[-2 * nq:-nq], scn.square_k)
    np.testing.assert_array_equal(rest[-nq:], scn.square_z)
    assert len(buf) == ntp * 12 + 12 + nl * 4 + ns * 3 + 2 * nq
