"""ops/vlp.py, ops/grid.py and kernel B6's plain version against the JAX
package.

Inputs are made from a seed with numpy and go through the JAX function and
its port.  Tolerances, each with its reason:

* emission: the live mask is equal; values to rtol = atol = 1e-5 (the
  directions go through cos/sin, whose float32 implementations in XLA and
  in torch may differ by an ulp); a ``gi0``/``count`` window equals the
  same rows of the full table exactly (every draw keys on the global gi);
* the scan gather and the grid gather: rtol = atol = 2e-4, the JAX
  package's own bound against the naive oracle (``tests/test_vlp.py``);
* B6's plain version against the JAX MXU kernel in interpret mode, on the
  R = 777, V = 130 case of ``tests/test_vlp.py:124-141``: rtol = atol =
  2e-5 (the kernel's matrix products sum their 16 terms in another order);
* bounds, both resolution functions and the cell-scan build: exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT as J_DEFAULT, REFERENCE as J_REFERENCE)
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.ops import grid as JG
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.ops import vlp as JV
from opencl_montecarlo_path_tracing_tpu.ops.pallas_vlp import (
    gather_vlps_mxu as j_gather_mxu)
from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
    demo_scene as j_demo_scene)
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    grid_from_numpy, key_from_jax, scene_arrays_from_numpy, vlps_from_numpy)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE)
from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G
from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as TG
from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
from tests.test_vlp import vlp_scene


def _points(seed, R, Vn):
    """tests/test_vlp.py's random shading points, normals and VLPs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(5, 3, (R, 3)).astype(np.float32)
    n = rng.normal(0, 1, (R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vlps = rng.normal(5, 3, (Vn, 4)).astype(np.float32)
    vlps[:, 3] = np.abs(vlps[:, 3])
    vlps[::5, 3] = 0.0
    return x, n, vlps


def test_uniform_sphere_matches_jax():
    u = np.random.default_rng(0).random((2, 5000)).astype(np.float32)
    want = np.asarray(JV.uniform_sphere(jnp.asarray(u[0]), jnp.asarray(u[1])))
    got = TV.uniform_sphere(torch.from_numpy(u[0]),
                            torch.from_numpy(u[1])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scene_name", ["demo", "vlp"])
@pytest.mark.parametrize("qname", ["default", "reference"])
def test_emit_vlps_matches_jax(scene_name, qname):
    scene = j_demo_scene()[0] if scene_name == "demo" else vlp_scene()
    jscn = JI.prep_scene(scene)
    tscn = scene_arrays_from_numpy(jscn)
    jq, tq = {"default": (J_DEFAULT, DEFAULT),
              "reference": (J_REFERENCE, REFERENCE)}[qname]
    key = make_key(3)
    n_vlp = 256
    want = np.asarray(JV.emit_vlps(key, jscn, n_vlp, jq))
    got = TV.emit_vlps(key_from_jax(key), tscn, n_vlp, tq,
                       device="cpu").numpy()
    assert got.shape == want.shape == (len(scene.lights) * n_vlp, 4)
    np.testing.assert_array_equal(got[:, 3] > 0, want[:, 3] > 0)
    assert (got[:, 3] > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the window [gi0, gi0+count) of each light == the same rows in full
    gi0, count = 40, 24
    win = TV.emit_vlps(key_from_jax(key), tscn, n_vlp, tq, gi0=gi0,
                       count=count, device="cpu").numpy()
    rows = np.concatenate([np.arange(gi0, gi0 + count) + l * n_vlp
                           for l in range(len(scene.lights))])
    np.testing.assert_array_equal(win, got[rows])


def test_gather_scan_matches_jax():
    x, n, vlps = _points(7, 300, 50)
    want = np.asarray(JV.gather_vlps(jnp.asarray(x), jnp.asarray(n),
                                     jnp.asarray(vlps), impl="scan"))
    got = TV.gather_vlps(torch.from_numpy(x), torch.from_numpy(n),
                         torch.from_numpy(vlps), impl="scan").numpy()
    assert want.max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_gather_mxu_plain_matches_jax_kernel():
    """Kernel B6's plain version == the JAX MXU kernel (interpret mode) on
    a batch that is no tile multiple; on the CPU the wrapper returns the
    plain version and launches nothing."""
    x, n, vlps = _points(11, 777, 130)
    want = np.asarray(j_gather_mxu(jnp.asarray(x), jnp.asarray(n),
                                   jnp.asarray(vlps), interpret=True))
    tx, tn, tv = (torch.from_numpy(a) for a in (x, n, vlps))
    got = G.gather_vlps_mxu_plain(tx, tn, tv).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    before = G.LAUNCHES
    wrapped = G.gather_vlps_mxu(tx, tn, tv)
    assert G.LAUNCHES == before
    torch.testing.assert_close(wrapped, torch.from_numpy(got), rtol=0,
                               atol=0)
    # and the scan agrees with the MXU form (tests/test_vlp.py pins both)
    scan = TV.gather_vlps(tx, tn, tv).numpy()
    np.testing.assert_allclose(got, scan, rtol=2e-4, atol=2e-4)


def test_vlp_bounds_and_resolutions_exact():
    vlps = np.array([[0.0, 0.0, 0.0, 1.0], [40.0, 4.0, 0.5, 0.25],
                     [5.0, 5.0, 5.0, 0.0]], np.float32)
    jlo, jhi = (np.asarray(b) for b in JV.vlp_bounds(jnp.asarray(vlps)))
    tlo, thi = (b.numpy() for b in TV.vlp_bounds(torch.from_numpy(vlps)))
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(thi, jhi)
    for n_vlp, csm in ((12, 3.0), (4096, 3.0), (1024, 1.5), (1, 3.0)):
        assert TV.vlp_grid_static_res(n_vlp, csm) == \
            JV.vlp_grid_static_res(n_vlp, csm)
        assert TV.vlp_grid_dynamic_res(tlo, thi, n_vlp, csm) == \
            JV.vlp_grid_dynamic_res(jlo, jhi, n_vlp, csm)
    big = np.float32(3.4e38)
    assert TV.vlp_grid_dynamic_res([big] * 3, [-big] * 3, 64) == (1, 1, 1)
    assert TV.vlp_grid_dynamic_res([0, 0, 0], [1e-3] * 3, 10**9) == \
        (128, 128, 128)


@pytest.mark.parametrize("cap", [62, 3])
def test_build_grid_cellscan_exact(cap):
    """items/counts equal the JAX build exactly, with far (dead) boxes,
    boxes that span the grid, and overflowing cells (cap 3)."""
    rng = np.random.default_rng(5)
    N = 90
    lo = rng.uniform(-2, 10, (N, 3)).astype(np.float32)
    amax = lo + rng.uniform(0, 6, (N, 3)).astype(np.float32)
    amin = lo.copy()
    amin[::7] = np.float32(3e38)       # dead VLPs' far boxes
    amax[::7] = np.float32(3e38)
    amin[3] = -50.0                   # spans everything
    amax[3] = 50.0
    vmin = np.array([-1.0, -1.5, -0.5], np.float32)
    cell = np.array([1.3, 0.9, 2.1], np.float32)
    res = (6, 5, 4)
    want = JG.build_grid_cellscan(jnp.asarray(amin), jnp.asarray(amax),
                                  jnp.asarray(vmin), jnp.asarray(cell), res,
                                  cap=cap)
    got = TG.build_grid_cellscan(torch.from_numpy(amin),
                                 torch.from_numpy(amax),
                                 torch.from_numpy(vmin),
                                 torch.from_numpy(cell), res, cap=cap,
                                 cell_chunk=37)
    np.testing.assert_array_equal(got.items.numpy(), np.asarray(want.items))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.res == res
    if cap == 3:
        assert (np.asarray(want.counts) == cap).any()


def test_vlp_grid_and_grid_gather_match_jax():
    """build_vlp_grid == JAX exactly; the grid gather over the JAX grid
    (carried across by convert.py) matches at 2e-4."""
    rng = np.random.default_rng(3)
    Vn = 40
    vlps = np.zeros((Vn, 4), np.float32)
    vlps[:, :3] = rng.normal(5, 2, (Vn, 3))
    vlps[:, 3] = rng.uniform(0.0, 0.02, Vn)
    vlps[::6, 3] = 0.0
    res = JV.vlp_grid_static_res(Vn)
    jgrid = JV.build_vlp_grid(jnp.asarray(vlps), res)
    tgrid = TV.build_vlp_grid(vlps_from_numpy(vlps), res)
    np.testing.assert_array_equal(tgrid.items.numpy(),
                                  np.asarray(jgrid.items))
    np.testing.assert_array_equal(tgrid.counts.numpy(),
                                  np.asarray(jgrid.counts))
    np.testing.assert_array_equal(tgrid.vmin.numpy(), np.asarray(jgrid.vmin))
    np.testing.assert_array_equal(tgrid.cell_size.numpy(),
                                  np.asarray(jgrid.cell_size))
    x = rng.normal(5, 1.5, (256, 3)).astype(np.float32)
    n = rng.normal(0, 1, (256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    want = np.asarray(JV.gather_vlps_grid(jnp.asarray(x), jnp.asarray(n),
                                          jnp.asarray(vlps), jgrid))
    got = TV.gather_vlps_grid(torch.from_numpy(x), torch.from_numpy(n),
                              vlps_from_numpy(vlps),
                              grid_from_numpy(jgrid)).numpy()
    assert (want > 1e-3).mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_gather_routes_to_scan_on_cpu():
    """On the CPU the default gather is the scan, whatever the batch."""
    x, n, vlps = _points(2, 2048, 64)
    tx, tn, tv = (torch.from_numpy(a) for a in (x, n, vlps))
    before = G.LAUNCHES
    a = TV.gather_vlps(tx, tn, tv)
    assert G.LAUNCHES == before
    torch.testing.assert_close(a, TV.gather_vlps(tx, tn, tv, impl="scan"),
                               rtol=0, atol=0)
