"""The light pass's kernels (L1, L2a, L2b; ops/light_pass.py) on the CPU:
their route, their packed inputs, the property their one-warp-a-chain
design rests on, and the NumPy twins of their triangle stage.

The kernels run only on a CUDA device (tests/test_torch_gpu.py holds them
bit for bit against their plain versions there); here:

* ``light_route`` is decided from the configuration: the kernels on a
  CUDA device at every scene size, the plain light pass on the CPU;
  ``triangle_route`` from the scene's size (the culled walk from 2,048
  triangles);
* a CUDA request without a GPU raises (no fallback to the CPU);
* the wrapper's packed inputs - the scene buffer (one device copy,
  shared with kernel B4), key words, windows, quirk flags and float
  constants - against ``SceneArrays`` and the plain modules' constants;
* every chain's rows, and every work item's, depend on its own draws
  only: a one-chain (``chains=1``) or one-item (``count=1``) window of the
  plain light pass equals that chain's or item's rows of the full table,
  bit for bit (the kernels run one warp a chain or item);
* the plain light pass holds to the port's NumPy oracles on the demo and
  dense scenes, under both quirk sets and in a window
  (``tests/test_torch_gpu.py::hold_light_pass_to_oracles``, which the card
  tests run on the kernels' tables);
* a grid render on B4's route builds only the grid's frame, the same
  vmin, cell size and resolution as the full build;
* the twins (``scan_twin``, ``walk_twin``): the warp scan's ballot and
  ordered update give the sequential scan's (t, index) bit for bit, ties
  and ``neg_t`` included, and the culled walk the full scan's.

The JAX-against-port tests of the light pass stay in
tests/test_torch_vlp.py and tests/test_torch_bpt_mlt.py.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE, REFERENCE_LMEM)
from opencl_montecarlo_path_tracing_tpu_torch.models import metropolis as TM
from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M4
from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
    _tri_table, prep_scene)
from opencl_montecarlo_path_tracing_tpu_torch.ops.mega_super import (
    scene_buffer)
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    demo_scene, dense_vlp_scene)

CHAINS, ROUNDS = 8, 2


@pytest.fixture(autouse=True, scope="module")
def _warm_sqrt():
    """A first torch.sqrt call in a process has been seen to return one
    2,048-element segment off by ~2e-4 relative (torch 2.13.0+cpu on an
    AVX-512 CPU; ROADMAP queue C): take it here, before any ray."""
    torch.sqrt(torch.rand(16384) * 400.0)


def scenes():
    return {"demo": prep_scene(demo_scene()[0]),
            "dense": prep_scene(dense_vlp_scene())}


def test_light_route_is_decided_from_the_configuration():
    """The device alone decides: the kernels stage a scene of <= 512
    triangles in shared memory and read a larger one in place, so no
    scene size leaves the card's light pass to plain PyTorch; the scene's
    size picks the triangle stage (the culled walk from 2,048)."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    assert L.light_route("cuda") == "light_pass"
    assert L.light_route(torch.device("cuda", 0)) == "light_pass"
    assert L.light_route("cpu") == "plain"
    assert L.light_route(torch.device("cpu")) == "plain"
    assert not hasattr(L, "unsupported_reason")
    assert L.triangle_route(scenes()["demo"]) == "scan"
    assert L.triangle_route(scenes()["dense"]) == "scan"
    assert L.triangle_route(prep_scene(large_mesh_scene(32, 31))) == "scan"
    assert L.triangle_route(prep_scene(large_mesh_scene(32, 32))) == "walk"


def _calls(scn):
    seed = TM.mlt_seed((1, 0), scn, 4, device="cpu")
    return {
        "emit_vlps": lambda d: TV.emit_vlps((1, 0), scn, 4, device=d),
        "mlt_seed": lambda d: TM.mlt_seed((1, 0), scn, 4, device=d),
        "mlt_mutate_emit": lambda d: TM.mlt_mutate_emit(
            (1, 0), scn, 4, 1, seed_state=seed, device=d),
        "mlt_vlps": lambda d: TM.mlt_vlps((1, 0), scn, 4, 1, device=d),
        "L1": lambda d: L.emit((1, 0), scn, 4, DEFAULT, device=d),
        "L2a": lambda d: L.mlt_seed((1, 0), scn, 4, DEFAULT, device=d),
        "L2b": lambda d: L.mlt_mutate_emit((1, 0), scn, 4, 1, DEFAULT,
                                           seed_state=seed, device=d),
    }


@pytest.mark.parametrize("fn", ["emit_vlps", "mlt_seed", "mlt_mutate_emit",
                                "mlt_vlps", "L1", "L2a", "L2b"])
def test_cuda_request_never_falls_back_to_cpu(fn):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA request is served")
    call = _calls(prep_scene(dense_vlp_scene()))[fn]
    with pytest.raises(RuntimeError, match="is_available"):
        call("cuda")
    if fn.startswith("L"):
        # the kernel wrappers run only on a CUDA device
        with pytest.raises(ValueError, match="CUDA device"):
            call("cpu")


def test_default_device_is_cuda():
    """The routed light-pass functions default to the card, like
    film_vlp and film_metropolis."""
    import inspect
    for fn in (TV.emit_vlps, TM.mlt_seed, TM.mlt_mutate_emit, TM.mlt_vlps,
               L.emit, L.mlt_seed, L.mlt_mutate_emit):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ["demo", "dense"])
def test_packed_scene_matches_scene_arrays(name):
    scn = scenes()[name]
    buf_t, ntp = scene_buffer(scn, "cpu")
    buf = buf_t.numpy()
    nt, nl = scn.tri_v0.shape[0], scn.lights.shape[0]
    ns, nq = scn.sphere_centers.shape[0], scn.square_k.shape[0]
    assert ntp % 8 == 0 and nt <= ntp < nt + 8
    assert buf.dtype == np.float32
    assert buf.shape == (ntp * 12 + 12 + nl * 4 + ns * 3 + 2 * nq,)
    tri = buf[:ntp * 12].reshape(ntp, 12)
    np.testing.assert_array_equal(tri[:nt], _tri_table(scn))
    assert not tri[nt:].any()          # padding rows: det = 0, no hit
    o = ntp * 12 + 12                  # past the camera
    np.testing.assert_array_equal(buf[o:o + nl * 4].reshape(nl, 4),
                                  scn.lights)
    o += nl * 4
    np.testing.assert_array_equal(buf[o:o + ns * 3].reshape(ns, 3),
                                  scn.sphere_centers)
    o += ns * 3
    np.testing.assert_array_equal(buf[o:o + nq], scn.square_k)
    np.testing.assert_array_equal(buf[o + nq:], scn.square_z)
    # built once per prepared scene and device, one copy for B4 and the
    # light pass
    assert scene_buffer(scn, "cpu")[0] is buf_t
    assert M4.kernel_inputs(scn, "cpu")[0] is buf_t
    assert M4.kernel_inputs(scn, "cpu")[1] == ntp


def test_packed_arguments():
    scn = scenes()["dense"]
    # keys, windows modulo 2^32, quirk flags, the scale's reciprocal as
    # torch's CUDA division by a float takes it (768 * 2 // 512 = 3)
    a = L.emit_args((7, 2**32 - 1), scn, 768, REFERENCE, gi0=2**32 + 5,
                    count=9)
    assert a == L.EmitArgs(7, 2**32 - 1, 5, 9, 2, 1, 1,
                           float(np.float32(1) / np.float32(3)))
    assert L.emit_args((0, 0), scn, 512, DEFAULT) == L.EmitArgs(
        0, 0, 0, 512, 2, 0, 0, 0.5)
    with pytest.raises(ValueError, match="uint32"):
        L.emit_args((-1, 0), scn, 8, DEFAULT)
    c = L.chain_args((3, 4), scn, 384, REFERENCE_LMEM, 8, 1e-3, chain0=-1,
                     chains=6)
    assert c == L.ChainArgs(3, 4, 2**32 - 1, 6, 2, 8, 1, 0,
                            float(np.float32(1e-3 * 1e-3)),
                            float(np.float32(1) / np.float32(3)))
    c = L.chain_args((3, 4), scn, 512, DEFAULT, 0, 0.0)
    assert (c.chains, c.rounds, c.exact, c.eps2, c.neg_t,
            c.inv_scale) == (512, 0, 1, 0.0, 0, 0.25)
    # the float constants are the plain modules' float32 values
    k = L.consts()
    assert k == L.Consts(TV._TWO_PI, float(TM._S1), TM._RATIO,
                         TM._DX_OFFSET)
    assert float.hex(k.two_pi) == float.hex(float(np.float32(2 * np.pi)))
    for v in k:
        assert v == float(np.float32(v))


@pytest.mark.parametrize("name", ["demo", "dense"])
def test_a_chain_depends_on_its_own_draws_only(name):
    """Each of 8 chains x 2 rounds: its one-chain window (seed state and
    table) equals its rows of the full run, bit for bit."""
    scn = scenes()[name]
    key = (3, 0)
    nl = int(scn.lights.shape[0])
    v, length = TM.mlt_seed(key, scn, CHAINS, device="cpu")
    full = TM.mlt_vlps(key, scn, CHAINS, ROUNDS, device="cpu")
    if name == "dense":
        assert (full[:, 3] > 0).sum() >= 8
    for c in range(CHAINS):
        rows = [l * CHAINS + c for l in range(nl)]
        wv, wl = TM.mlt_seed(key, scn, CHAINS, chain0=c, chains=1,
                             device="cpu")
        assert torch.equal(wv, v[rows]) and torch.equal(wl, length[rows])
        win = TM.mlt_vlps(key, scn, CHAINS, ROUNDS, chain0=c, chains=1,
                          device="cpu")
        # layout [light][slot][chain]
        assert torch.equal(win, full[c::CHAINS])


@pytest.mark.parametrize("name", ["demo", "dense"])
@pytest.mark.parametrize("quirks", [DEFAULT, REFERENCE],
                         ids=["default", "reference"])
def test_an_emitted_row_depends_on_its_own_draws_only(name, quirks):
    scn = scenes()[name]
    n = 8
    full = TV.emit_vlps((5, 0), scn, n, quirks, device="cpu")
    for g in range(n):
        one = TV.emit_vlps((5, 0), scn, n, quirks, gi0=g, count=1,
                           device="cpu")
        assert torch.equal(one, full[g::n])


def test_plain_flag_is_the_cpu_route():
    """On the CPU the routed functions are their plain versions."""
    scn = scenes()["dense"]
    assert torch.equal(TV.emit_vlps((2, 0), scn, 16, device="cpu"),
                       TV.emit_vlps((2, 0), scn, 16, device="cpu",
                                    plain=True))
    assert torch.equal(TM.mlt_vlps((2, 0), scn, 4, 2, device="cpu"),
                       TM.mlt_vlps((2, 0), scn, 4, 2, device="cpu",
                                   plain=True))


@pytest.mark.parametrize("qname", ["default", "reference"])
@pytest.mark.parametrize("scene", ["demo", "dense"])
def test_plain_light_pass_holds_to_the_oracles(scene, qname):
    from tests.test_torch_gpu import hold_light_pass_to_oracles
    hold_light_pass_to_oracles("cpu", scene, qname)


@pytest.mark.parametrize("case", ["demo", "dense", "dense, dynamic res"])
def test_grid_frame_equals_the_full_grid_build(case):
    """On B4's route a grid render builds only the grid's frame
    (ops/vlp.py::vlp_grid_frame): its vmin, cell size and resolution are
    those of build_vlp_grid, bit for bit, at the static resolution and at
    the reference's box-derived one (dynamic_grid_res)."""
    scn = scenes()["demo" if case == "demo" else "dense"]
    vlps = TM.mlt_vlps((4, 0), scn, 64, 2, device="cpu")
    if case == "dense":
        assert int((vlps[:, 3] > 0).sum()) >= 8
    if case.endswith("dynamic res"):
        vmin, vmax = (b.numpy() for b in TV.vlp_bounds(vlps))
        res = TV.vlp_grid_dynamic_res(vmin, vmax, int(vlps.shape[0]))
    else:
        res = TV.vlp_grid_static_res(int(vlps.shape[0]))
    full = TV.build_vlp_grid(vlps, res)
    frame = TV.vlp_grid_frame(vlps, res)
    assert frame.res == full.res and all(type(r) is int for r in frame.res)
    assert torch.equal(frame.vmin, full.vmin)
    assert torch.equal(frame.cell_size, full.cell_size)
    # what B4 reads of a grid: the same table and grid floats from both
    assert all(torch.equal(a, b) for a, b in zip(
        M4.vlp_table(vlps, frame)[::2], M4.vlp_table(vlps, full)[::2]))


def test_grid_frame_only_on_b4s_route():
    """The frame alone where B4 renders the pass (a CUDA device and B4's
    gate, which takes the shadow_carry_t quirk since the VLP family never
    reads it), the full grid wherever the tier-1 gather reads its lists: on
    the CPU, and on the card for max_bounces 0."""
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        bidirectional as TB)
    scn = scenes()["demo"]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TB.grid_frame_only(scn, DEFAULT, 2, cuda)
    assert not TB.grid_frame_only(scn, DEFAULT, 2, cpu)
    assert TB.grid_frame_only(scn, REFERENCE_LMEM, 2, cuda)
    assert not TB.grid_frame_only(scn, REFERENCE_LMEM, 0, cuda)
    vlps = TM.mlt_vlps((4, 0), scn, 8, 1, device="cpu")
    assert isinstance(TB.vlp_grid(vlps, (3, 3, 3), True), TV.GridFrame)
    assert TB.vlp_grid(vlps, (3, 3, 3), False).items.shape == (27, 62)


def tie_mesh(n: int) -> np.ndarray:
    """An n x n grid of unit squares in the plane z = 0, two triangles a
    square sharing its diagonal, squares sharing their edges: a ray down
    the z axis through an edge or a vertex hits several triangles at
    exactly the same distance (small integers: no rounding)."""
    tris = []
    for j in range(n):
        for i in range(n):
            v00, v10 = (i, j, 0), (i + 1, j, 0)
            v01, v11 = (i, j + 1, 0), (i + 1, j + 1, 0)
            tris += [(v00, v10, v11), (v00, v11, v01)]
    return np.asarray(tris, np.float32)


def tie_rays(n: int, count: int, seed: int):
    """Rays straight down onto the tie mesh from z = 5: half through
    vertices, edge midpoints and diagonals (exact ties), half at random
    points; and their reversal from z = -5 (negative t under neg_t)."""
    g = np.random.default_rng(seed)
    k = count // 2
    xy = np.concatenate([
        g.integers(1, n, (k, 2)).astype(np.float32)
        + g.choice([0.0, 0.5], (k, 2)).astype(np.float32),
        g.uniform(0.2, n - 0.2, (count - k, 2)).astype(np.float32)])
    o = np.concatenate([xy, np.full((count, 1), 5.0, np.float32)], 1)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (count, 1))
    return o, d


def mesh_table(tris: np.ndarray) -> np.ndarray:
    """(N, 12) packed rows (v0, e0, e2, normal) of the port's tables."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
    scn = prep_scene(Scene(sphere_centers=np.zeros((0, 3), np.float32),
                           square_kj=np.zeros((0, 2), np.float32),
                           triangles=tris,
                           lights=np.zeros((1, 4), np.float32)))
    return _tri_table(scn), scn


def light_rays(scn, count: int, seed: int):
    """``count`` rays from the scene's lights in uniform random directions
    (the emission's rays), and ``count`` aimed from random points around
    the mesh at random triangles' centroids (so that many hit)."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(count, 3)).astype(np.float32)
    lights = np.asarray(scn.lights, np.float32)[:, :3]
    o = lights[g.integers(0, lights.shape[0], count)]
    v0 = np.asarray(scn.tri_v0, np.float32)
    cen = v0 + (np.asarray(scn.tri_e0, np.float32)
                + np.asarray(scn.tri_e2, np.float32)) / np.float32(3)
    target = cen[g.integers(0, cen.shape[0], count)]
    ext = float(np.ptp(v0, axis=0).max())
    o2 = (target + g.normal(size=(count, 3)) * ext).astype(np.float32)
    o = np.concatenate([o, o2])
    d = np.concatenate([d, target - o2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("case", ["demo", "ties", "ties, neg_t"])
def test_warp_scan_twin_equals_the_sequential_scan(case):
    """The full scan's ballot and ordered update (csrc/pt_device.cuh::
    warp_scan_closest, its NumPy twin) give the sequential scan's (t,
    index) bit for bit: on the demo mesh for light rays, and on a mesh of
    shared edges for rays through edges and vertices (exact ties, which
    both keep at the earliest row), also under neg_t from below."""
    if case == "demo":
        scn = scenes()["demo"]
        tri = _tri_table(scn)
        o, d = light_rays(scn, 256, 1)
        neg_t = False
    else:
        tri, _ = mesh_table(tie_mesh(6))
        o, d = tie_rays(6, 400, 2)
        neg_t = case.endswith("neg_t")
        if neg_t:
            o[:, 2] = -5.0
    t0 = np.full(o.shape[0], 1e9, np.float32)
    t0[::7] = 4.0                       # a closer floor or sphere hit
    ts, bs = L.sequential_scan(tri, o, d, t0, neg_t)
    tw, bw = L.scan_twin(tri, o, d, t0, neg_t)
    assert (bs >= 0).mean() > 0.1
    np.testing.assert_array_equal(tw, ts)
    np.testing.assert_array_equal(bw, bs)
    if case != "demo":
        # exact ties happened, and went to the earliest row
        _, bl = L.sequential_scan(tri[::-1].copy(), o, d, t0, neg_t)
        assert ((bl >= 0) & (tri.shape[0] - 1 - bl != bs)).sum() > 20


def test_sequential_scan_twin_is_the_plain_trace():
    """The twins' arithmetic is the plain trace's: the sequential scan's t
    over the demo mesh equals ops/intersect.py::trace_ray's on rays that
    meet no floor (upward), square or sphere of a triangles-only scene."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        trace_ray)
    tri, scn = mesh_table(np.stack([
        np.asarray(scenes()["demo"].tri_v0, np.float32),
        np.asarray(scenes()["demo"].tri_v0 + scenes()["demo"].tri_e0,
                   np.float32),
        np.asarray(scenes()["demo"].tri_v0 + scenes()["demo"].tri_e2,
                   np.float32)], 1))
    o, d = light_rays(scn, 300, 3)
    up = d[:, 2] > 0.05
    o, d = o[up], d[up]
    t, b = L.sequential_scan(tri, o, d, np.full(o.shape[0], 1e9,
                                                np.float32))
    tr = trace_ray(torch.from_numpy(o), torch.from_numpy(d), scn,
                   plain=True)
    assert (b >= 0).mean() > 0.1
    np.testing.assert_array_equal(tr.material.numpy() == 4, b >= 0)
    np.testing.assert_array_equal(tr.t.numpy()[b >= 0], t[b >= 0])


@pytest.mark.parametrize("case", ["sheet", "ties", "ties, neg_t"])
def test_walk_twin_gives_the_full_scans_hit(case):
    """The culled walk over tri_blocks.walk_tables (csrc/pt_device.cuh::
    warp_walk_closest, its NumPy twin) gives the full scan's (t, index):
    on the 20,736-triangle sheet for random light rays and rays from the
    eye, and on a 2,048-triangle mesh of shared edges, where exact ties
    go to the lowest triangle index (the full scan's earliest row), also
    under neg_t; the walk tests a small share of the rows."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops.tri_blocks import (
        walk_tables)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    neg_t = case.endswith("neg_t")
    if case == "sheet":
        scn = prep_scene(large_mesh_scene())
        tri = _tri_table(scn)
        o, d = light_rays(scn, 96, 4)
    else:
        tri, scn = mesh_table(tie_mesh(32))
        o, d = tie_rays(32, 160, 6)
        if neg_t:
            o[:, 2] = -5.0
    assert tri.shape[0] >= 2048
    t0 = np.full(o.shape[0], 1e9, np.float32)
    t0[::9] = 4.0
    tally = {}
    tw, bw = L.walk_twin(walk_tables(scn), o, d, t0, neg_t, tally)
    ts, bs = L.scan_twin(tri, o, d, t0, neg_t)
    assert (bs >= 0).mean() > 0.2
    np.testing.assert_array_equal(bw, bs)
    np.testing.assert_array_equal(tw, ts)
    if not neg_t:
        assert tally["rows"] < 0.2 * tri.shape[0] * o.shape[0]


def test_ctypes_signatures_match_the_sources():
    """utils/build.py's ctypes signatures against the ``extern "C"``
    launchers of csrc/*.cu, parameter for parameter (pointers and the
    stream ``c_void_p``, ``int`` ``c_int``, ``unsigned`` ``c_uint``,
    ``float`` ``c_float``): a stale list passes the wrong arguments, which
    only a launch on the card would show."""
    import ctypes
    import glob
    import os
    import re
    from opencl_montecarlo_path_tracing_tpu_torch.utils import build
    kinds = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
             "float": ctypes.c_float}
    found = {}
    for path in glob.glob(os.path.join(build.CSRC, "*.cu")):
        src = open(path).read()
        for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                             src):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            found[m.group(1)] = [
                ctypes.c_void_p if "*" in p else
                kinds[p.replace("const ", "").split()[0]] for p in params]
    assert set(found) == set(build._SIGNATURES)
    for name, (_, argtypes) in build._SIGNATURES.items():
        assert argtypes == found[name], name
