"""The light pass's kernels (L1, L2a, L2b; ops/light_pass.py) on the CPU:
their route, their packed inputs, and the property their one-thread-a-
chain design rests on.

The kernels run only on a CUDA device (tests/test_torch_gpu.py holds them
bit for bit against their plain versions there); here:

* ``light_route`` is decided from the configuration: the kernels on a
  CUDA device at every scene size, the plain light pass on the CPU;
* a CUDA request without a GPU raises (no fallback to the CPU);
* the wrapper's packed inputs - the scene buffer (one device copy,
  shared with kernel B4), key words, windows, quirk flags and float
  constants - against ``SceneArrays`` and the plain modules' constants;
* every chain's rows, and every work item's, depend on its own draws
  only: a one-chain (``chains=1``) or one-item (``count=1``) window of the
  plain light pass equals that chain's or item's rows of the full table,
  bit for bit (the kernels run one thread a chain or item).

* the plain light pass holds to the port's NumPy oracles on the demo and
  dense scenes, under both quirk sets and in a window
  (``tests/test_torch_gpu.py::hold_light_pass_to_oracles``, which the card
  tests run on the kernels' tables).

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
    scene size leaves the card's light pass to plain PyTorch."""
    assert L.light_route("cuda") == "light_pass"
    assert L.light_route(torch.device("cuda", 0)) == "light_pass"
    assert L.light_route("cpu") == "plain"
    assert L.light_route(torch.device("cpu")) == "plain"
    assert not hasattr(L, "unsupported_reason")


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
