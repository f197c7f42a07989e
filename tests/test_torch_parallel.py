"""The port's sharded renderers (parallel/mesh.py) against the JAX
package's, on 4 gloo ranks on the CPU against the 8-virtual-device CPU
mesh (tests/conftest.py) with the same mesh shape.

The port's ranks are spawned once for the module
(``tools/validate_sharded.py::run_ranks``) and run every case of
``CASES`` through the tool's checks, while this process computes the JAX
references in threads.  The Metropolis renderers are held in
``tests/test_torch_parallel_mlt.py`` (their JAX programs alone take ~13 s
each to compile).  Tolerances, each with its reason:

* a port film against the JAX sharded film: the CRN contract of
  ``tools/validate_crn_frame.py`` (utils/crn.py ``SUPER``: display-scale
  p99.5 < 1e-5, ties > 1e-4 on < 0.6% of pixels; ``SIMPLE`` for the
  mirror tracer) - both consume the same threefry streams, only float
  rounding differs.  (The JAX package's own tests hold its sharded films
  to its single-device ones at atol 2e-3.);
* a port sharded film against the port's unsharded film (the tool's
  checks): the same contract (the same samples summed in another order),
  and bit for bit on a mesh of one rank, on the light-pass tables, on the
  nodof bands and against the replicated light pass's film;
* the gathered VLP table against the JAX table: the live mask equal and
  rtol = atol = 1e-5 (``tests/test_torch_vlp.py``: the two packages'
  cos/sin differ by an ulp).  The JAX package's sharded light pass is its
  ``emit_vlps`` table bit for bit (its ``tests/test_parallel.py`` holds
  the films of both light passes bit-exact), so that table is the
  reference.  Those ulps move a VLP film by up to ~3e-5 on the display
  scale, past the contract, so the JAX sharded renders of the VLP cases
  emit the PORT's table: ``emit_vlps`` of the JAX module is replaced,
  for their calls, by one that serves the windows of the port's
  unsharded table (bit-equal to its gathered one, held by the check) -
  the JAX windows, ``all_gather`` and reassembly still run, as the port
  tests of the VLP slice hand the light pass across
  (``tests/test_torch_bpt_mlt.py``);
* a VLP film against the JAX sharded film: p99.5 < 5e-5, ties within
  the contract's budget.
  Compiled, XLA:CPU contracts the gather's multiply-adds into FMAs (the
  expanded distance |p|^2 - 2x.p + |x|^2): on this frame and table the
  compiled JAX render pass differs from the same JAX render pass run op
  by op (``jax.disable_jit``) by 1.33e-5 at p99.5, and the port's from
  the op-by-op one by 9.5e-8.  (A sharded JAX program cannot run op by
  op; the port's unsharded VLP films are held to op-by-op JAX at the
  full contract by ``tests/test_torch_bpt_mlt.py``, and its sharded ones
  to its unsharded ones by the checks here);
* nodof images: <= 1 uint8 step and >= 99.5% exact
  (``tests/test_torch_nodof.py``: the packages sum a pixel's samples in
  different orders).

The scene puts content into the small frames: a diffuse sphere whose
silhouette crosses the 16x16 corner of the fixed camera, two triangles,
and a light below the floor, whose upward rays hit the floor from below
and emit live VLPs (``scene/builtin.py::dense_vlp_scene``'s device).
"""

import contextlib
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.ops import vlp as JV
from opencl_montecarlo_path_tracing_tpu.parallel import mesh as JPM
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu_torch.convert import key_from_jax
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.ops.vlp import emit_vlps
from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
    render_bidirectional)
from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
    render_metropolis)
from opencl_montecarlo_path_tracing_tpu_torch.models.sample_parallel import (
    render_sample_parallel)
from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
    render_simple)
from opencl_montecarlo_path_tracing_tpu_torch.models.super import render_super
from opencl_montecarlo_path_tracing_tpu_torch.models.trianglegrid import (
    render_trianglegrid)
from opencl_montecarlo_path_tracing_tpu_torch.parallel import mesh as PM
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.tools import validate_sharded as V
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import (
    SIMPLE, SUPER, Contract, crn_ok)
from tests.test_torch_utils import _one_thread_warm_sqrt  # noqa: F401

RANKS = 4
W = H = 16
SPP = 8
SEED = 5
N_VLP = 32          # per light: 8 work items a rank on 4 ranks
N_VLP_ODD = 30      # indivisible by 4: the light pass renders replicated
# a VLP film against a compiled JAX VLP film (the module docstring)
XLA_VLP = Contract(q_limit=5e-5)

_F32 = np.float32
CORNER = dict(
    sphere_centers=np.array([[17.2, 5.0, 12.8], [17.6, 7.4, 13.6]], _F32),
    square_kj=np.zeros((0, 2), _F32),
    triangles=np.array([
        [[17.5, 9.6, 10.9], [17.5, 9.6, 11.3], [17.9, 9.7, 11.0]],
        [[17.8, 8.7, 11.3], [18.1, 8.7, 11.3], [17.9, 8.8, 11.6]]], _F32),
    lights=np.array([[17.5, 6.0, -1.0, 200], [19.0, 10.5, 11.4, 150]],
                    _F32))


def corner_scenes():
    """(the port's Scene, the JAX package's Scene) of the same arrays."""
    return Scene(**CORNER), JScene(**CORNER)


def keys(seed=SEED):
    jkey = make_key(seed)
    return key_from_jax(jkey), jkey


# (case id, the tool's check, its arguments beyond key and device)
TSCENE, JSCENE = corner_scenes()
_FRAME = dict(scene=TSCENE, width=W, height=H)
CASES = [
    ("super", "check_super", dict(spec=(RANKS,), spp=SPP, **_FRAME)),
    ("trianglegrid", "check_trianglegrid",
     dict(spec=(RANKS,), spp=SPP, **_FRAME)),
    ("simple", "check_simple", dict(spec=(RANKS,), width=W, height=H,
                                    spp=SPP)),
    ("bidirectional", "check_bidirectional",
     dict(spec=(RANKS,), spp=SPP, n_vlp=N_VLP, **_FRAME)),
    ("bidirectional_indivisible", "check_bidirectional",
     dict(spec=(RANKS,), spp=SPP, n_vlp=N_VLP_ODD, **_FRAME)),
    ("nodof", "check_nodof", dict(spec=("y", RANKS), **_FRAME)),
    ("super_2d", "check_super", dict(spec=(2, 2), spp=SPP, **_FRAME)),
    ("bidirectional_2d", "check_bidirectional",
     dict(spec=(2, 2), spp=SPP, n_vlp=N_VLP, **_FRAME)),
]


def _jax_references(jkey):
    """The JAX package's sharded renders of ``CASES`` by case id, and its
    VLP tables ("table_<n_vlp>")."""
    m1 = JPM.make_spp_mesh(RANKS)
    emit, jscn = JV.emit_vlps, JI.prep_scene(JSCENE)
    m2 = JPM.make_mesh_2d(2, 2)
    args = (jkey, JSCENE, W, H)
    return {
        "super": lambda: JPM.render_super_sharded(*args, SPP, m1),
        "trianglegrid": lambda: JPM.render_trianglegrid_sharded(
            *args, SPP, m1),
        "simple": lambda: JPM.render_simple_sharded(jkey, W, H, SPP, m1),
        "bidirectional": lambda: JPM.render_bidirectional_sharded(
            *args, SPP, m1, n_vlp=N_VLP),
        "bidirectional_indivisible": lambda: JPM.render_bidirectional_sharded(
            *args, SPP, m1, n_vlp=N_VLP_ODD),
        "nodof": lambda: JPM.render_sample_parallel_sharded(
            *args, 8, JPM.make_spp_mesh(RANKS, axis="y")),
        "super_2d": lambda: JPM.render_super_sharded_2d(*args, SPP, m2),
        "bidirectional_2d": lambda: JPM.render_bidirectional_sharded_2d(
            *args, SPP, m2, n_vlp=N_VLP),
        f"table_{N_VLP}": lambda: emit(jkey, jscn, N_VLP),
        f"table_{N_VLP_ODD}": lambda: emit(jkey, jscn, N_VLP_ODD),
    }


def serve_windows(table, n_items: int, count, start):
    """Rows [start, start + count) of each (light, slot) block of a
    light-major table of ``n_items`` rows a block, as the JAX light
    passes lay their windows out (the offset may be traced)."""
    t = jnp.asarray(table)
    if count is None:
        return t
    blocks = t.reshape(-1, n_items, 4)
    win = jax.lax.dynamic_slice_in_dim(
        blocks, jnp.asarray(start).astype(jnp.int32), count, axis=1)
    return win.reshape(-1, 4)


@contextlib.contextmanager
def jax_module_attr(module, name, fn):
    """``module.name`` replaced by ``fn``, and the JAX sharded programs
    compiled meanwhile dropped afterwards (they hold ``fn``)."""
    old, cached = getattr(module, name), set(JPM._COMPILED)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)
        for cfg in set(JPM._COMPILED) - cached:
            del JPM._COMPILED[cfg]


def run_cases(cases, references, patch):
    """The port's ``cases`` on RANKS spawned gloo ranks and the JAX
    ``references`` (case id -> thunk) in threads under the context
    ``patch``, at the same time.  Returns ({id: rank 0's check result},
    {id: JAX output})."""
    key, _ = keys()
    checks = [(name, dict(key=key, **kw)) for _, name, kw in cases]
    with patch, ThreadPoolExecutor(4) as ex:
        futs = {cid: ex.submit(fn) for cid, fn in references.items()}
        port = V.run_ranks(V.run_checks, RANKS, checks, device="cpu",
                           timeout=240)[0]
        jax_out = {cid: np.asarray(f.result()) for cid, f in futs.items()}
    return {cid: r for (cid, _, _), r in zip(cases, port)}, jax_out


@pytest.fixture(scope="module")
def results():
    key, jkey = keys()
    scn = prep_scene(TSCENE)
    port_tables = {n: emit_vlps(key, scn, n, device="cpu").numpy()
                   for n in (N_VLP, N_VLP_ODD)}

    def emit(key, scn, n_vlp, quirks=None, gi0=0, count=None):
        return serve_windows(port_tables[n_vlp], n_vlp, count, gi0)

    return run_cases(CASES, _jax_references(jkey),
                     jax_module_attr(JV, "emit_vlps", emit))


FILMS = [c[0] for c in CASES if c[0] != "nodof"]


@pytest.mark.parametrize("case", FILMS)
def test_sharded_film_matches_jax(results, case):
    port, jax_out = results
    r = port[case]
    assert r["ok"], r["detail"]       # against the port's unsharded film
    vlp = case.startswith("bidirectional")
    contract = SIMPLE if case == "simple" else XLA_VLP if vlp else SUPER
    ok, st = crn_ok(r["out"], jax_out[case], SPP, contract)
    assert ok, st
    assert r["out"].shape == (H, W, 3) and np.isfinite(r["out"]).all()
    if case != "simple":
        assert r["out"].std() > 1.0     # the frame holds content


@pytest.mark.parametrize("case,windowed", [
    ("bidirectional", True), ("bidirectional_indivisible", False),
    ("bidirectional_2d", True)])
def test_light_pass_table_matches_jax(results, case, windowed):
    """The gathered (or replicated) table: bit for bit the port's
    ``emit_vlps`` (the check), and the JAX table to the parity
    tolerance; the indivisible window renders the pass replicated."""
    port, jax_out = results
    r = port[case]
    assert r["windowed"] is windowed
    n_vlp = N_VLP_ODD if case.endswith("indivisible") else N_VLP
    want, got = jax_out[f"table_{n_vlp}"], r["table"]
    assert got.shape == want.shape == (2 * n_vlp, 4)
    np.testing.assert_array_equal(got[:, 3] > 0, want[:, 3] > 0)
    assert (got[:, 3] > 0).sum() >= 8
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert "table bit-equal" in r["detail"]


def test_nodof_bands(results):
    """Each rank's band bit for bit the single render's rows (the check),
    and the image against the JAX row-sharded one."""
    port, jax_out = results
    r = port["nodof"]
    assert r["ok"], r["detail"]
    got, want = r["out"], jax_out["nodof"]
    assert got.shape == want.shape == (H, W, 4) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.995


def test_launch_counts_stay_zero_on_the_cpu(results):
    """The CPU renders no kernel: the plain versions run."""
    port, _ = results
    for r in port.values():
        assert not any(r["counts"].values()), r["counts"]


def _one_rank_pairs(key):
    m = PM.make_spp_mesh(1, device="cpu")
    m2 = PM.make_mesh_2d(1, 1, device="cpu")
    my = PM.make_spp_mesh(1, axis="y", device="cpu")
    return {
        "super": (lambda: PM.render_super_sharded(key, TSCENE, W, H, 4, m),
                  lambda: render_super(key, TSCENE, W, H, 4, device="cpu")),
        "super_2d": (
            lambda: PM.render_super_sharded_2d(key, TSCENE, W, H, 4, m2),
            lambda: render_super(key, TSCENE, W, H, 4, device="cpu")),
        "simple": (lambda: PM.render_simple_sharded(key, W, H, 4, m),
                   lambda: render_simple(key, W, H, 4, device="cpu")),
        "trianglegrid": (
            lambda: PM.render_trianglegrid_sharded(key, TSCENE, W, H, 2, m),
            lambda: render_trianglegrid(key, TSCENE, W, H, 2,
                                        device="cpu")),
        "bidirectional": (
            lambda: PM.render_bidirectional_sharded(
                key, TSCENE, W, H, 4, m, n_vlp=N_VLP),
            lambda: render_bidirectional(key, TSCENE, W, H, 4, N_VLP,
                                         device="cpu")),
        "bidirectional_2d": (
            lambda: PM.render_bidirectional_sharded_2d(
                key, TSCENE, W, H, 4, m2, n_vlp=N_VLP),
            lambda: render_bidirectional(key, TSCENE, W, H, 4, N_VLP,
                                         device="cpu")),
        "metropolis": (
            lambda: PM.render_metropolis_sharded(
                key, TSCENE, W, H, 2, m, n_seedpaths=4, mutation_rounds=1,
                use_grid=True),
            lambda: render_metropolis(key, TSCENE, W, H, 2, 4, 1,
                                      use_grid=True, device="cpu")),
        "nodof": (
            lambda: PM.render_sample_parallel_sharded(key, TSCENE, W, H, 2,
                                                      my),
            lambda: render_sample_parallel(key, TSCENE, W, H, 2,
                                           device="cpu")),
    }


@pytest.mark.parametrize("case", ["super", "super_2d", "simple",
                                  "trianglegrid", "bidirectional",
                                  "bidirectional_2d", "metropolis", "nodof"])
def test_one_rank_mesh_is_the_unsharded_render(case):
    """A mesh of one rank outside any process group: identity
    collectives, one window - the unsharded film bit for bit."""
    key, _ = keys()
    sharded, single = _one_rank_pairs(key)[case]
    assert torch.equal(sharded(), single())


def test_mesh_layout_is_rank_major():
    """rank = iy * n_spp + isp, as ``jax.make_mesh((ny, ns), ("y",
    "spp"))`` lays devices out (JAX mesh.py's lin = iy * nspp + isp)."""
    dev = torch.device("cpu")
    for rank in range(6):
        m = PM.Mesh({"y": 3, "spp": 2}, dev, rank)
        assert (m.index("y"), m.index("spp")) == divmod(rank, 2)
        assert PM.Mesh({"spp": 6}, dev, rank).index("spp") == rank
    with pytest.raises(ValueError, match="not part of the mesh"):
        PM.Mesh({"spp": 2}, dev, None).index("spp")


def test_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="a mesh of 2 needs 2 ranks; have 1"):
        PM.make_spp_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        PM.make_mesh_2d(2, 2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        PM.render_super_sharded(keys()[0], TSCENE, W, H, 3,
                                PM.Mesh({"spp": 2}, torch.device("cpu"), 0))


def test_bench_multichip_rounds_spp_once(capsys):
    """The scaling harness rounds --spp and --n-vlp once, to a multiple of
    the largest rank count, before its sweep (the JAX tool rounded per
    rank count, so its speedups compared different work); every row
    prints that spp.  One rank in this process, at 8x8."""
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        bench_multichip as B)
    counts = B.rank_counts(8, cap=4)
    assert counts == [1, 2, 4]
    assert [B.round_once(v, counts) for v in (1024, 10, 3)] == [1024, 8, 4]
    assert B.main(["--device", "cpu", "--size", "8", "--spp", "3",
                   "--spp-local", "1", "--n-vlp", "5", "--repeats",
                   "1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["mode"] for r in rows] == ["strong", "weak", "strong"]
    assert rows[0]["config"] == "8x8 spp=3"
    assert rows[2]["config"] == "8x8 spp=3 n_vlp=5"
