"""The VLP slice end to end - bidirectional, metropolis, metropolis_vlpgrid
- against the JAX package, and the Metropolis light pass on its own.

Tolerances, each with its reason:

* ``mlt_vlps``: the live mask is equal and the table agrees to rtol =
  atol = 1e-5 (directions go through cos/sin, whose float32
  implementations may differ by an ulp).  The JAX side runs op by op
  (``jax.disable_jit``): compiled, XLA:CPU contracts multiply-adds into
  FMAs, and one flipped ``verify_eps`` decision would change a whole row;
* films: the CRN contract of ``tools/validate_crn_frame.py`` (utils/crn.py:
  display-scale p99.5 < 1e-5, ties > 1e-4 on < 0.6% of pixels).  On the
  content band the JAX render pass runs op by op for the same reason:
  compiled, the FMA contraction moves the capped shadow rays of the
  horizon floor hits (rows 253-256 of the 512-row camera) on ~0.6% of a
  40x320 band, past the contract's budget.  The JAX light pass runs
  compiled (op by op the Metropolis chain takes minutes), is held against
  the port's light pass here, and is handed to the JAX render through its
  module attribute;
* the CLI's PAM: equal to ``api.render(..., as_rgba8=True)`` with the same
  arguments, byte for byte.
"""

import functools

import numpy as np
import pytest
import torch
import jax

import opencl_montecarlo_path_tracing_tpu as jpt
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models import metropolis as JM
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.ops import vlp as JV
from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
    demo_scene as j_demo_scene, dense_vlp_scene as j_dense_vlp_scene)
import opencl_montecarlo_path_tracing_tpu_torch as tpt
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    key_from_jax, scene_arrays_from_numpy)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
from opencl_montecarlo_path_tracing_tpu_torch.models import metropolis as TM
from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    demo_scene, procedural_super_scene, write_scene_files)
from opencl_montecarlo_path_tracing_tpu_torch.utils import cli
from opencl_montecarlo_path_tracing_tpu_torch.utils import pam as TP
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok

# the demo scene emits few live VLPs (the reference scene ~1%); this seed
# gives both light passes live rows at these small sizes
SEED = 9
N_VLP = 128                      # per light
N_SEED, ROUNDS = 32, 2           # Metropolis chains per light, rounds


def _assert_tables_agree(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 3] > 0, want[:, 3] > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, (3, 4)])
def test_mlt_vlps_matches_jax(window):
    """8 chains x 2 rounds on the dense-VLP scene (most chains emit), and
    a chain0/chains window, which equals the same rows of the full run."""
    jscn = JI.prep_scene(j_dense_vlp_scene())
    tscn = scene_arrays_from_numpy(jscn)
    key = make_key(3)
    kw = {} if window is None else dict(chain0=window[0], chains=window[1])
    with jax.disable_jit():
        want = np.asarray(JM.mlt_vlps(key, jscn, 8, 2, **kw))
    got = TM.mlt_vlps(key_from_jax(key), tscn, 8, 2, device="cpu",
                      **kw).numpy()
    assert (want[:, 3] > 0).sum() >= 4
    _assert_tables_agree(got, want)
    if window is not None:
        full = TM.mlt_vlps(key_from_jax(key), tscn, 8, 2,
                           device="cpu").numpy()
        c0, n = window
        # layout [light][slot][chain]
        rows = np.concatenate([np.arange(c0, c0 + n) + 8 * blk
                               for blk in range(2 * 4)])
        np.testing.assert_array_equal(got, full[rows])


def test_mlt_seed_state_matches_jax():
    jscn = JI.prep_scene(j_dense_vlp_scene())
    with jax.disable_jit():
        jv, jl = JM.mlt_seed(make_key(5), jscn, 8)
    tv, tl = TM.mlt_seed(key_from_jax(make_key(5)),
                         scene_arrays_from_numpy(jscn), 8, device="cpu")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_light_pass(kind):
    """The JAX package's light pass on the demo scene, compiled, and the
    port's, both as numpy: the emitted table or the Metropolis table."""
    jscn = JI.prep_scene(j_demo_scene()[0])
    tscn = scene_arrays_from_numpy(jscn)
    key = make_key(SEED)
    if kind == "bpt":
        want = np.asarray(jax.jit(
            lambda k: JV.emit_vlps(k, jscn, N_VLP))(key))
        got = TV.emit_vlps(key_from_jax(key), tscn, N_VLP,
                           device="cpu").numpy()
    else:
        want = np.asarray(jax.jit(
            lambda k: JM.mlt_vlps(k, jscn, N_SEED, ROUNDS))(key))
        got = TM.mlt_vlps(key_from_jax(key), tscn, N_SEED, ROUNDS,
                          device="cpu").numpy()
    return want, got


@pytest.mark.parametrize("kind", ["bpt", "mlt"])
def test_light_pass_on_demo_scene_matches_jax(kind):
    want, got = jax_light_pass(kind)
    assert (want[:, 3] > 0).any()
    _assert_tables_agree(got, want)


SLICE = [("bidirectional", {}), ("metropolis", {}),
         ("metropolis_vlpgrid", {}),
         ("metropolis_vlpgrid", {"dynamic_grid_res": True})]
SIZES = [(24, 24, 4), (40, 320, 2)]   # a sky corner; down to the floor


@pytest.mark.parametrize("size", SIZES, ids=["sky", "content"])
@pytest.mark.parametrize("case", SLICE,
                         ids=["bidirectional", "metropolis",
                              "metropolis_vlpgrid", "vlpgrid_dynamic_res"])
def test_render_matches_jax(case, size, monkeypatch):
    variant, extra = case
    w, h, spp = size
    kw = dict(extra)
    if variant == "bidirectional":
        kw["n_vlp"] = N_VLP
        table = jax_light_pass("bpt")[0]
        monkeypatch.setattr(JV, "emit_vlps",
                            lambda *a, **k: jax.numpy.asarray(table))
    else:
        kw.update(n_seedpaths=N_SEED, mutation_rounds=ROUNDS)
        table = jax_light_pass("mlt")[0]
        monkeypatch.setattr(JM, "mlt_vlps",
                            lambda *a, **k: jax.numpy.asarray(table))
    def jax_render():
        return np.asarray(jpt.render(variant, j_demo_scene()[0], w, h,
                                     spp=spp, seed=SEED, **kw))
    if h > 256:           # down to the horizon: no FMA contraction
        with jax.disable_jit():
            want = jax_render()
    else:
        want = jax_render()
    got = tpt.render(variant, demo_scene()[0], w, h, spp=spp, seed=SEED,
                     device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (h, w, 3)
    ok, st = crn_ok(got, want, spp)
    assert ok, st
    if h > 256:
        assert want[260:].var() > 1e-3    # the floor band is rendered


@pytest.mark.parametrize("args", [
    ["bidirectional", "32", "32", "64"],
    ["metropolis_vlpgrid", "32", "32", "16", "2", "3.0"],
], ids=["bidirectional", "metropolis_vlpgrid"])
def test_cli_vlp_subcommands_write_pam(args, tmp_path, monkeypatch, capsys):
    scene_dir = tmp_path / "scene"
    write_scene_files(procedural_super_scene(), str(scene_dir))
    monkeypatch.chdir(tmp_path)
    assert cli.main(args + ["--spp", "2", "--seed", "1", "--scene-dir",
                            str(scene_dir), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "light pass" in out and "GB/s" in out
    img = TP.load_pam(str(tmp_path / "result.ppm"))
    assert (img.width, img.height, img.channels) == (32, 32, 4)
    variant, w, h = args[0], int(args[1]), int(args[2])
    kw = (dict(n_vlp=int(args[3])) if variant == "bidirectional" else
          dict(n_seedpaths=int(args[3]), mutation_rounds=int(args[4]),
               grid_modifier=float(args[5])))
    want = tpt.render(variant, procedural_super_scene(), w, h, spp=2, seed=1,
                      as_rgba8=True, device="cpu", **kw)
    np.testing.assert_array_equal(img.data, want)


def test_dynamic_grid_res_mode_reads_the_box():
    """dynamic_grid_res takes the reference's box-derived resolution and
    renders the same film as film_metropolis with that res passed in."""
    scn = scene_arrays_from_numpy(JI.prep_scene(j_demo_scene()[0]))
    key = (41, 0)
    vlps = TM.mlt_vlps(key, scn, 32, 2, device="cpu")
    lo, hi = (b.numpy() for b in TV.vlp_bounds(vlps))
    assert lo[0] < hi[0]
    res = TV.vlp_grid_dynamic_res(lo, hi, int(vlps.shape[0]))
    dyn = TM.render_metropolis(key, scn, 24, 24, spp=2, n_seedpaths=32,
                               mutation_rounds=2, use_grid=True,
                               dynamic_grid_res=True, device="cpu")
    manual = TM.film_metropolis(key, scn, 24, 24, 2, 0, 2, 32, 2,
                                DEFAULT, use_grid=True,
                                precomputed_vlps=vlps, grid_res=res,
                                device="cpu")
    torch.testing.assert_close(dyn, manual, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["bidirectional", "metropolis",
                                     "metropolis_vlpgrid"])
def test_cuda_request_never_falls_back_to_cpu(variant):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA request is served")
    with pytest.raises(RuntimeError, match="is_available"):
        tpt.render(variant, demo_scene()[0], 8, 8, spp=1, device="cuda")


def test_cuda_route_is_decided_from_the_configuration():
    """B4 when its gate passes - every quirk set and mesh size, past 512
    triangles over the exact grid; the tier-1 wavefront (gather B6,
    whose traces of a mesh of >= 2048 triangles are kernel B7) only for
    more than 8 lights or max_bounces < 1."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        REFERENCE, REFERENCE_LMEM)
    from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
        cuda_route)
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
    demo = prep_scene(demo_scene()[0])
    assert cuda_route(demo, DEFAULT) == "mega_vlp"
    assert cuda_route(demo, REFERENCE) == "mega_vlp"
    assert cuda_route(demo, REFERENCE_LMEM) == "mega_vlp"
    assert cuda_route(demo, DEFAULT, max_bounces=0) == "tier1"
    base = demo_scene()[0]
    tri = np.random.default_rng(0).uniform(0, 10, (2048, 3, 3))
    big = prep_scene(Scene(sphere_centers=base.sphere_centers,
                           square_kj=base.square_kj,
                           triangles=tri.astype(np.float32),
                           lights=base.lights))
    assert cuda_route(big, DEFAULT) == "mega_vlp"
    nine = prep_scene(Scene(sphere_centers=base.sphere_centers,
                            square_kj=base.square_kj,
                            triangles=base.triangles,
                            lights=np.tile(base.lights, (5, 1))[:9]))
    assert cuda_route(nine, DEFAULT) == "tier1"


@pytest.mark.parametrize("sheet", [(30, 30), (144, 72)],
                         ids=["1800", "20736"])
def test_cuda_route_on_the_sheets(sheet):
    """The 1,800- and 20,736-triangle sheets render on B4's walk route under
    every quirk set, so a grid render there builds only the grid's frame
    (C1 on large meshes); a 9-light copy and max_bounces 0 stay on tier 1,
    with the full grid."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        REFERENCE, REFERENCE_LMEM)
    from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
        cuda_route, grid_frame_only)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M4
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
    scene = large_mesh_scene(*sheet)
    scn = prep_scene(scene)
    cuda = torch.device("cuda")
    assert M4.uses_walk(scn)
    for q in (DEFAULT, REFERENCE, REFERENCE_LMEM):
        assert cuda_route(scn, q) == "mega_vlp"
        assert grid_frame_only(scn, q, 5, cuda)
    assert cuda_route(scn, DEFAULT, max_bounces=0) == "tier1"
    assert not grid_frame_only(scn, DEFAULT, 0, cuda)
    nine = prep_scene(Scene(sphere_centers=scene.sphere_centers,
                            square_kj=scene.square_kj,
                            triangles=scene.triangles,
                            lights=np.tile(scene.lights, (5, 1))[:9]))
    assert cuda_route(nine, REFERENCE_LMEM) == "tier1"
    assert not grid_frame_only(nine, DEFAULT, 5, cuda)
