"""The port's utilities (``utils/{metrics,profiling,checkpoint,debug}.py``)
against the JAX package's.

* metrics: the same NumPy functions, equal to the last bit on seeded
  arrays;
* the stage report: the same string for the same recorded stages;
* checkpoints: the same ``.npz`` layout, so a file written by either
  package loads in the other with the same array; an incompatible one
  restarts the render;
* ``render_resumable`` over the port's plain ``render_super`` at 12x12x8
  in windows of 3, and after a crash, against the one-shot film at atol
  2e-3 (the JAX test's, ``tests/test_checkpoint_and_2d.py``), and against
  the JAX package's ``render_resumable`` under the common-random-number
  contract of ``utils/crn.py`` (both consume the same threefry streams);
* the DDA's debug hook prints one aggregate line a call with
  ``PT_KERNEL_DEBUG=1`` and reduces nothing without it.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.rng import make_key as j_make_key
from opencl_montecarlo_path_tracing_tpu.models.super import (
    film_super as j_film_super, render_super as j_render_super)
from opencl_montecarlo_path_tracing_tpu.ops.intersect import (
    prep_scene as j_prep_scene)
from opencl_montecarlo_path_tracing_tpu.utils import checkpoint as JC
from opencl_montecarlo_path_tracing_tpu.utils import metrics as JMet
from opencl_montecarlo_path_tracing_tpu.utils import profiling as JProf
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu_torch.models.super import (
    film_super, render_super)
from opencl_montecarlo_path_tracing_tpu_torch.models.trianglegrid import (
    render_trianglegrid)
from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import demo_scene
from opencl_montecarlo_path_tracing_tpu_torch.utils import checkpoint as TC
from opencl_montecarlo_path_tracing_tpu_torch.utils import debug as TD
from opencl_montecarlo_path_tracing_tpu_torch.utils import metrics as TMet
from opencl_montecarlo_path_tracing_tpu_torch.utils import profiling as TProf
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_render_super import small_scene as j_small_scene
from tests.test_torch_gpu import small_scene

# tests/test_crn.py's content band: rows 372+ hold floor and ~480 diffuse
# pixels in the first 296 columns
SUPER_ROW, SUPER_W = 372, 296


@pytest.fixture(autouse=True, scope="module")
def _one_thread_warm_sqrt():
    """One torch thread, and the process's first torch.sqrt taken here (it
    has been seen to return one segment off by ~2e-4 with torch 2.13.0+cpu
    on an AVX-512 CPU; tests/test_torch_diag_dda.py), so that no camera
    ray below is it.  The other new test files of the port import it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.sqrt(torch.rand(16384) * 400.0)
    yield
    torch.set_num_threads(threads)


def _pair(seed):
    g = np.random.default_rng(seed)
    a = g.uniform(0, 255, (16, 12, 3)).astype(np.float32)
    return a, a + g.normal(0, 4, a.shape).astype(np.float32)


@pytest.mark.parametrize("name", ["rmse", "rmse_u8", "correlation", "psnr"])
def test_metrics_equal_jax(name):
    a, b = _pair(3)
    for x, y in ((a, b), (b, a), (a, a)):
        assert getattr(TMet, name)(x, y) == getattr(JMet, name)(x, y)
    # a tensor is read like the array it holds
    assert getattr(TMet, name)(torch.from_numpy(a), torch.from_numpy(b)) \
        == getattr(JMet, name)(a, b)


def test_spp_to_rmse_equals_jax():
    a, _ = _pair(4)
    g = np.random.default_rng(5)
    noise = {s: g.normal(0, 64.0 / np.sqrt(s), a.shape).astype(np.float32)
             for s in (16, 32, 64, 128, 256, 512, 1024, 2048)}
    for target in (4.0, 1.0, 1e-3):
        got = TMet.spp_to_rmse(lambda s: torch.from_numpy(a + noise[s]), a,
                               target)
        want = JMet.spp_to_rmse(lambda s: a + noise[s], a, target)
        assert got == want
    assert TMet.psnr(a, a) == float("inf")


def _recorded(mod):
    t = mod.StageTimer()
    t.record("light tracer", 1.25, items=1024, item_label="VLPs",
             data_size=16384)
    t.record("rendering", 12.3, items=262144, item_label="pixels",
             data_size=262144 * 4)
    t.record("Read VLPs bounding box", 0.0, items=1, item_label="box",
             data_size=32)
    return t


def test_stage_report_equals_jax():
    assert _recorded(TProf).report() == _recorded(JProf).report()
    assert _recorded(TProf).report().endswith("Total time: 13.55 ms.")


def test_stage_run_records_and_returns(capsys):
    t = TProf.StageTimer("cpu")
    out = t.run("rendering", lambda: torch.ones(4), items=4,
                item_label="pixels", data_size=16)
    assert torch.equal(out, torch.ones(4))
    (s,) = t.stages
    assert (s.name, s.items, s.item_label, s.data_size) == \
        ("rendering", 4, "pixels", 16)
    assert s.ms > 0
    t.print_report()
    assert capsys.readouterr().out.startswith("rendering : 4 pixels in ")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    film = np.random.default_rng(6).normal(0, 1, (5, 7, 3)).astype(np.float32)
    w, r = (JC, TC) if writer == "jax" else (TC, JC)
    path = str(tmp_path / "film.npz")
    w.FilmCheckpoint(film=film, spp_done=3, spp_total=8, seed=9,
                     meta={"width": 7, "height": 5}).save(path)
    back = r.FilmCheckpoint.load(path)
    np.testing.assert_array_equal(back.film, film)
    assert back.film.dtype == np.float32
    assert (back.spp_done, back.spp_total, back.seed) == (3, 8, 9)
    assert back.meta == {"width": "7", "height": "5"}


def _counting(calls):
    def render(key, scene, w, h, spp, spp_offset, spp_total, **kw):
        calls.append((spp, spp_offset, spp_total))
        return torch.full((h, w, 3), float(spp))
    return render


@pytest.mark.parametrize("change", ["spp_total", "seed", "shape", "meta",
                                    "missing_meta"])
def test_incompatible_checkpoint_restarts(tmp_path, change):
    path = str(tmp_path / "film.npz")
    TC.FilmCheckpoint(film=np.full((4, 4, 3), 100.0, np.float32),
                      spp_done=2, spp_total=6, seed=1,
                      meta={} if change == "missing_meta"
                      else {"variant": "super"}).save(path)
    args = {"spp_total": 6, "seed": 1, "w": 4}
    changed = {"spp_total": "spp_total", "seed": "seed", "shape": "w"}
    if change in changed:
        args[changed[change]] += 2
    meta = {"variant": "bidirectional" if change == "meta" else "super"}
    calls = []
    ck = TC.render_resumable(_counting(calls), (0, 0), None, args["w"], 4,
                             args["spp_total"], checkpoint_path=path,
                             spp_per_step=4, seed=args["seed"], meta=meta)
    assert calls[0][1] == 0                      # from sample 0
    assert ck.spp_done == args["spp_total"]
    np.testing.assert_array_equal(
        ck.film, np.full((4, args["w"], 3), args["spp_total"], np.float32))
    assert TC.FilmCheckpoint.load(path).meta["variant"] == meta["variant"]
    # a compatible one resumes where it left off
    calls.clear()
    TC.FilmCheckpoint(film=np.zeros((4, 4, 3), np.float32), spp_done=2,
                      spp_total=6, seed=1, meta={"variant": "super"}).save(
                          path)
    TC.render_resumable(_counting(calls), (0, 0), None, 4, 4, 6,
                        checkpoint_path=path, spp_per_step=3, seed=1,
                        meta={"variant": "super"})
    assert calls == [(3, 2, 6), (1, 5, 6)]


def _cpu_super(key, scene, w, h, **kw):
    return render_super(key, scene, w, h, device="cpu", **kw)


def test_render_resumable_matches_one_shot(tmp_path):
    key = make_key(55)
    scene = small_scene()
    w = h = 12
    spp = 8
    path = str(tmp_path / "film.npz")
    ck = TC.render_resumable(_cpu_super, key, scene, w, h, spp,
                             checkpoint_path=path, spp_per_step=3, seed=7)
    assert ck.spp_done == spp and ck.film.dtype == np.float32
    # re-entering with a completed checkpoint is a no-op
    ck2 = TC.render_resumable(_cpu_super, key, scene, w, h, spp,
                              checkpoint_path=path, spp_per_step=3, seed=7)
    np.testing.assert_array_equal(ck.film, ck2.film)
    single = render_super(key, scene, w, h, spp=spp, device="cpu").numpy()
    np.testing.assert_allclose(ck.film, single, rtol=0, atol=2e-3)
    back = TC.FilmCheckpoint.load(path)
    assert back.spp_done == spp and back.seed == 7
    np.testing.assert_array_equal(back.film, ck.film)


def test_crash_mid_render_then_resume(tmp_path):
    key = make_key(56)
    scene = small_scene()
    path = str(tmp_path / "film.npz")
    calls = {"n": 0}

    def crashing_render(*args, **kw):
        if calls["n"] >= 1:
            raise RuntimeError("boom")
        calls["n"] += 1
        return _cpu_super(*args, **kw)

    with pytest.raises(RuntimeError, match="boom"):
        TC.render_resumable(crashing_render, key, scene, 8, 8, 8,
                            checkpoint_path=path, spp_per_step=4, seed=1)
    mid = TC.FilmCheckpoint.load(path)
    assert mid.spp_done == 4 and mid.spp_total == 8
    ck = TC.render_resumable(_cpu_super, key, scene, 8, 8, 8,
                             checkpoint_path=path, spp_per_step=4, seed=1)
    single = render_super(key, scene, 8, 8, spp=8, device="cpu").numpy()
    np.testing.assert_allclose(ck.film, single, rtol=0, atol=2e-3)


def test_render_resumable_matches_jax_crn(tmp_path):
    """Both packages' resumable renders of the same windows, on the frame's
    content rows (a band of ``film_super``: floor and diffuse geometry,
    tests/test_crn.py's band), under the CRN contract."""
    rows, w, spp = 4, SUPER_W, 6
    t_scn, j_scn = prep_scene(small_scene()), j_prep_scene(j_small_scene())

    def t_band(key, scn, w, h, spp, spp_offset, spp_total):
        return film_super(key, scn, w, SUPER_ROW + h, spp, spp_offset,
                          spp_total, DEFAULT, row_offset=SUPER_ROW,
                          rows=h, device="cpu")

    def j_band(key, scn, w, h, spp, spp_offset, spp_total):
        from opencl_montecarlo_path_tracing_tpu.core.quirks import (
            DEFAULT as JD)
        return j_film_super(key, scn, w, SUPER_ROW + h, spp, spp_offset,
                            spp_total, JD, row_offset=SUPER_ROW, rows=h)

    got = TC.render_resumable(t_band, make_key(57), t_scn, w, rows, spp,
                              checkpoint_path=str(tmp_path / "t.npz"),
                              spp_per_step=4, seed=57)
    want = JC.render_resumable(j_band, j_make_key(57), j_scn, w, rows, spp,
                               checkpoint_path=str(tmp_path / "j.npz"),
                               spp_per_step=4, seed=57)
    assert float(got.film.var()) > 1e-2          # real content, not sky
    ok, st = crn_ok(got.film, want.film, spp)
    assert ok, st
    # the JAX package's checkpoint resumes in the port to the same film
    ck = TC.render_resumable(t_band, make_key(57), t_scn, w, rows, spp,
                             checkpoint_path=str(tmp_path / "j.npz"),
                             spp_per_step=4, seed=57)
    np.testing.assert_array_equal(ck.film, want.film)
    # and at the JAX test's frame, the whole-frame renderers
    one = TC.render_resumable(_cpu_super, make_key(58), small_scene(), 12,
                              12, 8, spp_per_step=3, seed=1)
    two = JC.render_resumable(j_render_super, j_make_key(58),
                              j_small_scene(), 12, 12, 8, spp_per_step=3,
                              seed=1)
    ok, st = crn_ok(one.film, two.film, 8)
    assert ok, st


def _dda_band():
    scene = demo_scene()[0]
    return render_trianglegrid(make_key(1), scene, 8, 8, spp=1,
                               accel="dda", device="cpu")


def test_debug_hook_prints_with_the_flag(monkeypatch, capsys):
    monkeypatch.setenv("PT_KERNEL_DEBUG", "1")
    assert TD.enabled()
    _dda_band()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[grid DDA] rays=")]
    assert lines, "no debug line"
    entered = 0
    for ln in lines:
        fields = dict(kv.split("=") for kv in ln.split("] ")[1].split())
        assert set(fields) == {"rays", "entered", "cells_visited",
                               "tri_hits"}
        assert 0 <= int(fields["entered"]) <= int(fields["rays"])
        entered += int(fields["entered"])
    assert entered > 0      # some (shadow) rays walk the grid


def test_debug_hook_is_silent_without_the_flag(monkeypatch, capsys):
    monkeypatch.delenv("PT_KERNEL_DEBUG", raising=False)
    assert not TD.enabled()

    def fail(*a, **kw):
        raise AssertionError("the hook ran with the flag unset")
    monkeypatch.setattr(G.dbg, "dprint", fail)
    _dda_band()
    assert "[grid DDA]" not in capsys.readouterr().out
