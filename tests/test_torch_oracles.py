"""The port's NumPy oracles (``models/oracle_{super,bpt,mlt}.py``) against
the JAX package's, and the port's plain integrators against its oracles.

* Each port oracle is the same NumPy code on the port's own threefry
  twins, quirks and Scene: ``np.array_equal`` to its JAX oracle on the
  same scene, key and size, in the common-random-number (``key=``) mode
  and in the legacy ``np.random`` mode.
* The port's plain ``super`` and ``bidirectional`` films hold to the
  port's oracles under the contract of ``tests/test_crn.py``
  (``utils/crn.py`` ``ORACLE``: display-scale p98 < 1e-5, a tie budget of
  2%), on the content band of that file (rows 372+ of the first 296
  columns: floor and diffuse geometry).
* ``mlt_vlps`` holds to ``mlt_vlps_oracle`` with a chain match >= 0.9 and
  the Metropolis film differs from the oracle's by < 1e-5 on the display
  scale (``tests/test_mlt_oracle.py``: a borderline verification may flip
  between two float implementations and fork that one chain).
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.quirks import Quirks as JQuirks
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key as j_make_key
from opencl_montecarlo_path_tracing_tpu.models import oracle_bpt as JB
from opencl_montecarlo_path_tracing_tpu.models import oracle_mlt as JM
from opencl_montecarlo_path_tracing_tpu.models import oracle_super as JS
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, Quirks)
from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu_torch.models import oracle_bpt as TB
from opencl_montecarlo_path_tracing_tpu_torch.models import oracle_mlt as TM
from opencl_montecarlo_path_tracing_tpu_torch.models import oracle_super as TS
from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
    film_bidirectional, render_bidirectional)
from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
    mlt_vlps, render_metropolis)
from opencl_montecarlo_path_tracing_tpu_torch.models.super import render_super
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import ORACLE, crn_ok
from tests.test_render_super import small_scene as j_small_scene
from tests.test_torch_gpu import chain_match, small_scene
from tests.test_torch_utils import _one_thread_warm_sqrt  # noqa: F401

SUPER_ROW, SUPER_W = 372, 296


def _underlight(cls):
    """tests/test_mlt_oracle.py's scene: the light below the floor, so the
    Metropolis chains emit densely."""
    return cls(
        sphere_centers=np.array([[2, 0, -5], [-2, 1, -5]], np.float32),
        square_kj=np.zeros((0, 2), np.float32),
        triangles=np.zeros((0, 3, 3), np.float32),
        lights=np.array([[0, 0, -5, 100]], np.float32))


def assert_oracle(film, oracle, spp, min_var=1e-4):
    """The CRN contract, on a window that is not sky (the sky's smooth
    gradient has a variance orders below real geometry's)."""
    if hasattr(film, "numpy"):
        film = film.numpy()
    assert float(np.asarray(oracle).var()) > min_var
    ok, st = crn_ok(film, oracle, spp, ORACLE)
    assert ok, st


# (mode, quirks name): the CRN mode under both quirk sets, the legacy one
ORACLE_MODES = [("crn", "default"), ("crn", "reference"),
                ("legacy", "default")]


def _args(mode, qname, seed):
    tq = Quirks.reference() if qname == "reference" else DEFAULT
    jq = JQuirks.reference() if qname == "reference" else JQuirks()
    if mode == "crn":
        return (dict(key=make_key(seed), quirks=tq),
                dict(key=j_make_key(seed), quirks=jq))
    return dict(seed=seed, quirks=tq), dict(seed=seed, quirks=jq)


@pytest.mark.parametrize("mode,qname", ORACLE_MODES)
def test_oracle_super_equals_jax(mode, qname):
    tk, jk = _args(mode, qname, 7)
    got = TS.render_oracle_super(small_scene(), 40, 4, spp=2,
                                 row_offset=SUPER_ROW, **tk)
    want = JS.render_oracle_super(j_small_scene(), 40, 4, spp=2,
                                  row_offset=SUPER_ROW, **jk)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("mode,qname", ORACLE_MODES)
def test_oracle_bpt_equals_jax(mode, qname):
    tk, jk = _args(mode, qname, 8)
    got = TB.render_oracle_bpt(small_scene(), 40, 4, spp=2, n_vlp=32,
                               row_offset=SUPER_ROW, **tk)
    want = JB.render_oracle_bpt(j_small_scene(), 40, 4, spp=2, n_vlp=32,
                                row_offset=SUPER_ROW, **jk)
    assert np.array_equal(got, want)
    tv = TB.emit_vlps_oracle(small_scene(), 32, np.random.default_rng(1),
                             tk["quirks"], key=tk.get("key"))
    jv = JB.emit_vlps_oracle(j_small_scene(), 32, np.random.default_rng(1),
                             jk["quirks"], key=jk.get("key"))
    assert np.array_equal(tv, jv)


def test_oracle_mlt_equals_jax():
    tv = TM.mlt_vlps_oracle(_underlight(Scene), make_key(41), 16, 3)
    jv = JM.mlt_vlps_oracle(_underlight(JScene), j_make_key(41), 16, 3)
    assert (tv[:, 3] > 0).sum() >= 5 and np.array_equal(tv, jv)
    got = TM.render_oracle_mlt(_underlight(Scene), 24, 4, spp=2,
                               n_seedpaths=8, mutation_rounds=2,
                               key=make_key(42), row_offset=SUPER_ROW)
    want = JM.render_oracle_mlt(_underlight(JScene), 24, 4, spp=2,
                                n_seedpaths=8, mutation_rounds=2,
                                key=j_make_key(42), row_offset=SUPER_ROW)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("qname", ["default", "reference"])
def test_plain_super_holds_to_oracle(qname):
    q = Quirks.reference() if qname == "reference" else DEFAULT
    key, spp, rows = make_key(7), 2, 8
    film = render_super(key, small_scene(), SUPER_W, SUPER_ROW + rows,
                        spp=spp, quirks=q, device="cpu")[SUPER_ROW:]
    orc = TS.render_oracle_super(small_scene(), SUPER_W, rows, spp=spp,
                                 key=key, quirks=q, row_offset=SUPER_ROW)
    assert float(orc.var()) > 1e-2
    assert_oracle(film, orc, spp)


def test_plain_super_windows_hold_to_oracle():
    """Two spp windows of the plain film sum to the oracle's full sample
    space: ray ids, not the order of the draws, define the samples."""
    key, rows = make_key(11), 4
    a, b = (render_super(key, small_scene(), 8, SUPER_ROW + rows, spp=2,
                         spp_offset=off, spp_total=4,
                         device="cpu")[SUPER_ROW:] for off in (0, 2))
    orc = TS.render_oracle_super(small_scene(), 8, rows, spp=4, key=key,
                                 row_offset=SUPER_ROW)
    assert_oracle(a + b, orc, 4)


def test_plain_bidirectional_holds_to_oracle():
    key, spp, rows = make_key(10), 2, 8
    film = render_bidirectional(key, small_scene(), SUPER_W,
                                SUPER_ROW + rows, spp=spp, n_vlp=32,
                                device="cpu")[SUPER_ROW:]
    orc = TB.render_oracle_bpt(small_scene(), SUPER_W, rows, spp=spp,
                               n_vlp=32, key=key, row_offset=SUPER_ROW)
    assert_oracle(film, orc, spp)


def test_plain_bidirectional_gather_holds_to_oracle():
    """The gather under CRN with a table that is live over the band's floor
    points (tests/test_crn.py::test_bidirectional_gather_crn_live_vlps)."""
    key, spp, rows = make_key(12), 2, 8
    rng = np.random.RandomState(0)
    v = np.zeros((24, 4), np.float32)
    live = rng.choice(24, 10, replace=False)
    v[live, 0] = rng.uniform(18.0, 30.0, 10)
    v[live, 1] = rng.uniform(-95.0, -55.0, 10)
    v[live, 2] = rng.uniform(1.0, 6.0, 10)
    v[live, 3] = rng.uniform(1.0, 8.0, 10)
    film = film_bidirectional(key, prep_scene(small_scene()), 40,
                              SUPER_ROW + rows, spp, 0, spp, 8, DEFAULT,
                              precomputed_vlps=torch.from_numpy(v),
                              device="cpu")[SUPER_ROW:]
    orc = TB.render_with_vlps(small_scene(), v, 40, rows, spp=spp, key=key,
                              row_offset=SUPER_ROW)
    zero = TB.render_with_vlps(small_scene(), np.zeros_like(v), 40, rows,
                               spp=spp, key=key, row_offset=SUPER_ROW)
    assert np.abs(orc - zero).max() > 1e-3        # the gather contributes
    assert_oracle(film, orc, spp, min_var=0.0)


@pytest.mark.parametrize("scene_name", ["underlight", "small"])
def test_mlt_vlps_hold_to_oracle(scene_name):
    scene = _underlight(Scene) if scene_name == "underlight" \
        else small_scene()
    n = 64 if scene_name == "underlight" else 96
    key = make_key(41 if scene_name == "underlight" else 123)
    tv = mlt_vlps(key, prep_scene(scene), n, 4, device="cpu").numpy()
    ov = TM.mlt_vlps_oracle(scene, key, n, 4)
    assert tv.shape == ov.shape == (n * 4 * scene.n_lights, 4)
    if scene_name == "underlight":
        assert (tv[:, 3] > 0).sum() >= 20
    assert chain_match(tv, ov, n) >= 0.9


def test_mlt_film_holds_to_oracle():
    key, spp, rows = make_key(42), 2, 8
    film = render_metropolis(key, _underlight(Scene), 24, SUPER_ROW + rows,
                             spp=spp, n_seedpaths=32, mutation_rounds=2,
                             device="cpu")[SUPER_ROW:].numpy()
    orc = TM.render_oracle_mlt(_underlight(Scene), 24, rows, spp=spp,
                               n_seedpaths=32, mutation_rounds=2, key=key,
                               row_offset=SUPER_ROW)
    d = np.abs(film - orc) / spp * 64.0 / 255.0
    assert float(d.max()) < 1e-5, float(d.max())
