"""The port against the JAX package's stored estimator record
(``tests/fixtures/films.npz``, ``tools/make_regression_films.py``) for the
six variants that ``tests/test_torch_slice.py::test_regression_fixture``
(``super``) does not hold: ``simple``, ``trianglegrid``, ``nodof``,
``bidirectional``, ``metropolis`` and ``metropolis_vlpgrid``.

The shapes and seeds are the fixture's own (make_regression_films.py:39-63):
the full 512x512 view at 1 spp (``nodof`` at 4, a 2x2 sample grid), seed
11, ``procedural_super_scene()``, ``n_vlp=64``, ``n_seedpaths=32`` and
``mutation_rounds=2``.  The record is a 16x16 block-mean summary, held at
its own tolerance, rtol = atol = 2e-3.

* ``simple``, ``trianglegrid`` and ``nodof``: the port's plain film on the
  CPU against the record directly.
* The VLP family: the record holds XLA:CPU's compiled film, whose
  multiply-adds are contracted into FMAs.  Those flip capped shadow rays
  on razor-edge pixels: on the bidirectional film, 182 of 262,144 pixels
  differ between the port and compiled JAX by a whole occlusion unit
  (2.625 or 1.3125), and JAX run op by op (``jax.disable_jit``) flips the
  same 182 against compiled JAX and only 2 against the port.  Enough of
  them fall in some 32x32 blocks to move their means past 2e-3.  So the
  port's film is held to compiled JAX's, rendered here, under the VLP
  family's CRN contract (``utils/crn.py`` SUPER: its tie budget is 0.6%,
  these are 0.069%); then the tie pixels (display difference above the
  contract's ``tie_thresh``) take JAX's values, and that film's summary
  must match the record at its tolerance.  Every pixel outside the ties is
  held to the record, the ties to the CRN budget; neither tolerance is
  loosened.  Compiled JAX's own summary must match the record, so the
  record still anchors the comparison.
* At these shapes the VLP family's light pass emits no live VLP (0 of
  128 on ``procedural_super_scene()``, asserted below): these cases guard
  the family's render pass.  Its light pass is held by the NumPy oracles
  (``tests/test_torch_gpu.py::hold_light_pass_to_oracles``) and its plain
  version.

The ``gpu`` cases run the same renders through the kernels on the card
(B5 for ``simple``; B1 for ``super``, ``trianglegrid`` and ``nodof``;
L1 / L2a + L2b and B4 for the VLP family), where no JAX is installed: the
first four against the record, the VLP films against the port's CPU plain
film (which the CPU cases tie to the record) under the CRN contract.  The
file imports JAX only inside the CPU cases.
"""

import os

import numpy as np
import pytest
import torch

import opencl_montecarlo_path_tracing_tpu_torch as tpt
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import (
    SUPER, crn_ok, crn_stats)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "films.npz")
SIZE, SEED = 512, 11
TOL = dict(rtol=2e-3, atol=2e-3)       # the record's own tolerance
# the fixture's per-variant options (make_regression_films.py:39-63)
OPTIONS = {"simple": dict(spp=1), "super": dict(spp=1),
           "trianglegrid": dict(spp=1), "nodof": dict(spp=4),
           "bidirectional": dict(spp=1, n_vlp=64),
           "metropolis": dict(spp=1, n_seedpaths=32, mutation_rounds=2),
           "metropolis_vlpgrid": dict(spp=1, n_seedpaths=32,
                                      mutation_rounds=2)}
VLP_FAMILY = ("bidirectional", "metropolis", "metropolis_vlpgrid")


def summarize(film) -> np.ndarray:
    """tools/make_regression_films.py::summarize: (512, 512, 3) -> the
    (16, 16, 3) block means."""
    f = np.asarray(film, np.float32)
    return f.reshape(16, 32, 16, 32, 3).mean(axis=(1, 3))


def record(name) -> np.ndarray:
    return np.load(FIXTURE)[name]


def port_film(name, device) -> np.ndarray:
    """The port's film of the fixture's render (``nodof``: its RGBA8
    image's colour channels, as the record stores them)."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        procedural_super_scene)
    scene = None if name == "simple" else procedural_super_scene()
    out = tpt.render(name, scene, SIZE, SIZE, seed=SEED, device=device,
                     **OPTIONS[name])
    if name == "nodof":
        return out[..., :3].astype(np.float32)
    return out.cpu().numpy()


def jax_film(name) -> np.ndarray:
    """Compiled JAX's film of the fixture's render (the JAX package,
    unchanged), as the record was made."""
    import opencl_montecarlo_path_tracing_tpu as jpt
    from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
        procedural_super_scene)
    return np.asarray(jpt.render(name, procedural_super_scene(), SIZE, SIZE,
                                 seed=SEED, **OPTIONS[name]), np.float32)


@pytest.fixture(autouse=True, scope="module")
def _warm_sqrt():
    """A first torch.sqrt call in a process has been seen to return one
    2,048-element segment off by ~2e-4 relative (ROADMAP queue C): take it
    here, before any ray."""
    torch.sqrt(torch.rand(16384) * 400.0)


@pytest.fixture(autouse=True, scope="module")
def _share_of_the_cores():
    """Run this module's renders on this process's share of the cores:
    under pytest-xdist each worker's torch otherwise starts a thread per
    core, and with six workers on eight cores a 512x512 plain render then
    took over 4x longer than on one thread each.  The films do not depend
    on the thread count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["simple", "trianglegrid", "nodof"])
def test_plain_film_matches_the_record(name):
    np.testing.assert_allclose(summarize(port_film(name, "cpu")),
                               record(name), **TOL)


@pytest.mark.parametrize("name", VLP_FAMILY)
def test_vlp_film_matches_the_record_outside_its_ties(name):
    got = port_film(name, "cpu")
    want = jax_film(name)
    # the record anchors the JAX film this case holds the port to
    np.testing.assert_allclose(summarize(want), record(name), **TOL)
    ok, st = crn_ok(got, want, OPTIONS[name]["spp"], SUPER)
    assert ok, st
    # the tie pixels, as the contract counts them, take JAX's values
    d = np.abs(got.astype(np.float64) - want) / OPTIONS[name]["spp"] \
        * 64.0 / 255.0
    tie = d.max(axis=-1) > SUPER.tie_thresh
    assert tie.mean() == crn_stats(got, want, OPTIONS[name]["spp"],
                                   SUPER)["tie_frac"]
    mixed = np.where(tie[..., None], want, got)
    np.testing.assert_allclose(summarize(mixed), record(name), **TOL)


def test_fixture_scene_emits_no_live_vlp():
    """At the fixture's shapes the light pass emits 0 live VLPs (so the
    record guards the VLP family's render pass, not its light pass)."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as TM)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        procedural_super_scene)
    scn = prep_scene(procedural_super_scene())
    key = make_key(SEED)
    emitted = TV.emit_vlps(key, scn, 64, device="cpu")
    chained = TM.mlt_vlps(key, scn, 32, 2, device="cpu")
    assert emitted.shape[0] == 128 and chained.shape[0] == 256
    assert int((emitted[:, 3] > 0).sum()) == 0
    assert int((chained[:, 3] > 0).sum()) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["simple", "super", "trianglegrid",
                                  "nodof"])
def test_card_film_matches_the_record(name, cuda_device):
    np.testing.assert_allclose(summarize(port_film(name, cuda_device)),
                               record(name), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", VLP_FAMILY)
def test_card_vlp_film_matches_the_plain_film(name, cuda_device):
    ok, st = crn_ok(port_film(name, cuda_device), port_film(name, "cpu"),
                    OPTIONS[name]["spp"], SUPER)
    assert ok, st
