"""The `simplecpu` variant: the port's NumPy oracle == the JAX package's.

``models/oracle.py`` is the port's own copy of the JAX package's NumPy
SimpleCPUTracer, and ``core/rng.py`` carries its own NumPy threefry
twins.  Tolerance: none.  The twins are integer arithmetic with exact
unit floats, so every word must equal the JAX twins' and the port's torch
streams'; the oracle runs the same NumPy operations on the same inputs,
so its film must be equal bit for bit, in both the common-random-numbers
(``key=``) and the seeded mode, in both layouts.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core import rng as JR
from opencl_montecarlo_path_tracing_tpu.models.oracle import (
    render_oracle as j_render_oracle)
import opencl_montecarlo_path_tracing_tpu_torch as tpt
from opencl_montecarlo_path_tracing_tpu_torch.convert import key_from_jax
from opencl_montecarlo_path_tracing_tpu_torch.core import rng as TR
from opencl_montecarlo_path_tracing_tpu_torch.models.oracle import (
    render_oracle)


def _ids(seed, n=2048):
    """Random uint32 ray ids, half of them within 64 of 2**32."""
    g = np.random.default_rng(seed)
    lo = g.integers(0, 1 << 32, n // 2, dtype=np.uint64).astype(np.uint32)
    hi = (np.uint32(0xFFFFFFFF)
          - g.integers(0, 64, n // 2).astype(np.uint32)).astype(np.uint32)
    return np.concatenate([lo, hi])


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("key", [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                                 (0x13198A2E, 0x03707344)])
def test_threefry_np_matches_jax_and_torch(key):
    x0, x1 = _ids(1), _ids(2)
    got0, got1 = TR.threefry2x32_np(key[0], key[1], x0, x1)
    assert got0.dtype == got1.dtype == np.uint32
    want0, want1 = JR.threefry2x32_np(np.uint32(key[0]), np.uint32(key[1]),
                                      x0, x1)
    np.testing.assert_array_equal(got0, want0)
    np.testing.assert_array_equal(got1, want1)
    t0, t1 = TR.threefry2x32(key[0], key[1], _t(x0), _t(x1))
    np.testing.assert_array_equal(got0.astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(got1.astype(np.int64), t1.numpy())


@pytest.mark.parametrize("site", [0, 2, 42, (1 << 29) - 1])
def test_rand2_np_matches_jax_and_torch(site):
    key = JR.make_key(4242)
    ids = _ids(3)
    got = TR.rand2_np(key_from_jax(key), ids, site)
    want = JR.rand2_np(key, ids, site)
    ref = TR.rand2(key_from_jax(key), _t(ids), site)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r.numpy())


@pytest.mark.parametrize("n", [1, 4, 5])
def test_randn_draws_np_matches_jax_and_torch(n):
    key = JR.make_key(77)
    ids = _ids(4)
    got = TR.randn_draws_np(key_from_jax(key), ids, 3, n)
    want = JR.randn_draws_np(key, ids, 3, n)
    ref = TR.randn_draws(key_from_jax(key), _t(ids), 3, n)
    assert len(got) == len(want) == len(ref) == n
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r.numpy())


@pytest.mark.parametrize("gpu_layout", [True, False])
@pytest.mark.parametrize("mode", ["crn", "seeded"])
def test_oracle_matches_jax_exactly(mode, gpu_layout):
    key = JR.make_key(6) if mode == "crn" else None
    want = j_render_oracle(16, 16, spp=2, seed=5, gpu_layout=gpu_layout,
                           key=key)
    got = render_oracle(16, 16, spp=2, seed=5, gpu_layout=gpu_layout,
                        key=None if key is None else key_from_jax(key))
    assert got.shape == (16, 16, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_oracle_band_matches_jax_exactly():
    """The sphere-field band at the depth the CRN tests use."""
    key = JR.make_key(9)
    want = j_render_oracle(32, 8, spp=2, key=key, max_depth=5,
                           row_offset=196)
    got = render_oracle(32, 8, spp=2, key=key_from_jax(key), max_depth=5,
                        row_offset=196)
    assert float(got.var()) > 1e-2
    np.testing.assert_array_equal(got, want)


def test_api_simplecpu_is_the_oracle_on_the_device():
    """api.render("simplecpu") is the host film moved to ``device``."""
    film = tpt.render("simplecpu", None, 12, 10, spp=2, seed=4,
                      device="cpu")
    assert isinstance(film, torch.Tensor) and film.device.type == "cpu"
    np.testing.assert_array_equal(film.numpy(),
                                  render_oracle(12, 10, spp=2, seed=4))
