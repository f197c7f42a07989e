"""The port's threefry streams == the JAX package's, bit for bit.

Inputs are made with numpy from a seed and go through both packages'
``core/rng.py``.  Tolerance: none - the streams are integer arithmetic and
the unit floats are exact (top 24 bits), so every word and float must be
identical, including counters and keys near 2**32 where uint32 wraps.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core import rng as JR
from opencl_montecarlo_path_tracing_tpu_torch.core import rng as TR

_TOP = np.uint32(0xFFFFFFFF)


def _ids(seed, n=4096):
    """Random uint32 ray ids, half of them within 64 of 2**32."""
    g = np.random.default_rng(seed)
    lo = g.integers(0, 1 << 32, n // 2, dtype=np.uint64).astype(np.uint32)
    hi = (_TOP - g.integers(0, 64, n // 2).astype(np.uint32)).astype(np.uint32)
    return np.concatenate([lo, hi])


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("key", [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                                 (0x13198A2E, 0x03707344), (1234, 0)])
def test_threefry_matches_jax(key):
    x0 = _ids(1)
    x1 = _ids(2)
    want0, want1 = JR.threefry2x32(np.uint32(key[0]), np.uint32(key[1]),
                                   x0, x1)
    got0, got1 = TR.threefry2x32(key[0], key[1], _t(x0), _t(x1))
    np.testing.assert_array_equal(got0.numpy(), np.asarray(want0, np.int64))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1, np.int64))


def test_threefry_known_answer():
    # Random123 KAT vector (also pinned for the JAX package, test_rng.py)
    y0, y1 = TR.threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, _t([0xFFFFFFFF]),
                             _t([0xFFFFFFFF]))
    assert (int(y0[0]), int(y1[0])) == (0x1CB996FC, 0xBB002BE7)


@pytest.mark.parametrize("seed", [0, 11, (1 << 40) + 7, (1 << 64) - 1])
def test_make_key_matches_jax(seed):
    assert TR.make_key(seed) == tuple(int(k) for k in JR.make_key(seed))


@pytest.mark.parametrize("site", [0, 2, 9, (1 << 29) - 1])
def test_rand2_matches_jax(site):
    key = JR.make_key(4242)
    ids = _ids(3)
    want = JR.rand2(key, ids, np.uint32(site))
    got = TR.rand2(TR.make_key(4242), _t(ids), site)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 4, 7, 16])
def test_randn_draws_matches_jax(n):
    key = JR.make_key(99)
    ids = _ids(4, 1024)
    want = JR.randn_draws(key, ids, np.uint32(3), n)
    got = TR.randn_draws(TR.make_key(99), _t(ids), 3, n)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_randn_draws_site_budget():
    with pytest.raises(ValueError):
        TR.randn_draws((0, 0), _t([0]), 0, 17)
