"""Counter-based RNG streams (Threefry-2x32), on PyTorch tensors.

Port of ``opencl_montecarlo_path_tracing_tpu/core/rng.py``: every draw is
a pure function of ``(key, ray_id, site)``, so a render is bit-identical
across any batch, chunk or device layout, and bit-identical to the JAX
package's streams.

torch's ``uint32`` has thin operator coverage, so the words are carried
in ``int64`` tensors that hold values in ``[0, 2**32)``: every add is
masked back to 32 bits and every right shift is then logical.  The CUDA
kernels (``csrc/``) run the same cipher in native ``uint32``.

A key is a pair of Python ints ``(k0, k1)``, each in ``[0, 2**32)``.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF

# Every logical draw site owns a block of 8 counters, so a site can consume
# up to 16 uniforms (2 per threefry block) without colliding with any other
# site.  All public entry points go through this convention.
_SITE_STRIDE = 8

_UNIT = np.float32(1.0 / (1 << 24))


def make_key(seed: int) -> tuple[int, int]:
    """Split a Python int seed into the ``(k0, k1)`` uint32 key pair."""
    seed = int(seed)
    return (seed & _MASK, (seed >> 32) & _MASK)


def _u32(x, device=None) -> torch.Tensor:
    """A uint32 value or array as an int64 tensor in ``[0, 2**32)``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.as_tensor(np.asarray(x, np.int64) & _MASK, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """20-round Threefry-2x32.  ``k0``/``k1`` Python ints, ``x0``/``x1``
    uint32 values as int64 tensors (or anything ``_u32`` takes).

    Returns two int64 tensors of uint32 words with the broadcast shape of
    ``x0`` and ``x1``."""
    ks = (int(k0) & _MASK, int(k1) & _MASK)
    ks = ks + (ks[0] ^ ks[1] ^ _PARITY,)
    device = x0.device if isinstance(x0, torch.Tensor) else None
    x0 = _u32(x0, device)
    x1 = _u32(x1, x0.device)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    # key injections after each group of 4 rounds:
    # group i (0-based) injects (ks[(i+1)%3], ks[(i+2)%3] + (i+1))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _MASK)) & _MASK
    return x0, x1


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> [0, 1), exactly representable in float32."""
    return (bits >> 8).to(torch.float32) * _UNIT


def _counter(site_id, j: int = 0):
    """The first counter word of draw ``j`` of site ``site_id`` (a Python
    int, or an int tensor of per-row sites), modulo 2**32."""
    if isinstance(site_id, torch.Tensor):
        return (site_id.to(torch.int64) * _SITE_STRIDE + j) & _MASK
    return (int(site_id) * _SITE_STRIDE + j) & _MASK


def rand2(key, ray_id, site_id):
    """Two independent U[0,1) float32 tensors shaped like ``ray_id``.
    ``site_id`` may be an int or a tensor of per-row sites."""
    b0, b1 = threefry2x32(key[0], key[1], ray_id, _counter(site_id))
    return bits_to_unit_float(b0), bits_to_unit_float(b1)


def randn_draws(key, ray_id, site_id, n: int):
    """``n`` independent U[0,1) tensors from one site (n <= 16)."""
    if n > 16:
        raise ValueError("one site owns at most 16 uniforms")
    out = []
    for j in range((n + 1) // 2):
        b0, b1 = threefry2x32(key[0], key[1], ray_id, _counter(site_id, j))
        out.extend([bits_to_unit_float(b0), bits_to_unit_float(b1)])
    return out[:n]


# ---------------------------------------------------------------------------
# Pure-NumPy twins - bit-identical streams on the host, for the NumPy
# oracle (models/oracle.py) in its common-random-numbers mode.  Copies of
# the JAX package's ``threefry2x32_np``, ``rand2_np`` and
# ``randn_draws_np``; equality with the torch functions above and with the
# JAX twins is pinned by tests/test_torch_oracle.py.

def threefry2x32_np(k0, k1, x0, x1):
    """NumPy 20-round Threefry-2x32 on uint32 arrays; same contract as
    :func:`threefry2x32`."""
    u32 = np.uint32
    ks = [np.asarray(k0, u32), np.asarray(k1, u32)]
    ks.append(ks[0] ^ ks[1] ^ u32(_PARITY))
    x0 = np.asarray(x0, u32)
    x1 = np.asarray(x1, u32)
    with np.errstate(over="ignore"):
        x0 = (x0 + ks[0]).astype(u32)
        x1 = (x1 + ks[1]).astype(u32)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1).astype(u32)
                x1 = ((x1 << u32(r)) | (x1 >> u32(32 - r))).astype(u32) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]).astype(u32)
            x1 = (x1 + ks[(i + 2) % 3] + u32(i + 1)).astype(u32)
    return x0, x1


def _bits_to_unit_float_np(bits):
    return (bits >> np.uint32(8)).astype(np.float32) * _UNIT


def rand2_np(key, ray_id, site_id):
    """NumPy twin of :func:`rand2` (bit-identical)."""
    with np.errstate(over="ignore"):
        ctr = (np.asarray(site_id, np.uint32)
               * np.uint32(_SITE_STRIDE)).astype(np.uint32)
    b0, b1 = threefry2x32_np(key[0], key[1],
                             np.asarray(ray_id, np.uint32), ctr)
    return _bits_to_unit_float_np(b0), _bits_to_unit_float_np(b1)


def randn_draws_np(key, ray_id, site_id, n: int):
    """NumPy twin of :func:`randn_draws` (bit-identical)."""
    if n > 16:
        raise ValueError("one site owns at most 16 uniforms")
    with np.errstate(over="ignore"):
        base = (np.asarray(site_id, np.uint32)
                * np.uint32(_SITE_STRIDE)).astype(np.uint32)
    out = []
    for j in range((n + 1) // 2):
        b0, b1 = threefry2x32_np(key[0], key[1],
                                 np.asarray(ray_id, np.uint32),
                                 (base + np.uint32(j)).astype(np.uint32))
        out.extend([_bits_to_unit_float_np(b0), _bits_to_unit_float_np(b1)])
    return out[:n]
