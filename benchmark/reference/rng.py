"""Threefry-2x32 counter streams in plain PyTorch, for the reference.

A frozen, independent statement of the draw rule that the renderer's
films are defined by: every uniform is a pure function of
``(key, ray_id, counter)``, with ``ray_id = pixel * spp_total + sample``
(uint32) and ``counter = site * 8 + j``.  Words are carried in int64
tensors holding values in ``[0, 2**32)``.  Nothing here imports the
program under test.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
SITE_STRIDE = 8
UNIT = 1.0 / (1 << 24)


def make_key(seed: int) -> tuple[int, int]:
    """A 64-bit seed as the key pair (low word, high word)."""
    seed = int(seed)
    return seed & MASK, (seed >> 32) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key, x0: torch.Tensor, x1) -> tuple:
    """20 rounds of Threefry-2x32 on uint32 words held in int64 tensors."""
    ks = (int(key[0]) & MASK, int(key[1]) & MASK)
    ks = ks + (ks[0] ^ ks[1] ^ _PARITY,)
    x1 = torch.as_tensor(x1, dtype=torch.int64, device=x0.device)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & MASK)) & MASK
    return x0, x1


def uniforms(key, ray_id: torch.Tensor, site: int, n: int) -> list:
    """``n`` float32 uniforms in [0, 1) of ``site`` for each ray: the top
    24 bits of each word, two words a block."""
    out = []
    for j in range((n + 1) // 2):
        b0, b1 = threefry2x32(key, ray_id, (site * SITE_STRIDE + j) & MASK)
        out += [(b0 >> 8).to(torch.float32) * UNIT,
                (b1 >> 8).to(torch.float32) * UNIT]
    return out[:n]
