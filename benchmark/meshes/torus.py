"""The ~96-triangle torus that stands in for the upstream
``triangles.txt``, which is not part of this repository."""

from __future__ import annotations

import numpy as np


def make(center, major, minor, n_major, n_minor) -> np.ndarray:
    """(2 * n_major * n_minor, 3, 3) triangles, (a, b, c) and (a, c, d)
    of each quad, in float64 with a final float32 cast."""
    cx, cy, cz = center
    us = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)

    def point(u, v):
        r = major + minor * np.cos(v)
        return np.stack([cx + r * np.cos(u), cy + r * np.sin(u),
                         cz + minor * np.sin(v)], axis=-1).astype(np.float32)

    shape = (n_major, n_minor)
    u0 = np.broadcast_to(us[:, None], shape)
    u1 = np.broadcast_to(np.roll(us, -1)[:, None], shape)
    v0 = np.broadcast_to(vs[None, :], shape)
    v1 = np.broadcast_to(np.roll(vs, -1)[None, :], shape)
    a, b, c, d = point(u0, v0), point(u1, v0), point(u1, v1), point(u0, v1)
    tris = np.empty(shape + (2, 3, 3), np.float32)
    tris[:, :, 0] = np.stack([a, b, c], axis=2)
    tris[:, :, 1] = np.stack([a, c, d], axis=2)
    return tris.reshape(-1, 3, 3)
