"""A rippled sheet spanning the camera's view at every density, scaled
until every triangle's |e0 x e2| clears ``min_det`` (the estimator
rejects triangles under its det cutoff of 0.01)."""

from __future__ import annotations

import numpy as np

from benchmark.reference.super_film import camera_basis


def make(n_major, n_minor, min_det, depth, amp_frac, periods
                 ) -> np.ndarray:
    """(2 * n_major * n_minor, 3, 3) triangles on the rays through a
    513 x 513 lattice of the 512 x 512 image plane, at ``depth`` plus a
    ripple, wound to face the camera."""
    cam = {k: np.asarray(v, np.float64) for k, v in camera_basis().items()}
    ax = np.linspace(0.0, 512.0, n_major + 1)
    ay = np.linspace(0.0, 512.0, n_minor + 1)
    AX, AY = np.meshgrid(ax, ay, indexing="ij")
    d = 16.0 * (cam["up"] * AX[..., None] + cam["right"] * AY[..., None]
                + cam["eye"])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ph = 2.0 * np.pi * periods / 512.0

    def build(dep):
        ripple = amp_frac * dep * np.sin(ph * AX) * np.sin(ph * AY)
        P = cam["pos"] + (dep + ripple)[..., None] * d
        a, b, c, e = P[:-1, :-1], P[1:, :-1], P[1:, 1:], P[:-1, 1:]
        tris = np.concatenate([np.stack([a, c, b], axis=2),
                               np.stack([a, e, c], axis=2)],
                              axis=2).reshape(-1, 3, 3)
        det = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0],
                                      tris[:, 2] - tris[:, 0]), axis=1)
        return tris, float(det.min())

    tris, dmin = build(depth)
    if dmin < min_det:
        depth *= np.sqrt(min_det / max(dmin, 1e-30)) * 1.05
        tris, dmin = build(depth)
    if dmin < min_det:
        raise ValueError(f"sheet triangles under the det cutoff: {dmin}")
    return tris.astype(np.float32)
