"""Independent NumPy oracle for the full "super" scene estimator.

Port of ``opencl_montecarlo_path_tracing_tpu/models/oracle_super.py``:
the same NumPy code, on the port's own threefry twins (core/rng.py),
quirks and Scene container.

A direct, vectorised NumPy transcription of CLSuperPathTracer's kernel math
(CLSuperPathTracer/pathtracer.ocl:48-241): floor/squares/spheres/triangles,
point lights with jittered soft shadows, inverse-square clamp, the
cross-bounce total_illumination accumulator, and the 5-material shading.
Used as the RMSE ground truth for the wavefront integrator and kernel B1
(models/super.py, csrc/mega_super.cu); they share no code beyond the
Scene container.

Quirk toggles follow core/quirks.py.

Two RNG modes:
 * legacy (default): an independent np.random stream - comparisons against
   the renderer then carry two Monte-Carlo noise realisations.
 * common random numbers (``key=...``): draws come from the same
   counter-based threefry sites as the integrators
   (core/rng.py::rand2_np), so oracle and port renders consume IDENTICAL
   samples and the comparison isolates estimator bias from MC noise -
   agreement is tight (<1e-3 display scale) at ANY spp.
"""

from __future__ import annotations

import numpy as np

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..scene.scene import Scene
from .common import SITE_CAMERA, SITE_LIGHT0, SITE_STRIDE_BOUNCE

_EPS = np.float32(0.01)
_BIG = np.float32(1e9)


def _normalize(v):
    return v / np.sqrt((v * v).sum(-1, keepdims=True))


def _trace(o, d, scene: Scene, quirks: Quirks):
    """Returns (m, t, normal) for ray batch; mirrors pathtracer.ocl:48-137."""
    n = o.shape[0]
    t = np.full(n, _BIG, np.float32)
    m = np.zeros(n, np.int32)
    normal = np.zeros((n, 3), np.float32)

    p = -o[:, 2] / d[:, 2]
    hit = (_EPS < p) & (p < t)
    t[hit] = p[hit]
    m[hit] = 1
    normal[hit] = (0, 0, 1)

    for k, j in scene.square_kj:
        rd = (4 + j - o[:, 2]) / d[:, 2]
        ix = o[:, 0] + d[:, 0] * rd
        iy = o[:, 1] + d[:, 1] * rd
        ok = (rd < t) & (np.abs(k - ix) < 1) & (np.abs(iy) < 1)
        if not quirks.accept_negative_t:
            ok &= rd > _EPS
        t[ok] = rd[ok]
        normal[ok] = (0, 0, 1)
        m[ok] = 3

    for c in scene.sphere_centers:
        pc = o - c
        b = (pc * d).sum(-1)
        cc = (pc * pc).sum(-1) - 1.0
        q = b * b - cc
        s = -b - np.sqrt(np.maximum(q, 0.0))
        ok = (q > 0) & (s < t) & (s > _EPS)
        t[ok] = s[ok]
        normal[ok] = _normalize(pc[ok] + d[ok] * s[ok, None])
        m[ok] = 3

    for tri in scene.triangles:
        v0, v1, v2 = tri
        e0 = v1 - v0
        e2 = v2 - v0
        pvec = np.cross(d, e2)
        det = (e0 * pvec).sum(-1)
        ok = np.abs(det) >= _EPS
        inv = 1.0 / np.where(ok, det, 1.0)
        tvec = o - v0
        u = (tvec * pvec).sum(-1) * inv
        ok &= (u >= 0) & (u <= 1)
        qvec = np.cross(tvec, e0)
        v = (d * qvec).sum(-1) * inv
        ok &= (v >= 0) & (u + v <= 1)
        rd = (e2 * qvec).sum(-1) * inv
        ok &= rd < t
        if not quirks.accept_negative_t:
            ok &= rd > _EPS
        t[ok] = rd[ok]
        nr = np.cross(e0, e2).astype(np.float32)
        normal[ok] = nr / np.sqrt((nr * nr).sum())
        m[ok] = 4
    return m, t, normal


def _pow99(x):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    x32 = x16 * x16
    return x32 * x32 * x32 * x2 * x


def _sample(o, d, scene: Scene, rng, quirks: Quirks, max_bounces=5,
            light_draws=None):
    """Vectorised Sample (pathtracer.ocl:139-218).

    ``light_draws(b, i) -> (r1, r2)`` overrides the light-jitter draws for
    the common-random-numbers mode (bounce ``b``, light ``i``)."""
    n = o.shape[0]
    result = np.zeros((n, 3), np.float32)
    color_fact = np.zeros((n, 3), np.float32)
    div = np.ones(n, np.float32)
    total_illum = np.zeros(n, np.float32)
    alive = np.ones(n, bool)
    o = o.astype(np.float32).copy()
    d = d.astype(np.float32).copy()

    for b in range(max_bounces):
        if not alive.any():
            break
        m, t, normal = _trace(o, d, scene, quirks)

        miss = alive & (m == 0)
        f = (1.0 - d[miss, 2]).astype(np.float32)
        result[miss] = (color_fact[miss]
                        + np.float32([0.7, 0.6, 1.0]) * (f ** 4)[:, None]
                        / div[miss, None])

        x = (o + d * t[:, None]).astype(np.float32)
        shading = alive & (m != 0)

        last_ldir = d.copy()
        for li, lp in enumerate(scene.lights):
            if light_draws is None:
                r1 = rng.random(n, np.float32)
                r2 = rng.random(n, np.float32)
            else:
                r1, r2 = light_draws(b, li)
            if lp[3] == 0:
                continue
            jit = np.stack([r1, r2, np.zeros(n, np.float32)], -1)
            ldir = _normalize(lp[:3] + jit - x)
            lamb = (ldir * normal).sum(-1)
            sh_m, _, _ = _trace(x, ldir, scene, quirks)
            dist2 = ((lp[:3] - x) ** 2).sum(-1)
            contrib = np.where((lamb < 0) | (sh_m != 0), 0.0,
                               lamb * np.minimum(lp[3] / dist2, 1.0))
            total_illum[shading] += contrib[shading].astype(np.float32)
            last_ldir = ldir

        total_illum[shading] = np.minimum(total_illum[shading], 1.0) / 4.0

        fl = alive & (m == 1)
        ip = x[fl] * np.float32(0.2)
        sel = (np.ceil(ip[:, 0]) + np.ceil(ip[:, 1])).astype(np.int64) & 1
        ccol = np.where(sel[:, None] == 1, np.float32([3, 1, 1]),
                        np.float32([3, 3, 3]))
        result[fl] = color_fact[fl] + ccol * total_illum[fl, None] / div[fl, None]

        df = alive & (m == 3)
        result[df] = (color_fact[df]
                      + np.float32([2, 3, 2]) * total_illum[df, None]
                      / div[df, None])

        fr = alive & (m == 4)
        facing = np.maximum(0.0, -(normal[fr] * d[fr]).sum(-1))
        result[fr] = color_fact[fr] + (facing / div[fr])[:, None]

        bo = alive & (m == 2)
        half = d - normal * (2.0 * (normal * d).sum(-1))[:, None]
        spec = _pow99(((last_ldir * half).sum(-1)
                       * (total_illum > 0)).astype(np.float32))
        factor = div if quirks.specular_divfact_multiply else 1.0 / div
        color_fact[bo] += (spec * factor)[bo, None]
        o[bo] = x[bo]
        d[bo] = half[bo]
        div[bo] *= 2.0
        alive = bo

    result[alive] = color_fact[alive]
    return result


def render_oracle_super(scene: Scene, width: int = 64, height: int = 64,
                        spp: int = 64, seed: int = 0,
                        quirks: Quirks = DEFAULT,
                        max_bounces: int = 5, key=None,
                        row_offset: int = 0) -> np.ndarray:
    """Pre-ambient float film (H, W, 3), GPU layout (z_sign=-1 basis,
    direct indexing).

    ``key`` (a core/rng.py ``make_key`` pair) switches to common random
    numbers: every draw comes from the same (key, pixel*spp+s, site)
    threefry streams the integrator consumes (models/super.py).
    ``row_offset`` renders a band of pixel rows starting there (global
    pixel ids - matches the renderers' band API; the camera frame is
    fixed for 512x512, so small windows at the origin are all sky)."""
    f32 = np.float32
    rng = np.random.default_rng(seed)

    z_vec = np.array([0, 0, -1], f32)
    forward = _normalize(np.array([-6, -16, 0], f32))
    up = f32(0.002) * _normalize(np.cross(z_vec, forward).astype(f32))
    right = f32(0.002) * _normalize(np.cross(forward, up).astype(f32))
    eye = f32(-256) * (up + right) + forward
    pos = np.array([17, 16, 8], f32)

    yy, xx = np.meshgrid(np.arange(height, dtype=f32),
                         np.arange(width, dtype=f32), indexing="ij")
    xx = xx.reshape(-1)
    yy = yy.reshape(-1) + np.float32(row_offset)
    n = xx.size

    pixel_index = (yy.astype(np.int64) * width
                   + xx.astype(np.int64)).astype(np.uint32)

    film = np.zeros((n, 3), f32)
    for s in range(spp):
        if key is None:
            r = rng.random((4, n), f32)
            light_draws = None
        else:
            with np.errstate(over="ignore"):
                ray_id = (pixel_index * np.uint32(spp)
                          + np.uint32(s)).astype(np.uint32)
            r = rngmod.randn_draws_np(key, ray_id, SITE_CAMERA, 4)

            def light_draws(b, i, _rid=ray_id):
                return rngmod.rand2_np(
                    key, _rid,
                    SITE_LIGHT0 + b * SITE_STRIDE_BOUNCE + i)
        delta = (up * ((r[0] - 0.5) * 99)[:, None]
                 + right * ((r[1] - 0.5) * 99)[:, None])
        o = pos + delta
        d = _normalize(-delta + (up * (r[2] + xx)[:, None]
                                 + right * (yy + r[3])[:, None] + eye) * 16)
        film += _sample(o.astype(f32), d.astype(f32), scene, rng, quirks,
                        max_bounces, light_draws=light_draws)
    return (film * f32(3.5)).reshape(height, width, 3)
