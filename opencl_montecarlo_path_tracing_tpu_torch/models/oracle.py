"""NumPy re-implementation of SimpleCPUTracer - the ``simplecpu`` variant.

Port of ``opencl_montecarlo_path_tracing_tpu/models/oracle.py``: the same
NumPy code, with the port's own copies of the threefry twins
(``core/rng.py``) and the bitmap scene.  It renders on the host by
definition, because it *is* the reference's CPU tracer
(SimpleCPUTracer/simpleCPUtracer.cpp, 193 LoC): ``api.render("simplecpu")``
moves its film to the requested device afterwards.  It is not a CPU
fallback of the ``simple`` variant; it is the independent ground truth
that the simple family is held against.

The tracer: a recursive ray tracer over the business-card bitmap-sphere
scene - floor checkerboard, sky, mirror spheres with specular highlights,
one jittered implicit light, thin-lens DoF, *0.5 attenuation per bounce
(simpleCPUtracer.cpp:118) - wavefront-vectorised, with the unbounded
recursion emulated by iterating until every ray terminated.

Layout notes: the CPU reference builds its camera basis with z_vect=(0,0,+1)
(simpleCPUtracer.cpp:160) while every GPU variant uses (0,0,-1)
(CLSimplePathTracer.c:142); the CPU also writes pixel (x, y) at image
position (width-x, height-y) (simpleCPUtracer.cpp:177 - an off-by-one that
overflows the buffer at x=0/y=0; we use width-1-x).  ``gpu_layout=True``
(default) renders with the GPU basis and direct indexing instead so output
is directly comparable with the GPU renderers.
"""

from __future__ import annotations

import numpy as np

from ..core import rng as rngmod
from ..scene.scene import SIMPLE_G, bitmap_to_spheres
from .common import SITE_CAMERA, SITE_LIGHT0, SITE_STRIDE_BOUNCE

_EPS = np.float32(0.01)
_BIG = np.float32(1e9)


def _normalize(v):
    return v / np.sqrt((v * v).sum(-1, keepdims=True))


def _trace(o, d, centers):
    """Vectorised CPU TraceRay (simpleCPUtracer.cpp:50-82).
    Returns (m, t, normal)."""
    n_rays = o.shape[0]
    t = np.full(n_rays, _BIG, np.float32)
    m = np.zeros(n_rays, np.int32)
    normal = np.zeros((n_rays, 3), np.float32)

    p = -o[:, 2] / d[:, 2]
    hit = _EPS < p
    t[hit] = p[hit]
    m[hit] = 1
    normal[hit] = (0, 0, 1)

    # spheres: loop over the (few) centers, vectorised over rays
    for c in centers:
        pc = o - c
        b = (pc * d).sum(-1)
        cc = (pc * pc).sum(-1) - 1.0
        q = b * b - cc
        with np.errstate(invalid="ignore"):
            s = -b - np.sqrt(np.maximum(q, 0.0))
        ok = (q > 0) & (s < t) & (s > _EPS)
        t[ok] = s[ok]
        normal[ok] = _normalize(pc[ok] + d[ok] * s[ok, None])
        m[ok] = 2
    return m, t, normal


def _pow99(x):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    x32 = x16 * x16
    return x32 * x32 * x32 * x2 * x


def _sample(o, d, centers, rng, max_depth=64, light_draws=None):
    """Vectorised CPU Sample (simpleCPUtracer.cpp:83-119).

    ``light_draws(b) -> (r1, r2)`` overrides the light-jitter draws for the
    common-random-numbers mode (bounce ``b``)."""
    n = o.shape[0]
    result = np.zeros((n, 3), np.float32)
    atten = np.ones(n, np.float32)       # 0.5^depth accumulated
    alive = np.ones(n, bool)
    o = o.copy()
    d = d.copy()

    for b in range(max_depth):
        if not alive.any():
            break
        m, t, normal = _trace(o, d, centers)

        # sky (cpp:87-90)
        miss = alive & (m == 0)
        f = (1.0 - d[miss, 2]).astype(np.float32)
        result[miss] += atten[miss, None] * np.float32([0.7, 0.6, 1.0]) * (f ** 4)[:, None]

        x = (o + d * t[:, None]).astype(np.float32)
        if light_draws is None:
            r1 = rng.random(n, np.float32)
            r2 = rng.random(n, np.float32)
        else:
            r1, r2 = light_draws(b)
        light = np.stack([9.0 + r1, 9.0 + r2, np.full(n, 16.0)], -1).astype(np.float32)
        ldir = _normalize(light - x)
        half = d - normal * (2.0 * (normal * d).sum(-1))[:, None]
        lamb = (ldir * normal).sum(-1)
        sh_m, _, _ = _trace(x, ldir, centers)
        lamb = np.where((lamb < 0) | (sh_m != 0), 0.0, lamb).astype(np.float32)
        color = _pow99(((ldir * half).sum(-1) * (lamb > 0)).astype(np.float32))

        # floor checker (cpp:109-114)
        fl = alive & (m == 1)
        ip = x[fl] * np.float32(0.2)
        sel = (np.ceil(ip[:, 0]) + np.ceil(ip[:, 1])).astype(np.int64) & 1
        ccol = np.where(sel[:, None] == 1, np.float32([3, 1, 1]), np.float32([3, 3, 3]))
        result[fl] += atten[fl, None] * ccol * (lamb[fl] * 0.2 + 0.1)[:, None]

        # mirror: specular + 0.5 * recurse (cpp:118)
        bo = alive & (m == 2)
        result[bo] += atten[bo, None] * color[bo, None]
        atten[bo] *= 0.5
        o[bo] = x[bo]
        d[bo] = half[bo]
        alive = bo
    return result


def render_oracle(width: int = 256, height: int = 256, spp: int = 64,
                  seed: int = 0, gpu_layout: bool = True,
                  max_depth: int = 64, key=None,
                  row_offset: int = 0) -> np.ndarray:
    """Render on the host; returns the pre-ambient float film (H, W, 3) as
    a numpy array (sum of samples * 3.5, matching simpleCPUtracer.cpp:174
    minus the (13,13,13) base).

    ``key`` (a core/rng.py ``make_key`` pair) switches to common random
    numbers: draws come from the same (key, pixel*spp+s, site) threefry
    streams as models/simple.py, so at matched ``max_depth`` the films
    agree to float rounding."""
    f32 = np.float32
    centers = bitmap_to_spheres(SIMPLE_G)
    rng = np.random.default_rng(seed)

    z_vec = np.array([0, 0, -1 if gpu_layout else 1], f32)
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

            def light_draws(b, _rid=ray_id):
                return rngmod.rand2_np(key, _rid,
                                       SITE_LIGHT0 + b * SITE_STRIDE_BOUNCE)
        delta = up * ((r[0] - 0.5) * 99)[:, None] + right * ((r[1] - 0.5) * 99)[:, None]
        o = pos + delta
        d = _normalize(-delta + (up * (r[2] + xx)[:, None]
                                 + right * (yy + r[3])[:, None] + eye) * 16)
        film += _sample(o.astype(f32), d.astype(f32), centers, rng, max_depth,
                        light_draws=light_draws)
    film = (film * f32(3.5)).reshape(height, width, 3)
    if not gpu_layout:
        # reference CPU writes (width-x, height-y); intended flip w/o overflow
        film = film[::-1, ::-1]
    return np.ascontiguousarray(film)
