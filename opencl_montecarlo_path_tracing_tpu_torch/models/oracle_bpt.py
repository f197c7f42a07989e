"""Independent NumPy oracle for the bidirectional (VPL) estimator.

Port of ``opencl_montecarlo_path_tracing_tpu/models/oracle_bpt.py``:
the same NumPy code.

Direct transcription of CLSuperBidirectionalPathTracer's two passes
(bidirectionalpathtracer.ocl:230-365) on top of the super-scene oracle's
tracer (models/oracle_super.py): uniform-sphere light rays -> VLPs with
material-scaled intensities / (total_vlp / 512); render pass gathers ALL
VLPs with no shadow rays, clamps, subtracts 1/nlights per occluded real
light, divides by 4.  Shares no code with the integrator or kernel B4 beyond the
Scene container and the tracer oracle.
"""

from __future__ import annotations

import numpy as np

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..ops.vlp import SITE_VLP_DIR
from ..scene.scene import Scene
from . import oracle_super as OS
from .common import SITE_CAMERA, SITE_LIGHT0, SITE_STRIDE_BOUNCE

_BPT_BASE = {1: 70.0, 2: 5.0, 3: 40.0}


def emit_vlps_oracle(scene: Scene, n_vlp: int, rng,
                     quirks: Quirks = DEFAULT, key=None) -> np.ndarray:
    """(nlights * n_vlp, 4) VLPs.  ``key`` switches the emission directions
    to the same threefry sites as ops/vlp.py::emit_vlps."""
    nlights = scene.n_lights
    total = n_vlp * nlights
    den = max(1, total // 512)
    out = []
    dirs_first = None
    gi = np.arange(n_vlp, dtype=np.uint32)
    for l in range(nlights):
        lp = scene.lights[l, :3].astype(np.float32)
        intensity = float(scene.lights[l, 3])
        if quirks.reuse_light_direction and dirs_first is not None:
            d = dirs_first
        else:
            if key is None:
                u1 = rng.random(n_vlp, np.float32)
                u2 = rng.random(n_vlp, np.float32)
            else:
                site = (SITE_VLP_DIR if quirks.reuse_light_direction
                        else SITE_VLP_DIR + l)
                u1, u2 = rngmod.rand2_np(key, gi, site)
            z = (1.0 - 2.0 * u1).astype(np.float32)
            phi = (2.0 * np.pi) * u2
            r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
            d = np.stack([r * np.cos(phi), r * np.sin(phi), z],
                         -1).astype(np.float32)
            if dirs_first is None:
                dirs_first = d
        o = np.tile(lp, (n_vlp, 1))
        m, t, normal = OS._trace(o, d, scene, quirks)
        x = o + d * t[:, None]
        lamb = (d * normal).sum(-1)
        dist2 = ((o - x) ** 2).sum(-1)
        lamb = np.where(lamb < 0, 0.0,
                        lamb * np.minimum(intensity / dist2, 1.0))
        lamb = np.minimum(lamb, 1.0)
        base = np.zeros(n_vlp, np.float32)
        for mat, val in _BPT_BASE.items():
            base[m == mat] = val
        vi = np.where(m != 0, base * lamb / den, 0.0).astype(np.float32)
        pos = np.where((m != 0)[:, None], x, 0.0).astype(np.float32)
        out.append(np.concatenate([pos, vi[:, None]], -1))
    return np.concatenate(out, 0)


def _sample_bpt(o, d, scene: Scene, vlps, rng, quirks: Quirks,
                max_bounces=5, light_draws=None):
    n = o.shape[0]
    result = np.zeros((n, 3), np.float32)
    color_fact = np.zeros((n, 3), np.float32)
    div = np.ones(n, np.float32)
    total_illum = np.zeros(n, np.float32)
    alive = np.ones(n, bool)
    o = o.astype(np.float32).copy()
    d = d.astype(np.float32).copy()
    nlights = scene.n_lights

    for b in range(max_bounces):
        if not alive.any():
            break
        m, t, normal = OS._trace(o, d, scene, quirks)

        miss = alive & (m == 0)
        f = (1.0 - d[miss, 2]).astype(np.float32)
        result[miss] = (color_fact[miss]
                        + np.float32([0.7, 0.6, 1.0]) * (f ** 4)[:, None]
                        / div[miss, None])

        x = (o + d * t[:, None]).astype(np.float32)
        shading = alive & (m != 0)

        # VLP gather, no shadow rays (ocl:166-187)
        illum = np.zeros(n, np.float32)
        for v in vlps:
            if v[3] <= 0:
                continue
            diff = v[:3] - x
            dist = np.sqrt((diff ** 2).sum(-1))
            lamb = (diff * normal).sum(-1) / dist
            illum += np.where(lamb < 0, 0.0,
                              lamb * np.minimum(v[3] / dist ** 2, 1.0)
                              ).astype(np.float32)
        total_illum[shading] = np.minimum(total_illum[shading]
                                          + illum[shading], 1.0)

        # soft-shadow correction (ocl:191-201)
        last_ldir = d.copy()
        for li, lp in enumerate(scene.lights):
            if light_draws is None:
                r1 = rng.random(n, np.float32)
                r2 = rng.random(n, np.float32)
            else:
                r1, r2 = light_draws(b, li)
            jit = np.stack([r1, r2, np.zeros(n, np.float32)], -1)
            ldir = OS._normalize(lp[:3] + jit - x)
            dist = np.sqrt(((lp[:3] - x) ** 2).sum(-1))
            sh_m, sh_t, _ = OS._trace(x, ldir, scene, quirks)
            occ = (sh_m != 0) & (sh_t < dist)
            total_illum[shading & occ] -= np.float32(1.0 / nlights)
            last_ldir = ldir
        total_illum[shading] /= 4.0

        fl = alive & (m == 1)
        ip = x[fl] * np.float32(0.2)
        sel = (np.ceil(ip[:, 0]) + np.ceil(ip[:, 1])).astype(np.int64) & 1
        ccol = np.where(sel[:, None] == 1, np.float32([3, 1, 1]),
                        np.float32([3, 3, 3]))
        result[fl] = color_fact[fl] + ccol * total_illum[fl, None] / div[fl, None]

        df = alive & (m == 3)
        result[df] = (color_fact[df] + np.float32([2, 3, 2])
                      * total_illum[df, None] / div[df, None])

        fr = alive & (m == 4)
        facing = np.maximum(0.0, -(normal[fr] * d[fr]).sum(-1))
        result[fr] = color_fact[fr] + (facing / div[fr])[:, None]

        bo = alive & (m == 2)
        half = d - normal * (2.0 * (normal * d).sum(-1))[:, None]
        spec = OS._pow99(((last_ldir * half).sum(-1)
                          * (total_illum > 0)).astype(np.float32))
        factor = div if quirks.specular_divfact_multiply else 1.0 / div
        color_fact[bo] += (spec * factor)[bo, None]
        o[bo] = x[bo]
        d[bo] = half[bo]
        div[bo] *= 2.0
        alive = bo

    result[alive] = color_fact[alive]
    return result


def render_oracle_bpt(scene: Scene, width=32, height=32, spp=64,
                      n_vlp=512, seed=0, quirks: Quirks = DEFAULT,
                      max_bounces=5, key=None,
                      row_offset: int = 0) -> np.ndarray:
    """Pre-ambient float film (H, W, 3), GPU layout.

    ``key`` switches BOTH passes to the common threefry streams
    (ops/vlp.py emission sites + models/bidirectional.py light sites)."""
    rng = np.random.default_rng(seed)
    vlps = emit_vlps_oracle(scene, n_vlp, rng, quirks, key=key)
    return render_with_vlps(scene, vlps, width, height, spp, key=key,
                            quirks=quirks, max_bounces=max_bounces, rng=rng,
                            row_offset=row_offset)


def render_with_vlps(scene: Scene, vlps, width=32, height=32, spp=64,
                     key=None, quirks: Quirks = DEFAULT, max_bounces=5,
                     rng=None, row_offset: int = 0) -> np.ndarray:
    """Camera pass over precomputed VLPs (shared with the Metropolis oracle,
    mirroring how film_metropolis reuses the bidirectional gather)."""
    f32 = np.float32
    if rng is None:
        rng = np.random.default_rng(0)

    z_vec = np.array([0, 0, -1], f32)
    forward = OS._normalize(np.array([-6, -16, 0], f32))
    up = f32(0.002) * OS._normalize(np.cross(z_vec, forward).astype(f32))
    right = f32(0.002) * OS._normalize(np.cross(forward, up).astype(f32))
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
                    key, _rid, SITE_LIGHT0 + b * SITE_STRIDE_BOUNCE + i)
        delta = (up * ((r[0] - 0.5) * 99)[:, None]
                 + right * ((r[1] - 0.5) * 99)[:, None])
        o = pos + delta
        d = OS._normalize(-delta + (up * (r[2] + xx)[:, None]
                                    + right * (yy + r[3])[:, None] + eye) * 16)
        film += _sample_bpt(o.astype(f32), d.astype(f32), scene, vlps, rng,
                            quirks, max_bounces, light_draws=light_draws)
    return (film * f32(3.5)).reshape(height, width, 3)
