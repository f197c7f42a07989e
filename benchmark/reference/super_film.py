"""Plain PyTorch reference of the super family's film.

An independent transcription of CLSuperPathTracer's estimator
(``CLSuperPathTracer/pathtracer.ocl:48-241`` upstream): floor, 2x2
squares, unit spheres and Moller-Trumbore triangles, point lights with
jittered soft shadows (uncapped shadow rays), the inverse-square clamp,
the cross-bounce ``total_illumination`` accumulator, 4-material shading,
64-bit seeds split into a threefry key, a film of ``sum(samples) * 3.5``
and the RGBA8 epilogue (+13 ambient, truncate, saturate, alpha 255).

It takes the raw scene (sphere centres, square (k, j), triangle vertices,
lights) and derives every array it needs itself.  It imports nothing of
the program under test and is computed only for the pixels it is asked
for, every sample of each, so a frame can be checked on a sample of its
pixels.  ``dtype`` selects the arithmetic: float32 is the reference,
bfloat16 its control (the precision below the configuration's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import rng

EPS = 0.01
BIG = 1e9
EXPOSURE = 3.5
AMBIENT = 13.0
SITE_CAMERA = 0
SITE_LIGHT0 = 2
SITE_STRIDE_BOUNCE = 8
MAX_BOUNCES = 5
#: one Moller-Trumbore ray-triangle test in FP32 operations: the unit of
#: the roofline's work (a trace costs at least one such test)
OPS_PER_TEST = 48


def camera_basis() -> dict:
    """The fixed camera (GPU basis, z = -1): position, up, right and eye
    offset, built in float32 (pathtracer.ocl's host-side constants)."""
    f32 = np.float32

    def unit(v):
        return (f32(1.0) / np.sqrt(f32(np.dot(v, v)))) * v

    pos = np.array([17, 16, 8], f32)
    forward = unit(np.array([-6, -16, 0], f32))
    up = f32(0.002) * unit(np.cross(np.array([0, 0, -1], f32),
                                    forward).astype(f32))
    right = f32(0.002) * unit(np.cross(forward, up).astype(f32))
    eye = f32(-256) * (up + right) + forward
    return {"pos": pos, "up": up, "right": right, "eye": eye}


@dataclasses.dataclass
class Geometry:
    spheres: torch.Tensor     # (Ns, 3)
    square_k: torch.Tensor    # (Nq,)
    square_z: torch.Tensor    # (Nq,)
    v0: torch.Tensor          # (Nt, 3)
    e0: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor      # (Nt, 3) unit geometric normals
    lights: torch.Tensor      # (Nl, 4)
    dtype: torch.dtype


def geometry(scene: dict, device, dtype=torch.float32) -> Geometry:
    """The reference's own arrays from the raw scene (numpy float32:
    ``spheres`` (Ns, 3), ``squares`` (Nq, 2) of (k, j), ``triangles``
    (Nt, 3, 3), ``lights`` (Nl, 4))."""
    f32 = np.float32
    tri = np.asarray(scene["triangles"], f32).reshape(-1, 3, 3)
    e0 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e0, e2).astype(f32)
    with np.errstate(invalid="ignore", divide="ignore"):
        n = np.nan_to_num(n / np.sqrt((n * n).sum(-1, keepdims=True)))
    sq = np.asarray(scene["squares"], f32).reshape(-1, 2)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, f32),
                               device=device).to(dtype)

    return Geometry(t(np.asarray(scene["spheres"], f32).reshape(-1, 3)),
                    t(sq[:, 0]), t(sq[:, 1] + f32(4.0)), t(tri[:, 0]),
                    t(e0), t(e2), t(n),
                    t(np.asarray(scene["lights"], f32).reshape(-1, 4)),
                    dtype)


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _unit(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def trace(o, d, g: Geometry, accept_negative_t: bool = False,
          pairs: int = 1 << 22):
    """Closest hit of each ray: (material, t, normal), material 0 a miss,
    1 the floor, 3 a square or sphere, 4 a triangle.  Primitives are
    tested in the reference's order and a later one replaces the hit only
    when strictly nearer, so ties go to the first.  Triangles are tested
    ``pairs`` (ray, triangle) pairs at a time."""
    R = o.shape[0]
    dt = g.dtype
    t = torch.full((R,), BIG, dtype=dt, device=o.device)
    m = torch.zeros(R, dtype=torch.int32, device=o.device)
    nrm = torch.zeros_like(o)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=o.device)

    p = -o[:, 2] / d[:, 2]
    hit = (EPS < p) & (p < t)
    t = torch.where(hit, p, t)
    m = torch.where(hit, 1, m)
    nrm = torch.where(hit[:, None], up, nrm)

    for q in range(g.square_k.shape[0]):
        rd = (g.square_z[q] - o[:, 2]) / d[:, 2]
        ix = o[:, 0] + d[:, 0] * rd
        iy = o[:, 1] + d[:, 1] * rd
        ok = (rd < t) & (torch.abs(g.square_k[q] - ix) < 1) \
            & (torch.abs(iy) < 1)
        if not accept_negative_t:
            ok &= rd > EPS
        t = torch.where(ok, rd, t)
        m = torch.where(ok, 3, m)
        nrm = torch.where(ok[:, None], up, nrm)

    for c in g.spheres:
        pc = o - c
        b = _dot(pc, d)
        q = b * b - (_dot(pc, pc) - 1.0)
        s = -b - torch.sqrt(torch.clamp_min(q, 0.0))
        ok = (q > 0) & (s < t) & (s > EPS)
        t = torch.where(ok, s, t)
        m = torch.where(ok, 3, m)
        nrm = torch.where(ok[:, None], _unit(pc + d * s[:, None]), nrm)

    nt = g.v0.shape[0]
    step = max(1, min(nt, pairs // max(R, 1)))
    inf = torch.tensor(float("inf"), dtype=dt, device=o.device)
    for a in range(0, nt, step):
        sl = slice(a, min(nt, a + step))
        v0, e0, e2 = g.v0[sl], g.e0[sl], g.e2[sl]
        dd = d[:, None, :]
        pvec = _cross(dd, e2[None])
        det = _dot(e0[None], pvec)
        ok = torch.abs(det) >= EPS
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tvec = o[:, None, :] - v0[None]
        u = _dot(tvec, pvec) * inv
        ok &= (u >= 0) & (u <= 1)
        qvec = _cross(tvec, e0[None])
        v = _dot(dd, qvec) * inv
        ok &= (v >= 0) & (u + v <= 1)
        rd = _dot(e2[None], qvec) * inv
        if not accept_negative_t:
            ok &= rd > EPS
        best, idx = torch.min(torch.where(ok, rd, inf), dim=1)
        win = best < t
        t = torch.where(win, best, t)
        m = torch.where(win, 4, m)
        nrm = torch.where(win[:, None], g.normal[sl][idx], nrm)
    return m, t, nrm


def _sample(o, d, g: Geometry, key, ray_id, quirks: dict, counts: dict):
    """The radiance of one camera sample per ray (pathtracer.ocl:139-218),
    (R, 3).  Adds the traces made, by the reference's rule (a shadow ray
    is traced only for a lit surface point facing the light:
    ``lamb < 0 || TraceRay(...)``), to ``counts``."""
    dt = g.dtype
    dev = o.device
    R = o.shape[0]
    neg_t = bool(quirks.get("accept_negative_t", False))
    result = torch.zeros((R, 3), dtype=dt, device=dev)
    color = torch.zeros((R, 3), dtype=dt, device=dev)
    div = torch.ones(R, dtype=dt, device=dev)
    illum = torch.zeros(R, dtype=dt, device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    sky = torch.tensor([0.7, 0.6, 1.0], dtype=dt, device=dev)
    red = torch.tensor([3.0, 1.0, 1.0], dtype=dt, device=dev)
    white = torch.tensor([3.0, 3.0, 3.0], dtype=dt, device=dev)
    diffuse = torch.tensor([2.0, 3.0, 2.0], dtype=dt, device=dev)
    for b in range(MAX_BOUNCES):
        if not bool(alive.any()):
            break
        m, t, normal = trace(o, d, g, neg_t)
        counts["primary"] += int(alive.sum())
        f = 1.0 - d[:, 2]
        f2 = f * f
        miss = alive & (m == 0)
        result = torch.where(miss[:, None], color + sky * (f2 * f2)[:, None]
                             / div[:, None], result)
        x = o + d * t[:, None]
        shading = alive & (m != 0)
        last = d
        for li in range(g.lights.shape[0]):
            lp = g.lights[li]
            u1, u2 = rng.uniforms(key, ray_id,
                                  SITE_LIGHT0 + b * SITE_STRIDE_BOUNCE + li, 2)
            jit = torch.stack([u1, u2, torch.zeros_like(u1)], -1).to(dt)
            ldir = _unit(lp[:3] + jit - x)
            lamb = _dot(ldir, normal)
            need = shading & (lamb >= 0)
            occ = torch.zeros(R, dtype=torch.bool, device=dev)
            sel = torch.nonzero(need).squeeze(1)
            if sel.numel():
                sm, _, _ = trace(x[sel], ldir[sel], g, neg_t)
                occ[sel] = sm != 0
            counts["shadow"] += int(sel.numel())
            q = lp[:3] - x
            contrib = torch.where((lamb < 0) | occ, torch.zeros_like(lamb),
                                  lamb * torch.clamp_max(lp[3] / _dot(q, q),
                                                         1.0))
            illum = torch.where(shading, illum + contrib, illum)
            last = ldir
        illum = torch.where(shading, torch.clamp_max(illum, 1.0) / 4.0,
                            illum)
        ip = x * 0.2
        sel = (torch.ceil(ip[:, 0]) + torch.ceil(ip[:, 1])).to(
            torch.int64) & 1
        floor = torch.where((sel == 1)[:, None], red, white)
        lit = illum[:, None] / div[:, None]
        result = torch.where((alive & (m == 1))[:, None],
                             color + floor * lit, result)
        result = torch.where((alive & (m == 3))[:, None],
                             color + diffuse * lit, result)
        facing = torch.clamp_min(-_dot(normal, d), 0.0) / div
        result = torch.where((alive & (m == 4))[:, None],
                             color + facing[:, None], result)
        mirror = alive & (m == 2)
        half = d - normal * (2.0 * _dot(normal, d))[:, None]
        s = _dot(last, half) * (illum > 0)
        s2 = s * s
        s4 = s2 * s2
        s8 = s4 * s4
        s16 = s8 * s8
        s32 = s16 * s16
        spec = s32 * s32 * s32 * s2 * s
        factor = div if quirks.get("specular_divfact_multiply") else 1.0 / div
        color = torch.where(mirror[:, None], color + (spec * factor)[:, None],
                            color)
        o = torch.where(mirror[:, None], x, o)
        d = torch.where(mirror[:, None], half, d)
        div = torch.where(mirror, div * 2.0, div)
        alive = mirror
    return torch.where(alive[:, None], color, result)


def film_pixels(scene_g: Geometry, seed: int, pixels, width: int, spp: int,
                spp_total: int | None = None, spp_offset: int = 0,
                quirks: dict | None = None, rays_per_block: int = 1 << 16,
                counts: dict | None = None) -> torch.Tensor:
    """Pre-ambient film of the flat pixel indices ``pixels`` (row-major in
    a frame ``width`` wide), samples [spp_offset, spp_offset + spp) of
    ``spp_total``, as (N, 3) in the geometry's dtype: the sum of the
    samples' radiance, times 3.5.  ``counts`` (a dict) receives the
    traces made (``primary``, ``shadow``)."""
    quirks = quirks or {}
    if quirks.get("shadow_carry_t"):
        raise ValueError("the reference has no shadow_carry_t quirk")
    g = scene_g
    dt = g.dtype
    dev = g.v0.device
    key = rng.make_key(seed)
    total = spp if spp_total is None else spp_total
    counts = {"primary": 0, "shadow": 0} if counts is None else counts
    counts.setdefault("primary", 0)
    counts.setdefault("shadow", 0)
    cam = {k: torch.as_tensor(v, device=dev).to(dt)
           for k, v in camera_basis().items()}
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    n = pix.shape[0]
    film = torch.zeros((n, 3), dtype=dt, device=dev)
    per = max(1, rays_per_block // max(spp, 1))
    for a in range(0, n, per):
        p = pix[a:a + per]
        k = p.shape[0]
        s = torch.arange(spp, dtype=torch.int64, device=dev) + spp_offset
        ray_id = ((p[:, None] * (total & rng.MASK) + s[None]) & rng.MASK)
        ray_id = ray_id.reshape(-1)
        ii = (p % width).to(dt).repeat_interleave(spp)
        jj = (p // width).to(dt).repeat_interleave(spp)
        r1, r2, r3, r4 = (u.to(dt) for u in
                          rng.uniforms(key, ray_id, SITE_CAMERA, 4))
        delta = (cam["up"] * ((r1 - 0.5) * 99.0)[:, None]
                 + cam["right"] * ((r2 - 0.5) * 99.0)[:, None])
        o = cam["pos"] + delta
        d = _unit(-delta + (cam["up"] * (r3 + ii)[:, None]
                            + cam["right"] * (jj + r4)[:, None]
                            + cam["eye"]) * 16.0)
        rad = _sample(o, d, g, key, ray_id, quirks, counts)
        acc = torch.zeros((k, 3), dtype=dt, device=dev)
        rad = rad.reshape(k, spp, 3)
        for j in range(spp):
            acc = acc + rad[:, j]
        film[a:a + k] = acc
    return film * EXPOSURE


def rgba8(film: torch.Tensor, wrap: bool = False) -> np.ndarray:
    """(N, 3) pre-ambient film -> (N, 4) uint8: + ambient, truncate,
    saturate (or wrap modulo 256), alpha 255."""
    v = torch.trunc(film.float() + AMBIENT)
    if wrap:
        rgb = (v.to(torch.int64) & 0xFF).to(torch.uint8)
    else:
        rgb = torch.clamp(v, 0.0, 255.0).to(torch.uint8)
    out = np.full((film.shape[0], 4), 255, np.uint8)
    out[:, :3] = rgb.cpu().numpy()
    return out
