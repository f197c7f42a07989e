"""Batched primitive intersection (floor / squares / spheres / triangles).

Port of ``opencl_montecarlo_path_tracing_tpu/ops/intersect.py`` on PyTorch
tensors: the plain (tier-1) closest-hit and any-hit queries that the CPU
path and the CUDA kernel's plain version run.

The reference's TraceRay is a per-ray sequential scan over primitive classes
(CLSuperPathTracer/pathtracer.ocl:48-137): floor, then the square bitmap,
then the sphere bitmap, then a Moller-Trumbore loop over triangles, each
accepting a hit only when strictly closer than the best so far.  Here rays
are flat tensors and the primitive loops run in Python over host scalars,
in file order, so the running best-t keeps the reference's exact ordering
and strict-< tie semantics.  The triangle scan is brute force for any mesh
size (the JAX package's matmul branch for >= 2048 triangles is kernel B7,
not ported yet).

Semantics preserved exactly (with Quirks toggles, see core/quirks.py):
  floor   (ocl:65-70):   p = -oz/dz, hit if 0.01 < p < t, m=1, n=(0,0,1)
  squares (ocl:73-86):   rd = (4+j-oz)/dz, hit if rd < t and |k-ix|<1 and
                         |iy|<1 (NO positivity check in the reference), m=3
  spheres (ocl:88-108):  |o + t d - c| = 1, nearest root, hit if q > 0 and
                         0.01 < rd < t, m=3, n = normalize(p + d rd)
  triangles (ocl:111-134): Moller-Trumbore, reject |det| < 0.01, u in [0,1],
                         v >= 0, u+v <= 1; hit if rd < t (NO positivity check
                         in the reference), m=4, n = normalize(e0 x e2)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.quirks import Quirks, DEFAULT
from ..scene.scene import Scene

_EPS = float(np.float32(0.01))
_BIG = float(np.float32(1e9))


class SceneArrays(NamedTuple):
    """Host-side SoA scene (numpy), the same structure as the JAX
    package's ``SceneArrays``."""
    sphere_centers: np.ndarray  # (Ns, 3)
    square_k: np.ndarray        # (Nq,)
    square_z: np.ndarray        # (Nq,)  plane height = j + 4
    tri_v0: np.ndarray          # (Nt, 3)
    tri_e0: np.ndarray          # (Nt, 3)  v1 - v0
    tri_e2: np.ndarray          # (Nt, 3)  v2 - v0
    tri_n: np.ndarray           # (Nt, 3)  normalize(e0 x e2)
    tri_w: np.ndarray           # matmul weights of kernel B7; carried, unused
    lights: np.ndarray          # (Nl, 4)


def prep_scene(scene: Scene) -> SceneArrays:
    f32 = np.float32
    tri = scene.triangles.astype(f32).reshape(-1, 3, 3)
    v0 = tri[:, 0]
    e0 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e0, e2).astype(f32)
    with np.errstate(invalid="ignore", divide="ignore"):
        n = n / np.sqrt((n * n).sum(-1, keepdims=True))
    n = np.nan_to_num(n)
    nq = scene.n_squares
    return SceneArrays(
        sphere_centers=scene.sphere_centers.astype(f32).reshape(-1, 3),
        square_k=(scene.square_kj[:, 0] if nq else np.zeros(0)).astype(f32),
        square_z=(scene.square_kj[:, 1] + 4.0 if nq else np.zeros(0)).astype(f32),
        tri_v0=v0, tri_e0=e0, tri_e2=e2, tri_n=n,
        tri_w=np.zeros((13, 0), f32),
        lights=scene.lights.astype(f32).reshape(-1, 4),
    )


def _tri_table(scn: SceneArrays) -> np.ndarray:
    """(Nt, 12) packed triangle constants: v0, e0, e2, unit normal."""
    return np.concatenate(
        [scn.tri_v0, scn.tri_e0, scn.tri_e2, scn.tri_n], axis=1
    ).astype(np.float32)


class TraceResult(NamedTuple):
    t: torch.Tensor         # (R,) hit distance (t_init when miss)
    normal: torch.Tensor    # (R, 3)
    material: torch.Tensor  # (R,) int32: 0 miss, 1 floor, 2 mirror-sphere,
                            #             3 square/diffuse-sphere, 4 triangle


def _mt_quads(ox, oy, oz, dx, dy, dz, r):
    """Moller-Trumbore det-scaled scalars (det, u*det, v*det, t*det) for one
    packed triangle row ``r`` (Python floats) against the ray tensors - no
    divisions.  The same operation order as the JAX package's
    ``_mt_quads_scalar``."""
    pvx = dy * r[8] - dz * r[7]
    pvy = dz * r[6] - dx * r[8]
    pvz = dx * r[7] - dy * r[6]
    det = pvx * r[3] + pvy * r[4] + pvz * r[5]
    tvx, tvy, tvz = ox - r[0], oy - r[1], oz - r[2]
    un = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * r[5] - tvz * r[4]
    qvy = tvz * r[3] - tvx * r[5]
    qvz = tvx * r[4] - tvy * r[3]
    vn = dx * qvx + dy * qvy + dz * qvz
    tn = qvx * r[6] + qvy * r[7] + qvz * r[8]
    # sign-adjust so the denominator is positive
    sg = torch.where(det >= 0, 1.0, -1.0)
    return det * sg, un * sg, vn * sg, tn * sg


def _mt_valid(dd, un_s, vn_s):
    return ((dd >= _EPS) & (un_s >= 0.0) & (un_s <= dd)
            & (vn_s >= 0.0) & (un_s + vn_s <= dd))


def _rows(table: np.ndarray):
    """Table rows as lists of Python floats (exact float32 values)."""
    return [[float(v) for v in row] for row in table]


def trace_ray(o, d, scn: SceneArrays, t_init=_BIG, quirks: Quirks = DEFAULT,
              sphere_material: int = 3, triangles: bool = True) -> TraceResult:
    """Closest-hit query for a ray batch o/d of shape (..., 3).

    ``t_init`` (scalar or per-ray tensor) reproduces the lmem variants'
    caller-initialised max distance; plain variants pass the default 1e9.
    ``sphere_material`` is 2 (mirror) in the simple tracer and 3 (diffuse)
    in all super tracers.
    """
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    t = torch.broadcast_to(
        torch.as_tensor(t_init, dtype=torch.float32, device=o.device), ox.shape)
    m = torch.zeros(ox.shape, dtype=torch.int32, device=o.device)
    nx = torch.zeros_like(ox)
    ny = torch.zeros_like(ox)
    nz = torch.zeros_like(ox)
    needs_norm = torch.zeros(ox.shape, dtype=torch.bool, device=o.device)

    inv_dz = 1.0 / dz

    # --- floor ---
    p = -oz * inv_dz
    hit = (p > _EPS) & (p < t)
    t = torch.where(hit, p, t)
    m = torch.where(hit, 1, m)
    nx = torch.where(hit, 0.0, nx)
    ny = torch.where(hit, 0.0, ny)
    nz = torch.where(hit, 1.0, nz)
    needs_norm = needs_norm & ~hit

    # --- squares ---
    for k, z in zip(scn.square_k, scn.square_z):
        rd = (float(z) - oz) * inv_dz
        ix = ox + dx * rd
        iy = oy + dy * rd
        ok = (rd < t) & (torch.abs(float(k) - ix) < 1.0) & (torch.abs(iy) < 1.0)
        if not quirks.accept_negative_t:
            ok = ok & (rd > _EPS)
        t = torch.where(ok, rd, t)
        m = torch.where(ok, 3, m)
        nx = torch.where(ok, 0.0, nx)
        ny = torch.where(ok, 0.0, ny)
        nz = torch.where(ok, 1.0, nz)
        needs_norm = needs_norm & ~ok

    # --- spheres ---
    for cx, cy, cz in scn.sphere_centers:
        px, py, pz = ox - float(cx), oy - float(cy), oz - float(cz)
        b = px * dx + py * dy + pz * dz
        cc = px * px + py * py + pz * pz - 1.0
        q = b * b - cc
        s = -b - torch.sqrt(torch.clamp_min(q, 0.0))
        ok = (q > 0.0) & (s < t) & (s > _EPS)
        t = torch.where(ok, s, t)
        m = torch.where(ok, sphere_material, m)
        nx = torch.where(ok, px + dx * s, nx)
        ny = torch.where(ok, py + dy * s, ny)
        nz = torch.where(ok, pz + dz * s, nz)
        needs_norm = needs_norm | ok

    # --- triangles --- division-free: validity and the running-min
    # comparison are evaluated on det-scaled quantities; the best distance
    # is carried as a (numerator, denominator) pair and divided once after
    # the loop.
    if triangles and scn.tri_v0.shape[0]:
        bn, bd = t, torch.ones_like(t)
        for r in _rows(_tri_table(scn)):
            dd, un_s, vn_s, tn_s = _mt_quads(ox, oy, oz, dx, dy, dz, r)
            ok = _mt_valid(dd, un_s, vn_s)
            if not quirks.accept_negative_t:
                ok = ok & (tn_s > _EPS * dd)
            ok = ok & (tn_s * bd < bn * dd)
            bn = torch.where(ok, tn_s, bn)
            bd = torch.where(ok, dd, bd)
            m = torch.where(ok, 4, m)
            nx = torch.where(ok, r[9], nx)
            ny = torch.where(ok, r[10], ny)
            nz = torch.where(ok, r[11], nz)
            needs_norm = needs_norm & ~ok
        t = bn / bd

    inv_len = torch.where(
        needs_norm,
        torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-30)),
        1.0)
    normal = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=-1)
    return TraceResult(t=t, normal=normal, material=m)


def any_hit(o, d, scn: SceneArrays, t_limit=_BIG, quirks: Quirks = DEFAULT,
            triangles: bool = True):
    """Occlusion query: does any primitive hit with t < t_limit?

    Matches the reference's shadow test, which calls full TraceRay and checks
    material != 0 (pathtracer.ocl:180).  The plain super tracer re-initialises
    t to 1e9 inside TraceRay so *any* hit occludes, even beyond the light;
    ``t_limit`` (scalar or per-ray tensor) expresses the capped variants.
    """
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    tl = torch.as_tensor(t_limit, dtype=torch.float32, device=o.device)
    inv_dz = 1.0 / dz

    p = -oz * inv_dz
    occ = (p > _EPS) & (p < tl)

    for k, z in zip(scn.square_k, scn.square_z):
        rd = (float(z) - oz) * inv_dz
        ix = ox + dx * rd
        iy = oy + dy * rd
        ok = (rd < tl) & (torch.abs(float(k) - ix) < 1.0) & (torch.abs(iy) < 1.0)
        if not quirks.accept_negative_t:
            ok = ok & (rd > _EPS)
        occ = occ | ok

    for cx, cy, cz in scn.sphere_centers:
        px, py, pz = ox - float(cx), oy - float(cy), oz - float(cz)
        b = px * dx + py * dy + pz * dz
        cc = px * px + py * py + pz * pz - 1.0
        q = b * b - cc
        s = -b - torch.sqrt(torch.clamp_min(q, 0.0))
        occ = occ | ((q > 0.0) & (s < tl) & (s > _EPS))

    if triangles and scn.tri_v0.shape[0]:
        for r in _rows(_tri_table(scn)):
            dd, un_s, vn_s, tn_s = _mt_quads(ox, oy, oz, dx, dy, dz, r)
            ok = _mt_valid(dd, un_s, vn_s) & (tn_s < tl * dd)
            if not quirks.accept_negative_t:
                ok = ok & (tn_s > _EPS * dd)
            occ = occ | ok
    return occ
