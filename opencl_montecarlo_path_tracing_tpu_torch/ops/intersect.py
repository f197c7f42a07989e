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
and strict-< tie semantics.  Meshes below ``_MXU_MIN_TRIANGLES`` (2048)
take the division-free scan; larger meshes take the matmul formulation of
kernel B7 (``ops/tri_closest.py::triangle_closest``: the CUDA kernel on a
CUDA tensor, its plain version on the CPU or when ``plain=True``), as the
JAX package does.  ``tri_override`` replaces the triangle stage (the
uniform-grid DDA of models/trianglegrid.py).

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
    tri_w: np.ndarray           # (13, 4*Nt) weights (see _triangle_weights)
    lights: np.ndarray          # (Nl, 4)


def _triangle_weights(v0, e0, e2):
    """(13, 4*Nt) weights expressing Moller-Trumbore's four per-pair scalars
    as one matmul against the ray feature vector

        f = [1, ox, oy, oz, dx, dy, dz,
             dx*oy, dx*oz, dy*ox, dy*oz, dz*ox, dz*oy]

    (the JAX package's ``_triangle_weights``, bit for bit):
        det    = d . (e2 x e0)
        u*det  = d . (e2 x o) - d . (e2 x v0)
        v*det  = d . (o x e0) - d . (v0 x e0)
        t*det  = o . (e0 x e2) - v0 . (e0 x e2)
    """
    nt = v0.shape[0]
    w = np.zeros((13, 4, nt), np.float32)

    def cross(a, b):
        return np.cross(a, b).astype(np.float32)

    w[4:7, 0] = cross(e2, e0).T
    # u*det: dx*oy: -e2z ; dx*oz: +e2y ; dy*ox: +e2z ; dy*oz: -e2x ;
    #        dz*ox: -e2y ; dz*oy: +e2x
    w[7, 1] = -e2[:, 2]
    w[8, 1] = e2[:, 1]
    w[9, 1] = e2[:, 2]
    w[10, 1] = -e2[:, 0]
    w[11, 1] = -e2[:, 1]
    w[12, 1] = e2[:, 0]
    w[4:7, 1] = -cross(e2, v0).T
    # v*det: dx*oy: +e0z ; dx*oz: -e0y ; dy*ox: -e0z ; dy*oz: +e0x ;
    #        dz*ox: +e0y ; dz*oy: -e0x
    w[7, 2] = e0[:, 2]
    w[8, 2] = -e0[:, 1]
    w[9, 2] = -e0[:, 2]
    w[10, 2] = e0[:, 0]
    w[11, 2] = e0[:, 1]
    w[12, 2] = -e0[:, 0]
    w[4:7, 2] = -cross(v0, e0).T
    # t*det: o-linear coefficients n = e0 x e2, constant -v0.n
    n = cross(e0, e2)
    w[1:4, 3] = n.T
    w[0, 3] = -(v0 * n).sum(-1)
    return w.reshape(13, 4 * nt)


# Prepared scenes, and the device tables derived from them (kernel B7's
# weights, kernels B2/B3's block tables, kernel B5's sphere groups), for
# the last few scenes seen: a Scene is prepared once, however many renders
# it is given, and each table is built once per prepared scene and device.
# Keys are object identities; each entry holds its owner, so an identity
# is not reused while it is cached.  A Scene is static: its arrays are not
# changed in place.
_CACHE_SIZE = 8
_PREPARED: dict = {}
_DERIVED: dict = {}


def _memo(cache: dict, owner, key, make):
    hit = cache.pop(key, None)
    if hit is None:
        hit = (owner, make())
        while len(cache) >= _CACHE_SIZE:
            cache.pop(next(iter(cache)))
    cache[key] = hit
    return hit[1]


def derived(scn: SceneArrays, name: str, device, make):
    """``make(scn)``, computed once per prepared scene, ``name`` and
    ``device`` (least recently used entries go first)."""
    return _memo(_DERIVED, scn, (id(scn), name, str(device)),
                 lambda: make(scn))


def prep_scene(scene: Scene) -> SceneArrays:
    """The scene's SoA arrays (cached per Scene object)."""
    return _memo(_PREPARED, scene, id(scene), lambda: _prep_scene(scene))


def _prep_scene(scene: Scene) -> SceneArrays:
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
        tri_w=_triangle_weights(v0, e0, e2),
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
              sphere_material: int = 3, triangles: bool = True,
              tri_override=None, plain: bool = False) -> TraceResult:
    """Closest-hit query for a ray batch o/d of shape (..., 3).

    ``t_init`` (scalar or per-ray tensor) reproduces the lmem variants'
    caller-initialised max distance; plain variants pass the default 1e9.
    ``sphere_material`` is 2 (mirror) in the simple tracer and 3 (diffuse)
    in all super tracers.  ``tri_override(o, d, t, m, nx, ny, nz, needs)
    -> (t, m, nx, ny, nz, needs)`` replaces the triangle stage;
    ``plain=True`` keeps a mesh of >= 2048 triangles on kernel B7's plain
    version on every device (the plain films of the kernels).
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
    nt = int(scn.tri_v0.shape[0])
    if tri_override is not None:
        t, m, nx, ny, nz, needs_norm = tri_override(o, d, t, m, nx, ny, nz,
                                                    needs_norm)
    elif triangles and nt >= _MXU_MIN_TRIANGLES:
        # kernel B7's closest (t, index) per ray; the merge is the
        # sequential scan's strict-< running best
        shape = o.shape[:-1]
        tt, idx = _closest(o, d, scn, quirks, plain)
        tt = tt.reshape(shape)
        tn = torch.as_tensor(scn.tri_n, device=o.device)[idx]
        tn = tn.reshape(shape + (3,))
        ok = tt < t
        t = torch.where(ok, tt, t)
        m = torch.where(ok, 4, m)
        nx = torch.where(ok, tn[..., 0], nx)
        ny = torch.where(ok, tn[..., 1], ny)
        nz = torch.where(ok, tn[..., 2], nz)
        needs_norm = needs_norm & ~ok
    elif triangles and nt:
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
            triangles: bool = True, plain: bool = False):
    """Occlusion query: does any primitive hit with t < t_limit?

    Matches the reference's shadow test, which calls full TraceRay and checks
    material != 0 (pathtracer.ocl:180).  The plain super tracer re-initialises
    t to 1e9 inside TraceRay so *any* hit occludes, even beyond the light;
    ``t_limit`` (scalar or per-ray tensor) expresses the capped variants.
    ``plain`` as in :func:`trace_ray`.
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

    nt = int(scn.tri_v0.shape[0])
    if triangles and nt >= _MXU_MIN_TRIANGLES:
        # any valid hit < limit iff the minimum valid distance is < limit
        tt, _ = _closest(o, d, scn, quirks, plain)
        occ = occ | (tt.reshape(o.shape[:-1]) < tl)
    elif triangles and nt:
        for r in _rows(_tri_table(scn)):
            dd, un_s, vn_s, tn_s = _mt_quads(ox, oy, oz, dx, dy, dz, r)
            ok = _mt_valid(dd, un_s, vn_s) & (tn_s < tl * dd)
            if not quirks.accept_negative_t:
                ok = ok & (tn_s > _EPS * dd)
            occ = occ | ok
    return occ


def _closest(o, d, scn: SceneArrays, quirks: Quirks, plain: bool):
    from . import tri_closest as B7
    fn = B7.triangle_closest_plain if plain else B7.triangle_closest
    return fn(o.reshape(-1, 3), d.reshape(-1, 3), scn, quirks)


def _mt_test(ox, oy, oz, dx, dy, dz, r, quirks: Quirks):
    """Moller-Trumbore validity + distance in the division form (the
    reference's own, and the uniform-grid DDA's) for one packed triangle
    row ``r`` - Python floats or (R,) tensors - against the ray tensors.
    Returns (ok, rd); the caller applies the running-t comparison."""
    v0x, v0y, v0z = r[0], r[1], r[2]
    e0x, e0y, e0z = r[3], r[4], r[5]
    e2x, e2y, e2z = r[6], r[7], r[8]
    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e0x * pvx + e0y * pvy + e0z * pvz
    ok = torch.abs(det) >= _EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    ok = ok & (u >= 0.0) & (u <= 1.0)
    # qvec = tvec x e0
    qvx = tvy * e0z - tvz * e0y
    qvy = tvz * e0x - tvx * e0z
    qvz = tvx * e0y - tvy * e0x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    rd = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    if not quirks.accept_negative_t:
        ok = ok & (rd > _EPS)
    return ok, rd


# ---------------------------------------------------------------------------
# matmul formulation of the triangle test (kernel B7, ops/tri_closest.py)

#: Triangle count from which trace_ray / any_hit take kernel B7's route
#: (the JAX package's _MXU_MIN_TRIANGLES).
_MXU_MIN_TRIANGLES = 2048


def _ray_features(ox, oy, oz, dx, dy, dz):
    """(R, 13) feature vector (see _triangle_weights)."""
    one = torch.ones_like(ox)
    return torch.stack([
        one, ox, oy, oz, dx, dy, dz,
        dx * oy, dx * oz, dy * ox, dy * oz, dz * ox, dz * oy,
    ], dim=-1)


def _mxu_quads(ox, oy, oz, dx, dy, dz, scn: SceneArrays):
    """(R, Nt) each of (det, u*det, v*det, t*det), one float32 matmul."""
    nt = scn.tri_v0.shape[0]
    f = _ray_features(ox, oy, oz, dx, dy, dz)
    w = torch.as_tensor(scn.tri_w, device=f.device)
    q = (f @ w).reshape(f.shape[:-1] + (4, nt))
    return q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]


def _mxu_valid(det, un, vn, tn, quirks: Quirks):
    """Validity + distance from the quad scalars, kernel B7's epilogue:
    ``inv = 1/det`` then ``u = un*inv`` (two roundings), as in
    ops/pallas_tri.py."""
    ok = torch.abs(det) >= _EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    u = un * inv
    v = vn * inv
    rd = tn * inv
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    if not quirks.accept_negative_t:
        ok = ok & (rd > _EPS)
    return ok, rd
