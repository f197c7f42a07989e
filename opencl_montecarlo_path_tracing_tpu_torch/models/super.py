"""Wavefront equivalent of CLSuperPathTracer / CLSuperPathTracer_lmem.

Port of ``opencl_montecarlo_path_tracing_tpu/models/super.py``.  On a CUDA
device the route is decided from the configuration before any launch
(:func:`cuda_route`): inside the megakernels' gate the whole film goes
through one of them (``ops/mega_super.py``: B1 up to 512 triangles, B2/B3
up to 2^20); outside it (> 2^20 triangles, > 8 lights, ``max_bounces <
1``) the plain wavefront below runs on the card, whose meshes of >= 2048
triangles go through kernel B7 - the JAX package's own route off its
gate.  On the CPU the plain wavefront runs, which is also the kernels'
plain version.

Reference: CLSuperPathTracer/pathtracer.ocl - adds squares, triangles
(Moller-Trumbore), multiple point lights with inverse-square falloff and
soft shadows, 5-material shading; scene from text files.  The _lmem variant
differs only in work-group caching and in an accidental aliasing of the
running hit distance into the shadow trace
(CLSuperPathTracer_lmem/pathtracer.ocl:178), reproduced behind
``quirks.shadow_carry_t`` (CLI ``superlmem --quirks reference``).

Estimator details preserved (pathtracer.ocl:139-218):
 * per light: jittered direction, lambertian factor, hard shadow test with an
   *uncapped* shadow ray (a hit beyond the light still occludes, ocl:180),
   inverse-square clamp min(I/d^2, 1)
 * total_illumination accumulates ACROSS bounces without reset (declared
   outside the loop, ocl:153), is clamped to 1 and divided by 4 each bounce
 * materials: 1 floor checker, 3 diffuse (2,3,2), 4 facing-ratio (scalar
   broadcast onto rgb), 2 mirror bounce (dead code on the shipped scenes -
   spheres are material 3 here)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..core.camera import make_camera, primary_rays
from ..ops.intersect import SceneArrays, prep_scene, trace_ray, any_hit
from ..scene.scene import Scene
from . import common as C


def illum_direct(key, scn: SceneArrays, quirks: Quirks, tri_override,
                 plain, b, x, normal, shading, total_illum, ray_id,
                 t_hit=None):
    """Direct illumination with jittered soft shadows - the super tracer's
    light loop (pathtracer.ocl:167-191).  Returns the updated cross-bounce
    total_illumination and the last light direction (consumed by the mirror
    branch's highlight, ocl:211).

    All shadow rays are batched into ONE occlusion query.  Under
    ``quirks.shadow_carry_t`` the traces are instead sequential per light:
    each starts from the carried distance ``t_hit`` (the primary hit's t)
    and, when actually executed (lamb >= 0 - the reference short-circuits
    ``lamb_f < 0 || TraceRay(...)``), overwrites the carry with its own
    closest hit.  ``tri_override`` and ``plain`` go to every shadow trace
    (ops/intersect.py::trace_ray); with an override the batched query is
    a closest-hit trace, as in the JAX package.
    """
    nlights = int(scn.lights.shape[0])
    last_ldir = torch.zeros_like(x)
    ldirs = []
    for i in range(nlights):
        lp = torch.as_tensor(scn.lights[i, :3], device=x.device)
        u1, u2 = rngmod.rand2(
            key, ray_id, C.SITE_LIGHT0 + b * C.SITE_STRIDE_BOUNCE + i)
        jitter = torch.stack([u1, u2, torch.zeros_like(u1)], dim=-1)
        ldirs.append(C.normalize(lp + jitter - x))
    if nlights and quirks.shadow_carry_t:
        t_run = (torch.full(x.shape[:-1], float(np.float32(1e9)),
                            device=x.device) if t_hit is None else t_hit)
        occ_rows = []
        for i in range(nlights):
            tr_s = trace_ray(x, ldirs[i], scn, t_init=t_run, quirks=quirks,
                             sphere_material=3, tri_override=tri_override,
                             plain=plain)
            occ_rows.append(tr_s.material != 0)
            lamb = C.dot(ldirs[i], normal)
            t_run = torch.where(lamb < 0, t_run, tr_s.t)
        occ_all = torch.stack(occ_rows, dim=0)
    elif nlights:
        xs = torch.cat([x] * nlights, dim=0)
        ds = torch.cat(ldirs, dim=0)
        if tri_override is None:
            occ_all = any_hit(xs, ds, scn, quirks=quirks, plain=plain)
        else:
            occ_all = trace_ray(xs, ds, scn, quirks=quirks,
                                sphere_material=3,
                                tri_override=tri_override).material != 0
        occ_all = occ_all.reshape(nlights, -1)
    for i in range(nlights):
        lp = torch.as_tensor(scn.lights[i, :3], device=x.device)
        intensity = torch.as_tensor(scn.lights[i, 3], device=x.device)
        ldir = ldirs[i]
        lamb = C.dot(ldir, normal)
        occ = occ_all[i].reshape(lamb.shape)
        q = lp - x
        dist2 = C.dot(q, q)
        contrib = torch.where(
            (lamb < 0) | occ, 0.0,
            lamb * torch.clamp_max(intensity / dist2, 1.0))
        total_illum = torch.where(shading, total_illum + contrib, total_illum)
        last_ldir = ldir

    total_illum = torch.where(shading, torch.clamp_max(total_illum, 1.0) / 4.0,
                              total_illum)
    return total_illum, last_ldir


def sample_super(key, scn: SceneArrays, quirks: Quirks, max_bounces: int,
                 s, ii, jj, ray_id, tri_override=None, illum_fn=None,
                 plain: bool = False):
    """One camera sample per pixel on the full scene; returns (R, 3).

    ``tri_override`` replaces the triangle stage of every trace (e.g. with
    the uniform-grid DDA, models/trianglegrid.py), shadow rays included,
    as the reference's grid serves every TraceRay
    (trianglegrid/pathtracer.ocl:245).  ``plain=True`` keeps every trace
    on plain PyTorch on any device (ops/intersect.py::trace_ray).

    ``illum_fn(b, x, normal, shading, total_illum, ray_id, t_hit) ->
    (total_illum, last_ldir)`` replaces the direct-light loop - the
    bidirectional/metropolis integrators plug their VLP gathers in here
    (models/bidirectional.py, models/metropolis.py); ``t_hit`` is the
    primary trace's hit distance (consumed only by the _lmem
    ``shadow_carry_t`` quirk)."""
    r1, r2, r3, r4 = rngmod.randn_draws(key, ray_id, C.SITE_CAMERA, 4)
    cam = make_camera(z_sign=-1.0)
    o, d = primary_rays(cam, ii, jj, r1, r2, r3, r4)

    R = ray_id.shape
    dev = ray_id.device
    zero3 = torch.zeros(R + (3,), dtype=torch.float32, device=dev)
    state = (
        torch.ones(R, dtype=torch.bool, device=dev),        # alive
        o, d,
        zero3,                                              # colorFact
        torch.ones(R, dtype=torch.float32, device=dev),     # divFact
        torch.zeros(R, dtype=torch.float32, device=dev),    # total_illumination
        zero3,                                              # result
    )
    diffuse = torch.as_tensor(C.DIFFUSE, device=dev)
    if illum_fn is None:
        illum_fn = functools.partial(illum_direct, key, scn, quirks,
                                     tri_override, plain)

    def step(b, state):
        alive, o, d, color_fact, div, total_illum, result = state
        tr = trace_ray(o, d, scn, quirks=quirks, sphere_material=3,
                       tri_override=tri_override, plain=plain)
        m = torch.where(alive, tr.material, -1)

        sky = color_fact + C.sky_color(d[..., 2]) / div[..., None]
        result = torch.where((m == 0)[..., None], sky, result)

        x = o + d * tr.t[..., None]
        shading = alive & (tr.material != 0)

        total_illum, last_ldir = illum_fn(b, x, tr.normal, shading,
                                          total_illum, ray_id, tr.t)

        fl = color_fact + C.floor_color(x) * total_illum[..., None] / div[..., None]
        result = torch.where((m == 1)[..., None], fl, result)

        df = color_fact + diffuse * total_illum[..., None] / div[..., None]
        result = torch.where((m == 3)[..., None], df, result)

        # facing ratio: scalar max(0, n.-d)/divFact broadcast onto rgb
        # (pathtracer.ocl:204 adds a float to a float4)
        fr = color_fact + (torch.clamp_min(C.dot(tr.normal, -d), 0.0)
                           / div)[..., None]
        result = torch.where((m == 4)[..., None], fr, result)

        # mirror bounce (dead on shipped scenes; kept for parity, ocl:209-216)
        bounce = m == 2
        half = C.reflect(d, tr.normal)
        spec = C.pow99(C.dot(last_ldir, half) * (total_illum > 0))
        hl = spec[..., None] * (div[..., None] if quirks.specular_divfact_multiply
                                else 1.0 / div[..., None])
        color_fact = torch.where(bounce[..., None], color_fact + hl, color_fact)
        o = torch.where(bounce[..., None], x, o)
        d = torch.where(bounce[..., None], half, d)
        div = torch.where(bounce, div * 2.0, div)
        alive = alive & bounce
        return alive, o, d, color_fact, div, total_illum, result

    # the super family's mirror branch is unreachable (spheres are material
    # 3, pathtracer.ocl:103), so no ray survives bounce 1: run exactly one
    # iteration.
    final = C.bounce_loop(step, state, min(max_bounces, 1))
    alive, _, _, color_fact, _, _, result = final
    return torch.where(alive[..., None], color_fact, result)


def film_super_plain(key, scn: SceneArrays, width, height, spp, spp_offset,
                     spp_total, quirks, max_bounces=C.MAX_BOUNCES,
                     row_offset=0, rows=None, device="cpu"):
    """The tier-1 wavefront film (pre-ambient (rows, W, 3) float32) in
    plain PyTorch on any device: the kernels' plain version."""
    sample_fn = functools.partial(sample_super, key, scn, quirks, max_bounces,
                                  plain=True)
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset, spp_total=spp_total,
                            row_offset=row_offset, rows=rows, device=device)


def cuda_route(scn: SceneArrays, max_bounces: int = C.MAX_BOUNCES) -> str:
    """How a CUDA device renders this configuration, decided before any
    launch: ``"mega_super"`` (B1, <= 512 triangles), ``"mega_blocked"``
    (B2/B3, 513 to 2^20 triangles) or ``"tier1"`` (the plain wavefront on
    the card, outside the kernels' gate: > 2^20 triangles, > 8 lights or
    ``max_bounces < 1``)."""
    from ..ops import mega_super
    if max_bounces < 1 or mega_super.unsupported_reason(scn) is not None:
        return "tier1"
    return "mega_blocked" if mega_super.uses_blocked(scn) else "mega_super"


def film_super(key, scn: SceneArrays, width, height, spp, spp_offset,
               spp_total, quirks, max_bounces=C.MAX_BOUNCES,
               row_offset=0, rows=None, device="cuda"):
    """Pre-ambient (rows, W, 3) float32 film on ``device``, routed by
    :func:`cuda_route` on a CUDA device (a launch failure raises; there is
    no fallback) and rendered by the plain wavefront on the CPU."""
    device = C.check_device(device)
    if device.type == "cuda" and cuda_route(scn, max_bounces) != "tier1":
        from ..ops import mega_super
        return mega_super.film_super_mega(
            key, scn, width, height, spp, spp_offset, spp_total, quirks,
            row_offset, rows, device=device)
    # the tier-1 wavefront: on the card its large meshes go through B7
    sample_fn = functools.partial(sample_super, key, scn, quirks, max_bounces)
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset, spp_total=spp_total,
                            row_offset=row_offset, rows=rows, device=device)


def render_super(key, scene: Scene | SceneArrays, width: int = 512,
                 height: int = 512, spp: int = 64,
                 spp_offset: int = 0, spp_total: int | None = None,
                 quirks: Quirks = DEFAULT, max_bounces: int = C.MAX_BOUNCES,
                 device="cuda"):
    """Render the full scene; returns the pre-ambient float film (H, W, 3)
    on ``device``."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if spp_total is None:
        spp_total = spp
    return film_super(key, scn, width, height, spp, spp_offset, spp_total,
                      quirks, max_bounces, device=device)
