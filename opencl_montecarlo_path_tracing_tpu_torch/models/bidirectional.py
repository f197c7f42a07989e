"""Bidirectional (VPL) tracer - CLSuperBidirectionalPathTracer.

Port of ``opencl_montecarlo_path_tracing_tpu/models/bidirectional.py``.
Reference pipeline (SURVEY.md section 3.4): pass 1 ``lightTracer`` emits one
virtual point light per (work item, scene light); pass 2 ``pathTracer``
gathers ALL VLPs per shading point with no shadow rays (the occlusion test
is commented out, bidirectionalpathtracer.ocl:179-182), then subtracts a
soft-shadow correction of 1/nlights per occluded real light (ocl:191-201).
Here the two passes run one after the other on the film's device; the VLP
table never leaves it.

Illumination order per bounce (ocl:166-202): VLP gather accumulates into the
cross-bounce total_illumination, clamp to 1, subtract shadow corrections
(can go negative - faithful), then /= 4.  The correction's shadow ray is
capped at the UN-jittered light distance (t = distanceFromLight before the
jittered direction is traced, ocl:195-197).

Routing of the render pass, decided from the configuration before any
launch (the JAX package's own routing, bidirectional.py:88-104, with a
wider gate): on a CUDA device the VLP megakernel (kernel B4,
``ops/mega_vlp.py``; past 512 triangles its walk of the exact grid of
``ops/exact_grid.py``) for every configuration but more than 8 lights or
``max_bounces < 1``, and for those the plain wavefront on the card, whose
dense gather is kernel B6 for large batches (``ops/vlp.py::gather_vlps``)
and whose traces of meshes of >= 2048 triangles are kernel B7
(``ops/tri_closest.py``); on the CPU the plain wavefront.  The light pass
(emission, the Metropolis chain) is kernels L1 / L2 on a CUDA device
(``ops/light_pass.py::light_route``), else plain PyTorch on the film's
device, whose traces reach B7 the same way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..ops.intersect import SceneArrays, prep_scene, any_hit
from ..ops import vlp as vlpmod
from ..scene.scene import Scene
from . import common as C
from .common import check_device
from .super import sample_super

def illum_vlp(key, scn: SceneArrays, quirks: Quirks, vlps, grid, b, x,
              normal, shading, total_illum, ray_id, t_hit=None,
              plain: bool = False):
    """VLP gather + real-light soft-shadow correction (ocl:166-202).

    ``t_hit`` is unused: the bidirectional kernels initialise their shadow
    trace's t to the light distance themselves (ocl:195-197).
    ``plain=True`` keeps the dense gather (ops/vlp.py::gather_vlps) and the
    shadow traces (ops/intersect.py::any_hit) on plain PyTorch on any
    device; else the card's large gathers are kernel B6 and its traces of
    large meshes kernel B7.  ``vlps``: the (V, 4) table, or in dense mode
    its ops/vlp.py::live_table, which B6 reads as it is."""
    nlights = int(scn.lights.shape[0])

    if grid is None:
        vi = vlpmod.gather_vlps(x, normal, vlps,
                                impl="scan" if plain else None)
    else:
        vi = vlpmod.gather_vlps_grid(x, normal, vlps, grid)
    total_illum = torch.where(shading, total_illum + vi, total_illum)
    total_illum = torch.where(shading, torch.clamp_max(total_illum, 1.0),
                              total_illum)

    # soft-shadow correction with the real lights (ocl:191-201)
    last_ldir = torch.zeros_like(x)
    ldirs, dists = [], []
    for i in range(nlights):
        lp = torch.as_tensor(scn.lights[i, :3], device=x.device)
        u1, u2 = rngmod.rand2(
            key, ray_id, C.SITE_LIGHT0 + b * C.SITE_STRIDE_BOUNCE + i)
        jitter = torch.stack([u1, u2, torch.zeros_like(u1)], dim=-1)
        ldirs.append(C.normalize(lp + jitter - x))
        q = lp - x
        dists.append(torch.sqrt(C.dot(q, q)))
    if nlights:
        xs = torch.cat([x] * nlights, dim=0)
        ds = torch.cat(ldirs, dim=0)
        tl = torch.cat(dists, dim=0)
        occ_all = any_hit(xs, ds, scn, t_limit=tl, quirks=quirks,
                          plain=plain).reshape(nlights, -1)
        inv_nl = float(np.float32(1.0 / nlights))
        for i in range(nlights):
            occ = occ_all[i].reshape(x.shape[0])
            total_illum = torch.where(shading & occ, total_illum - inv_nl,
                                      total_illum)
            last_ldir = ldirs[i]

    total_illum = torch.where(shading, total_illum / 4.0, total_illum)
    return total_illum, last_ldir


def _film_wavefront(key, scn: SceneArrays, vlps, grid, width, height, spp,
                    spp_offset, spp_total, quirks, max_bounces, row_offset,
                    rows, device, plain: bool):
    if not plain and grid is None:
        # B6's live-first table, built once for the render's gathers
        vlps = vlpmod.live_table(vlps)
    illum = functools.partial(illum_vlp, key, scn, quirks, vlps, grid,
                              plain=plain)
    sample_fn = functools.partial(sample_super, key, scn, quirks, max_bounces,
                                  illum_fn=illum, plain=plain)
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset, spp_total=spp_total,
                            row_offset=row_offset, rows=rows, device=device)


def film_vlp_plain(key, scn: SceneArrays, vlps, grid, width, height, spp,
                   spp_offset, spp_total, quirks, max_bounces=C.MAX_BOUNCES,
                   row_offset=0, rows=None, device="cpu"):
    """The tier-1 wavefront render pass with every gather and trace in
    plain PyTorch, on any device (B4's plain version)."""
    return _film_wavefront(key, scn, vlps, grid, width, height, spp,
                           spp_offset, spp_total, quirks, max_bounces,
                           row_offset, rows, device, plain=True)


def cuda_route(scn: SceneArrays, quirks: Quirks,
               max_bounces: int = C.MAX_BOUNCES) -> str:
    """How a CUDA device renders the VLP pass of this configuration:
    ``"mega_vlp"`` (kernel B4: up to 512 triangles from shared memory,
    past that its walk of the exact grid; any quirks, since the VLP family
    reads no quirk B4 lacks) when its gate passes, else ``"tier1"`` for
    more than 8 lights or ``max_bounces < 1`` (the plain wavefront on the
    card, whose large gathers are kernel B6 and whose traces of meshes of
    >= 2048 triangles are kernel B7)."""
    from ..ops import mega_vlp
    if mega_vlp.unsupported_reason(scn, quirks, max_bounces) is None:
        return "mega_vlp"
    return "tier1"


def vlp_grid(vlps, res, frame_only: bool):
    """The VLP grid of a grid render: only its frame where B4 renders the
    pass (``frame_only``: :func:`grid_frame_only`), else the full item
    lists the tier-1 gather reads."""
    if frame_only:
        return vlpmod.vlp_grid_frame(vlps, res)
    return vlpmod.build_vlp_grid(vlps, res)


def grid_frame_only(scn: SceneArrays, quirks: Quirks, max_bounces,
                    device) -> bool:
    """Whether a grid render of this configuration needs only the grid's
    frame: on B4's route, decided before any launch."""
    return (device.type == "cuda"
            and cuda_route(scn, quirks, max_bounces) == "mega_vlp")


def film_vlp(key, scn: SceneArrays, vlps, grid, width, height, spp,
             spp_offset, spp_total, quirks, max_bounces=C.MAX_BOUNCES,
             row_offset=0, rows=None, device="cuda"):
    """The VLP render pass of the whole family, routed by device and
    configuration (module docstring); no fallback after a launch."""
    device = check_device(device)
    if device.type == "cuda" and \
            cuda_route(scn, quirks, max_bounces) == "mega_vlp":
        from ..ops import mega_vlp
        return mega_vlp.film_vlp_mega(
            key, scn, vlps, width, height, spp, spp_offset, spp_total,
            quirks, row_offset, rows, grid=grid, device=device)
    return _film_wavefront(key, scn, vlps, grid, width, height, spp,
                           spp_offset, spp_total, quirks, max_bounces,
                           row_offset, rows, device, plain=False)


def film_bidirectional(key, scn: SceneArrays, width, height, spp, spp_offset,
                       spp_total, n_vlp, quirks,
                       max_bounces=C.MAX_BOUNCES, use_grid: bool = False,
                       grid_modifier: float = 3.0, precomputed_vlps=None,
                       precomputed_grid=None, row_offset=0, rows=None,
                       device="cuda"):
    """Both passes on ``device``: emit VLPs, (optionally) build the VLP
    grid (on B4's route only its frame: :func:`vlp_grid`), render.
    ``precomputed_vlps``/``precomputed_grid`` let a caller stage the
    pipeline (or carry the JAX package's light pass across, convert.py)."""
    device = check_device(device)
    frame_only = grid_frame_only(scn, quirks, max_bounces, device)
    if precomputed_vlps is not None:
        vlps = torch.as_tensor(precomputed_vlps, dtype=torch.float32,
                               device=device)
    else:
        vlps = vlpmod.emit_vlps(key, scn, n_vlp, quirks, device=device)
    grid = precomputed_grid
    if use_grid and grid is None:
        res = vlpmod.vlp_grid_static_res(int(vlps.shape[0]), grid_modifier)
        grid = vlp_grid(vlps, res, frame_only)
    return film_vlp(key, scn, vlps, grid, width, height, spp, spp_offset,
                    spp_total, quirks, max_bounces, row_offset, rows, device)


def render_bidirectional(key, scene: Scene | SceneArrays, width: int = 512,
                         height: int = 512, spp: int = 64,
                         n_vlp: int = 512,
                         spp_offset: int = 0, spp_total: int | None = None,
                         quirks: Quirks = DEFAULT,
                         max_bounces: int = C.MAX_BOUNCES,
                         use_grid: bool = False,
                         grid_modifier: float = 3.0, device="cuda"):
    """Render with VPL light transport; returns the pre-ambient film
    (H, W, 3) on ``device``.  ``n_vlp`` mirrors the reference CLI's
    N_VLP-per-light (default 512, .c:246)."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if spp_total is None:
        spp_total = spp
    return film_bidirectional(key, scn, width, height, spp, spp_offset,
                              spp_total, n_vlp, quirks, max_bounces,
                              use_grid, grid_modifier, device=device)
