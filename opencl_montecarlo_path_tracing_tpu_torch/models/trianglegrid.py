"""Uniform-grid accelerated tracer (CLSuperPathTracer_trianglegrid).

Port of ``opencl_montecarlo_path_tracing_tpu/models/trianglegrid.py``.
Reference pipeline: parse triangles and their global AABB -> the host
computes the grid resolution (cbrt heuristic) -> the device
``initTrianglesGrid`` scatters triangles with atomics -> the path tracer
runs a 3-D DDA inside TraceRay.  Here the grid is built by a
deterministic sort-based binning (ops/grid.py, no atomics), once per
prepared scene, modifier and device, and every TraceRay (primary and
shadow) walks it with the DDA traversal: on a CUDA device inside the
super kernels' gate in one launch of kernel B11 (``film_grid_mega``),
otherwise in the tier-1 wavefront, whose walk is kernel B11w on the card
and the plain PyTorch walk on the CPU (:func:`route` decides before any
launch).  The estimator is the super tracer's; the CLI adds
CELL_SIZE_MODIFIER (default 3.0, trianglegrid/CLSuperPathTracer.c:383-398),
which changes the grid and never the image.
"""

from __future__ import annotations

import functools

import torch

from ..core.quirks import Quirks, DEFAULT
from ..ops import grid as gridmod
from ..ops.intersect import SceneArrays, prep_scene
from ..scene.scene import Scene
from . import common as C
from .super import cuda_route, render_super, sample_super


def _override(o, d, t, m, nx, ny, nz, needs, *, scn, grid, quirks,
              plain=False):
    return gridmod.traverse_triangles(o, d, t, m, nx, ny, nz, needs, scn,
                                      grid, quirks, plain)


def film_trianglegrid(key, scn: SceneArrays, grid, width, height, spp,
                      spp_offset, spp_total, quirks,
                      max_bounces=C.MAX_BOUNCES, row_offset=0, rows=None,
                      device="cuda", plain: bool = False):
    """The DDA wavefront film (pre-ambient (rows, W, 3) float32) on
    ``device``: :func:`models.super.sample_super` with the grid walk as
    the triangle stage of every trace (kernel B11w on a CUDA device unless
    ``plain``: then every trace is plain PyTorch, kernel B11's plain
    version)."""
    device = C.check_device(device)
    tri_override = functools.partial(_override, scn=scn, grid=grid,
                                     quirks=quirks, plain=plain)
    sample_fn = functools.partial(sample_super, key, scn, quirks, max_bounces,
                                  tri_override=tri_override)
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset, spp_total=spp_total,
                            row_offset=row_offset, rows=rows, device=device)


def route(scn: SceneArrays, max_bounces: int = C.MAX_BOUNCES,
          accel: str = "auto", device="cuda") -> str:
    """How :func:`render_trianglegrid` renders, decided before any launch:
    on a CUDA device inside the super kernels' gate
    (:func:`models.super.cuda_route` is not ``"tier1"``), ``accel="auto"``
    takes that route (``"mega_super"`` or ``"mega_blocked"``) and
    ``accel="dda"`` kernel B11 (``"mega_grid"``); everywhere else the
    DDA wavefront (``"wavefront"``: its walk is kernel B11w on the card,
    the plain walk on the CPU)."""
    if accel not in ("auto", "dda"):
        raise ValueError(f"accel={accel!r}: one of 'auto', 'dda'")
    if torch.device(device).type == "cuda":
        r = cuda_route(scn, max_bounces)
        if r != "tier1":
            return r if accel == "auto" else "mega_grid"
    return "wavefront"


def render_trianglegrid(key, scene: Scene | SceneArrays, width: int = 512,
                        height: int = 512, spp: int = 64,
                        cell_size_modifier: float = 3.0,
                        spp_offset: int = 0, spp_total: int | None = None,
                        quirks: Quirks = DEFAULT,
                        max_bounces: int = C.MAX_BOUNCES,
                        device_build: bool = True, accel: str = "auto",
                        device="cuda"):
    """Render through an acceleration structure; returns the pre-ambient
    film (H, W, 3) on ``device``.

    The image equals the brute-force one by contract (the reference's grid
    only accelerates TraceRay).  ``accel`` (the route: :func:`route`):

    * ``"auto"``: on a CUDA device inside the super kernels' gate, the
      super megakernel (ops/mega_super.py: B2/B3's walk of the exact
      uniform grid of ops/exact_grid.py is the port's large-mesh
      acceleration structure, as the blocked scan is the JAX package's on
      its accelerator); otherwise the DDA.
    * ``"dda"``: the reference-shaped uniform-grid walk: on a CUDA device
      inside the gate kernel B11, the whole sample step in one launch
      (ops/grid.py::film_grid_mega).

    Outside the gate (and on the CPU) the DDA wavefront renders, whose
    walk (ops/grid.py::traverse_triangles) is kernel B11w on the card.
    A build or launch failure raises: there is no fallback.
    ``device_build`` picks the grid's pair build (on ``device``) or the
    host oracle build; the grid is built once per prepared scene,
    modifier, build and device (ops/grid.py::triangle_tables)."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    device = C.check_device(device)
    if spp_total is None:
        spp_total = spp
    r = route(scn, max_bounces, accel, device)
    if r in ("mega_super", "mega_blocked"):
        return render_super(key, scn, width, height, spp, spp_offset,
                            spp_total, quirks, max_bounces, device=device)
    tables = gridmod.triangle_tables(scn, cell_size_modifier, device_build,
                                     device)
    if r == "mega_grid":
        return gridmod.film_grid_mega(key, scn, tables, width, height, spp,
                                      spp_offset, spp_total, quirks,
                                      device=device)
    return film_trianglegrid(key, scn, tables.grid, width, height, spp,
                             spp_offset, spp_total, quirks, max_bounces,
                             device=device)
