"""The VLP megakernel (kernel B4): wrapper, gate, table and plain version.

``film_vlp_mega`` renders the pre-ambient (rows, W, 3) float32 film of the
VLP render pass - the bidirectional / metropolis / metropolis_vlpgrid
family: B1's camera and closest hit, the dense (or grid-limited) VLP
gather, one occlusion per light capped at the light distance, clamp,
subtract, /4, shading, spp accumulation - in one launch of the
hand-written CUDA kernel ``csrc/mega_vlp.cu``.  It replaces the TPU kernel
``opencl_montecarlo_path_tracing_tpu/ops/pallas_bpt.py::film_vlp_mega`` ->
``_vlp_mega_kernel``.

The wrapper builds the VLP table on the device: live rows first (a stable
compaction), each row (px, py, pz, max(I, 0), |p|^2) padded to 8 floats,
and in grid mode six more floats - the VLP's clipped cell-index box, the
binning of ``ops/grid.py::build_grid_cellscan`` - padded to 12.  The live
count reaches the kernel as a device int32, so the host never waits.  The
kernel scans every live row, masked by cell membership in grid mode, so
it is uncapped where the tier-1 grid gather keeps at most 62 items a cell:
the two agree wherever no live VLP overflows a cell.

The kernel has two routes for the triangles, chosen by :func:`uses_walk`
before the launch:

* up to ``MAX_SMEM_TRIANGLES`` (512) the table is staged in shared memory
  and scanned in index-order blocks of 32 rows behind per-warp votes over
  :func:`tri_block_boxes`; ``cull=False`` launches the instantiation that
  scans every block (the same film, for the tests);
* past 512 triangles (or with ``force_walk=True``, for the tests) shared
  memory holds the scene without triangles, and each lane walks its
  camera ray and its shadow rays through the exact uniform grid of
  ``ops/exact_grid.py`` in device memory (every (cell, triangle) overlap,
  no cap; built once per prepared scene and device).

:func:`vlp_stats` launches the counting instantiation of either route.

``film_vlp_mega_plain`` is the same function in plain PyTorch - the
tier-1 composition ``accumulate_spp(sample_super(illum_fn=illum_vlp))``
with its dense gather pinned to the scan - on any device.  The wrapper
takes it only when the film's device is the CPU; on a CUDA device it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quirks import Quirks, DEFAULT
from ..models import common as C
from .exact_grid import check_tables, exact_grid
from .intersect import SceneArrays, derived
from .mega_super import (MAX_LIGHTS, MAX_SMEM_TRIANGLES, _check, _stream,
                         _u32_arg, scene_buffer)
from .vlp import live_first, vlp_aabbs

#: Launches of the CUDA kernel since the last reset (the wrapper adds one
#: per launch and nowhere else).
LAUNCHES = 0

DENSE_STRIDE = 8    # floats per table row: px py pz I |p|^2 + 3 pad
GRID_STRIDE = 12    # + clo.xyz chi.xyz + 1 pad
#: Shared memory a block gives the VLP table: live rows that fit (512 dense
#: rows, 341 in grid mode) are staged once a launch, larger tables a chunk
#: of that many rows at a time, every sample.  16 KiB beside the demo
#: scene's 4.8 KiB keeps 8 blocks of 128 threads an SM.
VLP_SMEM_BYTES = 16 * 1024
TRI_BLOCK_ROWS = 32   # triangle rows a culled block (csrc/mega_vlp.cu)


def unsupported_reason(scn: SceneArrays, quirks: Quirks = DEFAULT,
                       max_bounces: int = C.MAX_BOUNCES) -> str | None:
    """Why the kernel cannot render this configuration, or None when it
    can (the port's form of ``pallas_bpt.supported()``).

    It differs from the JAX gate only where the film is provably the same:
    any mesh size (past 512 triangles the walk route), and any ``quirks``
    - the one the JAX gate refuses, ``shadow_carry_t``, is read only by
    the super family's direct light (``models/super.py::illum_direct``),
    never by the VLP family's ``illum_vlp`` or ``any_hit``, so a VLP film
    under ``REFERENCE_LMEM`` is the film under ``REFERENCE``."""
    nl = int(scn.lights.shape[0])
    if nl > MAX_LIGHTS:
        return (f"{nl} lights: the VLP megakernel covers <= {MAX_LIGHTS} "
                "lights (8 RNG sites per bounce)")
    if max_bounces < 1:
        return f"max_bounces={max_bounces}: the VLP megakernel runs one bounce"
    return None


def uses_walk(scn: SceneArrays, force_walk: bool = False) -> bool:
    """Whether ``film_vlp_mega`` walks the exact grid (past
    ``MAX_SMEM_TRIANGLES``, or forced on any mesh with triangles), else
    stages the triangle table in shared memory."""
    nt = int(scn.tri_v0.shape[0])
    return nt > MAX_SMEM_TRIANGLES or (bool(force_walk) and nt > 0)


def vlp_table(vlps, grid=None):
    """The kernel's (nvp, 8|12) float32 VLP table, live rows first (stable),
    and the live count as a (1,) int32 tensor, both on ``vlps``' device;
    in grid mode also the 9 grid floats (vmin, cell size, resolution)."""
    v, n_live = live_first(vlps)
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    cols = [p0, p1, p2, torch.clamp_min(v[:, 3], 0.0),
            p0 * p0 + p1 * p1 + p2 * p2]
    zero = torch.zeros_like(p0)
    gridp = None
    if grid is None:
        cols += [zero] * 3
    else:
        # clipped cell-index box, exactly as pallas_bpt.py:376-391: dead
        # VLPs' far boxes clip to the corner cell, beyond n_live anyway
        amin, amax = vlp_aabbs(v)
        res_f = torch.as_tensor(grid.res, dtype=torch.float32,
                                device=v.device)
        vmin = grid.vmin.to(v.device)
        cell = grid.cell_size.to(v.device)
        clo = torch.minimum(torch.clamp_min(
            torch.floor((amin - vmin) / cell), 0.0), res_f - 1.0)
        chi = torch.minimum(torch.clamp_min(
            torch.floor((amax - vmin) / cell), 0.0), res_f - 1.0)
        cols += list(clo.unbind(1)) + list(chi.unbind(1)) + [zero]
        gridp = torch.cat([vmin, cell, res_f]).contiguous()
    tab = torch.stack(cols, dim=1)
    if tab.shape[0] == 0:
        tab = torch.zeros((1, len(cols)), dtype=torch.float32,
                          device=v.device)
    return tab.contiguous(), n_live, gridp


def tri_block_boxes(scn: SceneArrays) -> np.ndarray:
    """(1 + n_blocks, 8) float32 records of the shared-memory route's
    triangle cull (the walk route reads the exact grid instead),
    each lo.xyz, a row count (int32 bits), hi.xyz, 0: the triangles in
    index order, ``TRI_BLOCK_ROWS`` a block, each block's box the bounds of
    its triangles (v0, v0 + e0, v0 + e2 in float32, as
    ``ops/tri_blocks.py`` computes them) padded by 1e-3 x their extent +
    1e-4, the Morton block tables' pad; record 0 the mesh, the union of
    the blocks' boxes (all zero without triangles)."""
    nt = int(scn.tri_v0.shape[0])
    nb = -(-nt // TRI_BLOCK_ROWS)
    v0 = np.asarray(scn.tri_v0, np.float32)
    v1 = v0 + np.asarray(scn.tri_e0, np.float32)
    v2 = v0 + np.asarray(scn.tri_e2, np.float32)
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    recs = np.zeros((1 + nb, 8), np.float32)
    for b in range(nb):
        sl = slice(b * TRI_BLOCK_ROWS, min((b + 1) * TRI_BLOCK_ROWS, nt))
        blo, bhi = lo[sl].min(axis=0), hi[sl].max(axis=0)
        pad = 1e-3 * (bhi - blo) + 1e-4
        recs[1 + b, 0:3] = blo - pad
        recs[1 + b, 3] = np.int32(sl.stop - sl.start).view(np.float32)
        recs[1 + b, 4:7] = bhi + pad
    if nb:
        recs[0, 0:3] = recs[1:, 0:3].min(axis=0)
        recs[0, 3] = np.int32(nt).view(np.float32)
        recs[0, 4:7] = recs[1:, 4:7].max(axis=0)
    return recs


def kernel_inputs(scn: SceneArrays, device, walk: bool = False) -> tuple:
    """(scene buffer, padded triangle count, boxes, grid) on ``device``,
    built once per prepared scene and device.  The shared-memory route:
    ``mega_super.scene_buffer`` and :func:`tri_block_boxes`, no grid
    (None).  The walk route: the scene without triangles (0 rows), no
    boxes (None) and the ``exact_grid.ExactGrid`` of the mesh."""
    if walk:
        return (*scene_buffer(scn, device, triangles=False), None,
                exact_grid(scn, device))
    boxes = derived(scn, "mega_vlp.tri_block_boxes", device,
                    lambda s: torch.from_numpy(tri_block_boxes(s)).to(device))
    return (*scene_buffer(scn, device), boxes, None)


def film_vlp_mega_plain(key, scn: SceneArrays, vlps, width: int,
                        height: int, spp: int, spp_offset: int = 0,
                        spp_total: int | None = None,
                        quirks: Quirks = DEFAULT, row_offset: int = 0,
                        rows: int | None = None, grid=None, device="cpu",
                        max_bounces: int = C.MAX_BOUNCES):
    """Plain PyTorch version of :func:`film_vlp_mega` (same signature and
    output), on any device; its dense gather is the plain scan."""
    from ..models.bidirectional import film_vlp_plain
    device = torch.device(device)
    if spp_total is None:
        spp_total = spp
    return film_vlp_plain(key, scn, torch.as_tensor(vlps, device=device),
                          grid, width, height, spp, spp_offset, spp_total,
                          quirks, max_bounces, row_offset, rows, device)


def film_vlp_mega(key, scn: SceneArrays, vlps, width: int, height: int,
                  spp: int, spp_offset: int = 0,
                  spp_total: int | None = None, quirks: Quirks = DEFAULT,
                  row_offset: int = 0, rows: int | None = None, grid=None,
                  device="cuda", chunk_rows: int | None = None,
                  cull: bool = True, force_walk: bool = False):
    """Pre-ambient (rows, W, 3) float32 film of the band
    [row_offset, row_offset+rows) with global samples
    [spp_offset, spp_offset+spp) of spp_total, gathering the (V, 4) VLP
    table ``vlps`` (grid-limited when ``grid`` is an ops/grid.py
    ``UniformGrid`` over it), on ``device``.

    On a CUDA device: one launch of the CUDA kernel, on the route
    :func:`uses_walk` picks; raises ``NotImplementedError`` for a
    configuration it does not cover.  On the CPU:
    :func:`film_vlp_mega_plain`.  ``chunk_rows`` sets how many table rows
    the kernel stages at a time (default: ``VLP_SMEM_BYTES`` of rows) and
    ``cull=False`` launches the shared-memory route's instantiation without
    the triangle cull; the film depends on neither.  ``force_walk=True``
    (for the tests) walks the exact grid on a mesh of <= 512 triangles
    too: the same film up to the triangles' visiting order."""
    device = torch.device(device)
    if spp_total is None:
        spp_total = spp
    if rows is None:
        rows = height
    if quirks is None:
        quirks = DEFAULT
    if device.type == "cpu":
        return film_vlp_mega_plain(key, scn, vlps, width, height, spp,
                                   spp_offset, spp_total, quirks,
                                   row_offset, rows, grid, device)
    out = _film_out(scn, quirks, device, width, rows)
    _launch(key, scn, vlps, grid, spp, spp_offset, spp_total, quirks,
            row_offset, out, chunk_rows, cull, uses_walk(scn, force_walk),
            None)
    return out


def _film_out(scn: SceneArrays, quirks: Quirks, device, width, rows):
    """The kernel's (rows, W, 3) output on a CUDA ``device``, after the
    gate and the shape checks."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    reason = unsupported_reason(scn, quirks)
    if reason is not None:
        raise NotImplementedError(reason)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "false; the port never renders a CUDA request on the CPU")
    width, rows = int(width), int(rows)
    if width <= 0 or rows <= 0:
        raise ValueError(f"bad film shape: {rows}x{width}")
    if rows * width >= 1 << 31:
        raise ValueError(f"{rows}x{width} pixels exceed the int32 index")
    return torch.empty((rows, width, 3), dtype=torch.float32, device=device)


def _launch(key, scn: SceneArrays, vlps, grid, spp, spp_offset, spp_total,
            quirks: Quirks, row_offset, out, chunk_rows, cull: bool,
            walk: bool, stats):
    """One launch of B4 into ``out``, on the walk route when ``walk``;
    ``stats`` (a zeroed int64 tensor of ``len(STAT_NAMES)`` slots, or None)
    makes it the counting instantiation."""
    global LAUNCHES
    device = out.device
    rows, width = int(out.shape[0]), int(out.shape[1])
    spp = int(spp)
    if spp < 0:
        raise ValueError(f"spp={spp} < 0")
    if walk and not cull:
        raise ValueError("cull=False names the shared-memory route's "
                         "cull-free instantiation; the walk has none")
    buf, ntp, boxes, xg = kernel_inputs(scn, device, walk)
    tab, n_live, gridp = vlp_table(torch.as_tensor(vlps, device=device),
                                   grid)
    stride = DENSE_STRIDE if gridp is None else GRID_STRIDE
    tris = () if walk else (("triangle boxes", boxes),)
    _check((("scene", buf), ("vlp table", tab), ("out", out)) + tris
           + ((("grid", gridp),) if gridp is not None else ()), device)
    if walk:
        check_tables(xg, device)
    if n_live.device != device or n_live.dtype != torch.int32:
        raise ValueError(f"n_live must be an int32 tensor on {device}")
    if tab.shape[1] != stride or tab.shape[0] >= 1 << 27:
        raise ValueError(f"bad VLP table shape {tuple(tab.shape)}")
    if chunk_rows is None:
        chunk_rows = VLP_SMEM_BYTES // (4 * stride)
    if not 1 <= int(chunk_rows) <= 4096:
        raise ValueError(f"chunk_rows={chunk_rows} outside [1, 4096]")
    nl = int(scn.lights.shape[0])
    inv_nl = float(np.float32(1.0 / nl)) if nl else 0.0

    from ..utils.build import load
    lib = load()
    with torch.cuda.device(device):
        err = lib.mega_vlp_launch(
            buf.data_ptr(), ntp, nl, int(scn.sphere_centers.shape[0]),
            int(scn.square_k.shape[0]),
            *((None, 0, xg.rows.data_ptr(), xg.span.data_ptr(),
               xg.occ.data_ptr(), xg.ids.data_ptr(), xg.frame.data_ptr(),
               *xg.res) if walk else
              (boxes.data_ptr(), int(boxes.shape[0]), None, None, None,
               None, None, 0, 0, 0)),
            _u32_arg("k0", key[0]),
            _u32_arg("k1", key[1]), _u32_arg("spp_offset", spp_offset),
            _u32_arg("spp_total", spp_total),
            _u32_arg("row_offset", row_offset), rows, width, spp,
            int(bool(quirks.accept_negative_t)), tab.data_ptr(),
            int(tab.shape[0]), stride, int(chunk_rows), n_live.data_ptr(),
            None if gridp is None else gridp.data_ptr(), inv_nl,
            int(bool(cull)), out.data_ptr(),
            None if stats is None else stats.data_ptr(), _stream(device))
    if err != 0:
        msg = lib.mega_vlp_error_string(err).decode()
        raise RuntimeError(f"mega_vlp launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1


#: B4's work tally, in the order of its slots (csrc/mega_vlp.cu, Slot).
STAT_NAMES = ("cam_rest", "cam_tri", "gather", "shadow_rest", "shadow_tri",
              "stage", "kernel", "lit", "casts", "casts_tri", "tested",
              "gather_pairs", "walks", "entered", "cells", "empty", "pairs",
              "clk_setup", "clk_empty", "clk_loads", "clk_pairs",
              "clk_step")


def vlp_stats(key, scn: SceneArrays, vlps, width: int, height: int,
              spp: int, spp_offset: int = 0, spp_total: int | None = None,
              quirks: Quirks = DEFAULT, grid=None, cull: bool = True,
              device="cuda", force_walk: bool = False) -> dict:
    """B4's work over one render pass of this configuration (one launch of
    the counting instantiation on ``device``, on the route ``film_vlp_mega``
    takes, the shared-memory one with or without the cull; the film is
    discarded):

    * ``lit``: samples whose primary ray hits the floor or a diffuse
      surface (the shading gathers and casts there); ``casts``: their
      shadow rays, one a light; ``casts_tri``: those not occluded by the
      floor, squares or spheres, which reach the triangles;
    * ``tested``: (ray, triangle) pairs the warps pay (32 lanes x the
      rows a warp scans, or on the walk route x its pair iterations,
      camera and shadow rays);
    * ``gather_pairs``: (lit sample, live VLP) terms gathered (in grid mode
      those of the shading point's cell);
    * clock64 cycles summed over warps: ``cam_rest`` / ``cam_tri``, the
      camera trace's floor, squares and spheres / its triangle blocks
      (votes and scans); ``gather``; ``shadow_rest`` / ``shadow_tri``
      likewise for the shadow rays; ``stage``, the VLP table's staging
      with its syncs; ``kernel``, the whole kernel (the rest - threefry,
      camera, shading - is ``kernel`` less the others);
    * on the walk route (0 on the other), summed over lanes: ``walks``
      (the camera rays of the film's pixels and the casts that reach the
      triangles), ``entered`` (those that enter the grid), ``cells``
      visited, ``empty`` cells among them, ``pairs`` the lanes test (at
      most ``tested``); and the warps' clock64 cycles of the walks, split:
      ``clk_setup`` (the DDA set-up), ``clk_empty`` (iterations in which
      no lane tests a pair: empty cells and their steps), ``clk_loads``
      and ``clk_pairs`` (the occupied cells' row loads and pair
      arithmetic), ``clk_step`` (their end tests and steps).  The counting
      instantiation walks a warp's lanes in lockstep (each occupied step
      runs its lanes' largest cell); its film is the timed one's."""
    device = torch.device(device)
    if spp_total is None:
        spp_total = spp
    out = _film_out(scn, quirks, device, width, height)
    stats = torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=device)
    _launch(key, scn, vlps, grid, spp, spp_offset, spp_total, quirks, 0,
            out, None, cull, uses_walk(scn, force_walk), stats)
    return dict(zip(STAT_NAMES, stats.tolist()))
