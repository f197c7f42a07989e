"""Uniform-grid acceleration on PyTorch tensors: atomics-free builds and the
masked DDA traversal.

Port of ``opencl_montecarlo_path_tracing_tpu/ops/grid.py``.  The
reference scatters item ids into ``Cell{nels, elem_index[62]}`` with
``atomic_inc`` and drops overflow (``initTrianglesGrid``,
trianglegrid/pathtracer.ocl:285-330; ``initVLPsGrid``,
metropolispathtracer.ocl:620-646), which makes cell contents
nondeterministic.  The builds here keep, for every cell, the first ``cap``
items in ascending index whose AABB overlaps it, and the overlap count
clamped to ``cap`` - the deterministic analogue, with ``items``/``counts``
equal to the JAX package's exactly:

* ``build_grid_pairs``: pair enumeration with a static per-item span
  bound and a stable sort (triangles);
* ``build_grid_cellscan``: a per-cell scan over items (VLPs, whose radius
  can span the whole grid);
* ``build_grid_host``: the NumPy oracle (the reference's disabled host
  builder, trianglegrid .c:233-265).

``triangle_grid`` builds the triangle grid of a scene with the reference's
resolution heuristic (.c:476-483), and ``traverse_triangles`` walks it per
ray with the 3-D DDA of TraceRay (ocl:157-198), testing each visited
cell's triangles in the division form of Moller-Trumbore.  The JAX
package compiles that walk as one XLA program (no Pallas kernel); its
port's form on the card is two hand-written CUDA kernels
(``csrc/mega_grid.cu``):

* B11w ``grid_walk``: the walk of given rays, one thread a ray, a warp
  testing the pairs of its lanes' cells together - what
  ``traverse_triangles`` launches for CUDA tensors, bit-equal to the
  plain walk below (reached on the CPU and through ``plain=True``);
* B11 ``film_grid_mega``: the whole mirror-free ``super`` sample step
  over the grid in one launch (``accel="dda"`` inside the super kernels'
  gate), held to the plain DDA film under the CRN contract.

``triangle_tables`` caches a scene's grid with the tables the kernels
read (``GridTables``: the frame, the occupancy bitmap, each cell's
triangle rows in cell order) once per prepared scene, modifier, build and
device; ``walk_tables`` those of the grid the tier-1 wavefront walks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.quirks import Quirks, DEFAULT
from ..utils import debug as dbg
from .intersect import SceneArrays, _tri_table, _mt_test, derived

MAX_NELS_PER_CELL = 62  # reference cap (.ocl:1)

#: Launches of kernel B11 (``film_grid_mega``) and of kernel B11w
#: (``grid_walk``) since the last reset (each wrapper adds one per launch
#: and nowhere else).
MEGA_LAUNCHES = 0
WALK_LAUNCHES = 0
#: The slots of both kernels' work tally (csrc/mega_grid.cu, Tally): grid
#: walks, walks that enter the grid, cells visited, pairs tested (the
#: bound's work); the warp-paid cell steps and the lanes' cells of camera
#: and shadow walks (B11w: every walk is a camera walk); the warp steps a
#: per-lane schedule across samples and walks would pay (each warp's
#: largest lane sum of camera / shadow / all cells); visited empty cells;
#: clock64 cycles summed over warps: the camera ray and pre_tri (B11w: its
#: inputs), the walks' set-up, all-empty iterations, the occupied
#: iterations' loads, pair arithmetic and step, the shadow set-up, the
#: shading (B11w: its outputs), the kernel; the warps' rounds of pair
#: tests (B11's lanes each test their own cell: a warp pays its lanes'
#: largest; B11w's warps pool theirs, 32 a round).
STAT_NAMES = ("walks", "entered", "cells", "pairs", "cam_warp_steps",
              "shadow_warp_steps", "cam_cells", "shadow_cells", "sched_cam",
              "sched_shadow", "sched_all", "empty", "clk_camera",
              "clk_setup", "clk_empty", "clk_occ_loads", "clk_pairs",
              "clk_occ_step", "clk_shadow", "clk_shade", "clk_kernel",
              "warp_pair_iters")


class UniformGrid(NamedTuple):
    items: torch.Tensor      # (ncells, cap) int32, -1 padded
    counts: torch.Tensor     # (ncells,) int32 (clamped to cap)
    res: tuple               # (rx, ry, rz) Python ints
    vmin: torch.Tensor       # (3,) float32, on the grid's device
    cell_size: torch.Tensor  # (3,) float32


def _cell_coords(pos, vmin, cell_size, res):
    """Float positions -> clamped integer cell coords (ocl:320-321).  The
    clamp happens in float before the cast, so out-of-range values (up to
    +-inf) saturate as the JAX package's conversion does."""
    hi = torch.as_tensor(res, dtype=torch.float32, device=pos.device) - 1.0
    c = torch.floor((pos - vmin) / cell_size)
    c = torch.minimum(torch.clamp_min(c, 0.0), hi)
    return c.to(torch.int32)


def build_grid_cellscan(aabb_min, aabb_max, vmin, cell_size, res,
                        cap: int = MAX_NELS_PER_CELL,
                        cell_chunk: int = 1024) -> UniformGrid:
    """Device build scanning items per cell (handles unbounded spans):
    for each cell the first ``cap`` items (ascending index) whose AABB
    overlaps it, and the overlap count clamped to ``cap``.  Cells are
    processed ``cell_chunk`` at a time to bound the (cells, items) mask."""
    dev = aabb_min.device
    n = aabb_min.shape[0]
    rx, ry, rz = (int(r) for r in res)
    ncells = rx * ry * rz
    vmin = torch.as_tensor(vmin, dtype=torch.float32, device=dev)
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    lo = _cell_coords(aabb_min, vmin, cell_size, (rx, ry, rz))
    hi = _cell_coords(aabb_max, vmin, cell_size, (rx, ry, rz))

    # cell id = cz * rx * ry + cy * rx + cx (x fastest)
    cid = torch.arange(ncells, dtype=torch.int64, device=dev)
    coords = torch.stack([cid % rx, (cid // rx) % ry, cid // (rx * ry)],
                         dim=-1).to(torch.int32)
    item_ids = torch.arange(n, dtype=torch.int32, device=dev)
    items, counts = [], []
    for c0 in range(0, ncells, cell_chunk):
        cc = coords[c0:c0 + cell_chunk]
        m = ((cc[:, None, :] >= lo[None, :, :]).all(dim=-1)
             & (cc[:, None, :] <= hi[None, :, :]).all(dim=-1))   # (C, N)
        rank = torch.cumsum(m.to(torch.int32), dim=1, dtype=torch.int32) - 1
        ok = m & (rank < cap)
        # cap+1 columns: non-members land in the scratch column, dropped
        it = torch.full((cc.shape[0], cap + 1), -1, dtype=torch.int32,
                        device=dev)
        if n:
            src = torch.where(ok, item_ids[None, :], -1)
            it.scatter_(1, torch.where(ok, rank, cap).to(torch.int64), src)
        items.append(it[:, :cap])
        counts.append(torch.clamp_max(m.sum(dim=1), cap).to(torch.int32))
    return UniformGrid(items=torch.cat(items), counts=torch.cat(counts),
                       res=(rx, ry, rz), vmin=vmin, cell_size=cell_size)


def grid_resolution(vmin, vmax, n_items: int, modifier: float = 3.0,
                    max_res: int = 128):
    """Host-side resolution heuristic (trianglegrid .c:476-483), each axis
    clamped at ``max_res`` (the reference's 128)."""
    size = np.asarray(vmax, np.float64) - np.asarray(vmin, np.float64)
    vol = float(size[0] * size[1] * size[2])
    if vol <= 0 or n_items == 0:
        return (1, 1, 1)
    cr = np.cbrt(modifier * n_items / vol)
    res = np.floor(size * cr).astype(np.int64)
    return tuple(int(max(1, min(r, max_res))) for r in res)


def build_grid_pairs(aabb_min, aabb_max, vmin, cell_size, res,
                     cap: int = MAX_NELS_PER_CELL,
                     max_span: tuple = (4, 4, 4)) -> UniformGrid:
    """Device build by pair enumeration + stable sort.  ``max_span`` is
    the static per-axis bound on the cells one item's AABB may overlap
    (items exceeding it are clipped - callers size it from the data)."""
    dev = aabb_min.device
    n = aabb_min.shape[0]
    rx, ry, rz = (int(r) for r in res)
    ncells = rx * ry * rz
    vmin = torch.as_tensor(vmin, dtype=torch.float32, device=dev)
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    lo = _cell_coords(aabb_min, vmin, cell_size, (rx, ry, rz)).to(torch.int64)
    hi = _cell_coords(aabb_max, vmin, cell_size, (rx, ry, rz)).to(torch.int64)
    sx, sy, sz = max_span
    offs = np.stack(np.meshgrid(np.arange(sx), np.arange(sy), np.arange(sz),
                                indexing="ij"), -1).reshape(-1, 3)
    offs = torch.as_tensor(offs, dtype=torch.int64, device=dev)
    cells = lo[:, None, :] + offs[None, :, :]             # (N, S, 3)
    valid = (cells <= hi[:, None, :]).all(dim=-1)
    cid = cells[..., 2] * (rx * ry) + cells[..., 1] * rx + cells[..., 0]
    cid = torch.where(valid, cid, ncells)
    item = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    item = item.expand(cid.shape)
    # pairs are enumerated item-major, so a stable sort on cell id keeps
    # item indices ascending within each cell
    order = torch.argsort(cid.reshape(-1), stable=True)
    cid_s = cid.reshape(-1)[order]
    item_s = item.reshape(-1)[order]
    first = torch.searchsorted(cid_s, cid_s, right=False)
    rank = torch.arange(cid_s.shape[0], device=dev) - first
    ok = (cid_s < ncells) & (rank < cap)
    items = torch.full((ncells + 1, cap), -1, dtype=torch.int32, device=dev)
    items[cid_s[ok], rank[ok]] = item_s[ok].to(torch.int32)
    counts = torch.bincount(cid_s, minlength=ncells + 1)[:ncells]
    counts = torch.clamp_max(counts, cap).to(torch.int32)
    return UniformGrid(items=items[:ncells], counts=counts,
                       res=(rx, ry, rz), vmin=vmin, cell_size=cell_size)


def build_grid_host(aabb_min, aabb_max, vmin, cell_size, res,
                    cap: int = MAX_NELS_PER_CELL, device="cpu") -> UniformGrid:
    """NumPy oracle build (the reference's disabled host builder,
    trianglegrid .c:233-265, with deterministic ascending-index order);
    the result moves to ``device``."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    rx, ry, rz = (int(r) for r in res)
    ncells = rx * ry * rz
    items = np.full((ncells, cap), -1, np.int32)
    counts = np.zeros(ncells, np.int32)
    vmin = np.asarray(vmin, np.float32)
    cell_size = np.asarray(cell_size, np.float32)
    res_a = np.asarray((rx, ry, rz), np.int64)
    for i in range(aabb_min.shape[0]):
        lo = np.clip(np.floor((aabb_min[i] - vmin) / cell_size)
                     .astype(np.int64), 0, res_a - 1)
        hi = np.clip(np.floor((aabb_max[i] - vmin) / cell_size)
                     .astype(np.int64), 0, res_a - 1)
        for z in range(lo[2], hi[2] + 1):
            for y in range(lo[1], hi[1] + 1):
                for x in range(lo[0], hi[0] + 1):
                    c = z * rx * ry + y * rx + x
                    if counts[c] < cap:
                        items[c, counts[c]] = i
                    counts[c] += 1
    counts = np.minimum(counts, cap)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return UniformGrid(items=t(items), counts=t(counts), res=(rx, ry, rz),
                       vmin=t(vmin), cell_size=t(cell_size))


def grid_stats(grid: UniformGrid) -> dict:
    """Debug statistics - the analogue of the reference's (disabled)
    printTrianglesGrid kernel (trianglegrid/pathtracer.ocl:332-346)."""
    counts = grid.counts.cpu().numpy()
    occupied = counts > 0
    return {
        "ncells": int(counts.size),
        "total_nels": int(counts.sum()),
        "occupied_cells": int(occupied.sum()),
        "max_nels": int(counts.max(initial=0)),
        "mean_nels_occupied": (float(counts[occupied].mean())
                               if occupied.any() else 0.0),
        "capacity": int(grid.items.shape[1]),
        "res": tuple(grid.res),
    }


def max_cell_occupancy(amin, amax, vmin, cell_size, res) -> int:
    """Host-side max items per cell (a difference-array histogram over the
    items' cell ranges), which sizes the per-cell capacity: the table
    shrinks to the true occupancy when it is below the cap."""
    rx, ry, rz = res
    res_a = np.asarray(res, np.int64)
    lo = np.clip(np.floor((amin - vmin) / cell_size).astype(np.int64), 0,
                 res_a - 1)
    hi = np.clip(np.floor((amax - vmin) / cell_size).astype(np.int64), 0,
                 res_a - 1)
    diff = np.zeros((rz + 1, ry + 1, rx + 1), np.int64)
    np.add.at(diff, (lo[:, 2], lo[:, 1], lo[:, 0]), 1)
    np.add.at(diff, (hi[:, 2] + 1, lo[:, 1], lo[:, 0]), -1)
    np.add.at(diff, (lo[:, 2], hi[:, 1] + 1, lo[:, 0]), -1)
    np.add.at(diff, (lo[:, 2], lo[:, 1], hi[:, 0] + 1), -1)
    np.add.at(diff, (hi[:, 2] + 1, hi[:, 1] + 1, lo[:, 0]), 1)
    np.add.at(diff, (hi[:, 2] + 1, lo[:, 1], hi[:, 0] + 1), 1)
    np.add.at(diff, (lo[:, 2], hi[:, 1] + 1, hi[:, 0] + 1), 1)
    np.add.at(diff, (hi[:, 2] + 1, hi[:, 1] + 1, hi[:, 0] + 1), -1)
    counts = diff.cumsum(0).cumsum(1).cumsum(2)[:rz, :ry, :rx]
    return int(counts.max(initial=0))


def triangle_grid(scn: SceneArrays, modifier: float = 3.0,
                  cap: int = MAX_NELS_PER_CELL, device_build: bool = True,
                  device="cpu"):
    """The triangle grid of a scene on ``device``: (grid, box) with box =
    (vmin, vmax) numpy.  ``device_build`` picks the pair build (on
    ``device``) or the host oracle; ``cap`` is an upper bound - the
    per-cell capacity is the scene's true max occupancy when smaller."""
    v = np.concatenate([scn.tri_v0[:, None, :],
                        (scn.tri_v0 + scn.tri_e0)[:, None, :],
                        (scn.tri_v0 + scn.tri_e2)[:, None, :]], axis=1)
    amin = v.min(axis=1)
    amax = v.max(axis=1)
    vmin = amin.min(axis=0)
    vmax = amax.max(axis=0)
    res = grid_resolution(vmin, vmax, v.shape[0], modifier)
    cell = ((vmax - vmin) / np.asarray(res, np.float32)).astype(np.float32)
    cap = max(1, min(cap, max_cell_occupancy(amin, amax, vmin, cell, res)))
    if device_build:
        span = (np.floor((amax - amin) / np.maximum(cell, 1e-20))
                .astype(np.int64) + 2)
        max_span = tuple(int(min(s, r)) for s, r in zip(span.max(axis=0), res))
        grid = build_grid_pairs(torch.as_tensor(amin, device=device),
                                torch.as_tensor(amax, device=device),
                                vmin, cell, res, cap, max_span)
    else:
        grid = build_grid_host(amin, amax, vmin, cell, res, cap, device)
    return grid, (vmin.astype(np.float32), vmax.astype(np.float32))


class GridTables(NamedTuple):
    """A triangle grid with what its kernels read, on one device."""
    grid: UniformGrid
    tri: torch.Tensor     # (N, 12) float32: ops/intersect.py::_tri_table
    frame: torch.Tensor   # (9,) float32: vmin, vmax, cell size
    occ: torch.Tensor     # (ceil(ncells / 32),) int32: occupancy_bits
    rows: torch.Tensor    # (sum of the counts, 12) float32: cell_rows
    span: torch.Tensor    # (ncells, 2) int32: cell_rows


def grid_frame(grid: UniformGrid) -> torch.Tensor:
    """(9,) float32 on the grid's device: vmin, vmax, cell_size, with vmax
    = vmin + cell_size * res computed as :func:`traverse_triangles` does."""
    res = torch.tensor(grid.res, dtype=torch.float32,
                       device=grid.vmin.device)
    vmax = grid.vmin + grid.cell_size * res
    return torch.cat([grid.vmin, vmax, grid.cell_size]).contiguous()


def occupancy_bits(counts: torch.Tensor) -> torch.Tensor:
    """The grid's occupancy bitmap on ``counts``' device: int32 word c // 32
    holds bit c % 32 set where cell c has a triangle (``counts[c] > 0``),
    the bits past the last cell clear."""
    n = int(counts.numel())
    words = (n + 31) // 32
    bits = torch.zeros(words * 32, dtype=torch.int64, device=counts.device)
    bits[:n] = (counts.reshape(-1) > 0).to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=counts.device)
    w = (bits.view(words, 32) << shift).sum(dim=1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def cell_rows(grid: UniformGrid, tri: torch.Tensor) -> tuple:
    """The triangle rows the kernels read, cell-major: for each cell in
    index order the rows of ``tri`` (``_tri_table``) of its live slots
    (slot k < count, id >= 0: the pairs the plain walk tests) in slot
    order, and each cell's (first row, rows) as an (ncells, 2) int32
    tensor, on ``tri``'s device.  A pair's row then depends on its cell
    and slot alone."""
    items = grid.items.to(tri.device)
    counts = grid.counts.to(tri.device)
    slot = torch.arange(items.shape[1], device=tri.device)
    live = (slot[None, :] < counts[:, None]) & (items >= 0)
    n = live.sum(dim=1)
    if int(n.sum()) >= 1 << 31:
        raise ValueError("the grid's slots exceed the int32 row index")
    span = torch.stack([torch.cumsum(n, 0) - n, n], dim=1)
    rows = tri[items[live].to(torch.int64)]
    return rows.contiguous(), span.to(torch.int32).contiguous()


def grid_tables(scn: SceneArrays, grid: UniformGrid, device) -> GridTables:
    """``grid`` on ``device`` with the scene's triangle table (built once
    per prepared scene and device), the grid's frame, its occupancy bitmap
    and its cell-major rows."""
    device = torch.device(device)
    tri = derived(scn, "grid.tri_table", device,
                  lambda s: torch.from_numpy(_tri_table(s)).to(device))
    g = grid._replace(items=grid.items.to(device).contiguous(),
                      counts=grid.counts.to(device).contiguous(),
                      vmin=grid.vmin.to(device), cell_size=grid.cell_size.to(
                          device))
    return GridTables(g, tri, grid_frame(g), occupancy_bits(g.counts),
                      *cell_rows(g, tri))


_WALK_TABLES: dict = {}


def walk_tables(scn: SceneArrays, grid: UniformGrid, device) -> GridTables:
    """:func:`grid_tables` of ``grid`` (the very object) on ``device``,
    kept for the last few (scene, grid, device): the tier-1 wavefront
    passes the same grid to every walk."""
    device = torch.device(device)
    key = (id(scn), id(grid), str(device))
    hit = _WALK_TABLES.get(key)
    if hit is None or hit[0] is not scn or hit[1] is not grid:
        hit = (scn, grid, grid_tables(scn, grid, device))
        _WALK_TABLES[key] = hit
        while len(_WALK_TABLES) > 4:
            del _WALK_TABLES[next(iter(_WALK_TABLES))]
    return hit[2]


def triangle_tables(scn: SceneArrays, modifier: float = 3.0,
                    device_build: bool = True, device="cpu") -> GridTables:
    """The scene's triangle grid (:func:`triangle_grid`) and its kernels'
    tables on ``device``, built once per prepared scene, modifier, build
    and device (the host sizing and the build are paid on the first
    render, as the JAX package pays them once per compile)."""
    device = torch.device(device)

    def make(s):
        grid, _ = triangle_grid(s, modifier=modifier,
                                device_build=device_build, device=device)
        return grid_tables(s, grid, device)
    name = f"grid.triangle_tables/{float(modifier)!r}/{bool(device_build)}"
    return derived(scn, name, device, make)


def _launch_error(lib, what: str, err: int):
    msg = lib.mega_grid_error_string(err).decode()
    raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _grid_args(tab: GridTables, dev) -> tuple:
    """The kernels' grid arguments; the tables must lie on ``dev``."""
    from .mega_super import _check
    rx, ry, rz = tab.grid.res
    _check((("rows", tab.rows), ("frame", tab.frame)), dev)
    for name, a, n in (("span", tab.span, 2 * rx * ry * rz),
                       ("occ", tab.occ, (rx * ry * rz + 31) // 32)):
        if a.device != dev or a.dtype != torch.int32 \
                or not a.is_contiguous() or a.numel() != n:
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"{n} on {dev}")
    return (tab.rows.data_ptr(), tab.span.data_ptr(), tab.occ.data_ptr(),
            tab.frame.data_ptr(), rx, ry, rz)


def _column(x, shape, n: int, dtype, dev) -> tuple:
    """(tensor, element stride) through which B11w reads ``x`` broadcast
    to ``shape`` as n values: stride 0 where one value serves every ray,
    else the stride of a one-dimensional view (a copy only where the
    dtype differs or no such view exists)."""
    x = torch.as_tensor(x, device=dev)
    if x.dtype != dtype:
        x = x.to(dtype)
    b = torch.broadcast_to(x, shape)
    if n <= 1 or all(st == 0 for st in b.stride()):
        return x, 0
    try:
        flat = b.view(n)
    except RuntimeError:
        flat = b.reshape(n).contiguous()
    if flat.stride(0) >= 1 << 31:
        flat = flat.contiguous()
    return flat, flat.stride(0)


def grid_walk(o, d, t, m, nx, ny, nz, needs_norm, tables: GridTables,
              quirks: Quirks = DEFAULT, stats=None):
    """Kernel B11w: :func:`traverse_triangles` for each ray, one thread a
    ray; returns new (t, m, nx, ny, nz, needs) of the rays' shape.  The
    kernel reads each of t, m, nx, ny, nz and needs in place through its
    element stride (0 broadcasts one value, a scalar or a one-element
    tensor) and writes fresh outputs: one allocation a column, one launch.
    ``stats`` (a zeroed ``(len(STAT_NAMES),)`` int64 tensor, or None) makes
    it the counting instantiation, which adds its ``STAT_NAMES`` tally
    there.  On CPU tensors: the plain walk (no tally)."""
    global WALK_LAUNCHES
    dev = o.device
    shape = o.shape[:-1]
    f32 = torch.float32
    if dev.type == "cpu":
        cols = (torch.as_tensor(x).to(dt) for x, dt in zip(
            (t, m, nx, ny, nz, needs_norm),
            (f32, torch.int32, f32, f32, f32, torch.bool)))
        return tuple(torch.broadcast_to(x, shape) for x in _walk_plain(
            o, d, *cols, tables.tri, tables.grid, quirks))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 1 << 31:
        raise ValueError(f"{n} rays exceed the int32 index")
    o2 = o.reshape(-1, 3).to(torch.float32).contiguous()
    d2 = d.reshape(-1, 3).to(torch.float32).contiguous()
    tc, st = _column(t, shape, n, f32, dev)
    mc, sm = _column(m, shape, n, torch.int32, dev)
    nxc, nyc, nzc = (_column(x, shape, n, f32, dev) for x in (nx, ny, nz))
    needc, sneeds = _column(needs_norm, shape, n, torch.bool, dev)
    if stats is not None and (stats.dtype != torch.int64 or stats.device
                              != dev or stats.numel() != len(STAT_NAMES)):
        raise ValueError(f"stats must be {len(STAT_NAMES)} int64 counters "
                         f"on {dev}")
    outs = [torch.empty(n, dtype=dt, device=dev)
            for dt in (f32, torch.int32, f32, f32, f32, torch.bool)]
    args = _grid_args(tables, dev)
    from ..utils.build import load
    from .mega_super import _stream
    lib = load()
    with torch.cuda.device(dev):
        err = lib.grid_walk_launch(
            *args, o2.data_ptr(), d2.data_ptr(), tc.data_ptr(), st,
            mc.data_ptr(), sm, *(x for c in (nxc, nyc, nzc)
                                  for x in (c[0].data_ptr(), c[1])),
            needc.data_ptr(), sneeds,
            *(x.data_ptr() for x in outs), n,
            int(bool(quirks.accept_negative_t)),
            None if stats is None else stats.data_ptr(), _stream(dev))
    if err != 0:
        _launch_error(lib, "grid_walk", err)
    WALK_LAUNCHES += 1
    return tuple(x.view(shape) for x in outs)


def film_grid_mega(key, scn: SceneArrays, tables: GridTables, width: int,
                   height: int, spp: int, spp_offset: int = 0,
                   spp_total: int | None = None, quirks: Quirks = DEFAULT,
                   row_offset: int = 0, rows: int | None = None,
                   device="cuda", stats=None):
    """Pre-ambient (rows, W, 3) float32 film of the band [row_offset,
    row_offset+rows) with global samples [spp_offset, spp_offset+spp) of
    spp_total, every trace walking the grid of ``tables``, on ``device``.

    On a CUDA device: one launch of kernel B11; raises
    ``NotImplementedError`` for a scene outside the super kernels' gate
    (> 8 lights, > 2^20 triangles).  On the CPU: the plain DDA wavefront
    (models/trianglegrid.py::film_trianglegrid, ``plain=True``).
    ``stats`` as in :func:`grid_walk`."""
    global MEGA_LAUNCHES
    from . import mega_super as M
    device = torch.device(device)
    if spp_total is None:
        spp_total = spp
    if rows is None:
        rows = height
    if device.type == "cpu":
        from ..models.trianglegrid import film_trianglegrid
        return film_trianglegrid(key, scn, tables.grid, width, height, spp,
                                 spp_offset, spp_total, quirks,
                                 row_offset=row_offset, rows=rows,
                                 device=device, plain=True)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    reason = M.unsupported_reason(scn)
    if reason is not None:
        raise NotImplementedError(reason)
    width, rows, spp = int(width), int(rows), int(spp)
    if width <= 0 or rows <= 0 or spp < 0:
        raise ValueError(f"bad film shape/spp: {rows}x{width}, spp={spp}")
    if rows * width >= 1 << 31:
        raise ValueError(f"{rows}x{width} pixels exceed the int32 index")
    out = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
    device = out.device
    buf = M.scene_buffer(scn, device, triangles=False)[0]
    M._check((("scene", buf), ("out", out)), device)
    args = _grid_args(tables, device)
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(device):
        err = lib.mega_grid_launch(
            buf.data_ptr(), int(scn.lights.shape[0]),
            int(scn.sphere_centers.shape[0]), int(scn.square_k.shape[0]),
            *args, M._u32_arg("k0", key[0]), M._u32_arg("k1", key[1]),
            M._u32_arg("spp_offset", spp_offset),
            M._u32_arg("spp_total", spp_total),
            M._u32_arg("row_offset", row_offset), rows, width, spp,
            int(bool(quirks.accept_negative_t)),
            int(bool(quirks.shadow_carry_t)), out.data_ptr(),
            None if stats is None else stats.data_ptr(), M._stream(device))
    if err != 0:
        _launch_error(lib, "mega_grid", err)
    MEGA_LAUNCHES += 1
    return out


def mega_grid_stats(key, scn: SceneArrays, tables: GridTables, width: int,
                    height: int, spp: int, spp_offset: int = 0,
                    spp_total: int | None = None, quirks: Quirks = DEFAULT,
                    row_offset: int = 0, rows: int | None = None,
                    device="cuda") -> dict:
    """B11's work over one render of this configuration (one launch of the
    counting instantiation; the film is discarded): the ``STAT_NAMES``
    tally - grid walks (camera rays and cast shadow rays), walks that
    enter the grid, cells visited, pairs tested."""
    stats = torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=device)
    film_grid_mega(key, scn, tables, width, height, spp, spp_offset,
                   spp_total, quirks, row_offset, rows, device, stats)
    return dict(zip(STAT_NAMES, stats.tolist()))


def traverse_triangles(o, d, t, m, nx, ny, nz, needs_norm,
                       scn: SceneArrays, grid: UniformGrid,
                       quirks: Quirks = DEFAULT, plain: bool = False):
    """Walk the grid per ray, testing the (<= cap) triangles of each
    visited cell; updates the running (t, m, normal, needs) exactly like
    the brute-force scan.  Faithful to TraceRay's DDA (ocl:157-198),
    including its break conditions (the running-t check comes after
    stepping ``next``, so one extra cell may be visited).

    On CUDA tensors: kernel B11w (:func:`grid_walk`), unless ``plain``;
    on the CPU, or with ``plain=True``, the plain PyTorch walk below."""
    if o.device.type == "cuda" and not plain:
        tab = walk_tables(scn, grid, o.device)
        stats = None
        if dbg.enabled():
            stats = torch.zeros(len(STAT_NAMES), dtype=torch.int64,
                                device=o.device)
        out = grid_walk(o, d, t, m, nx, ny, nz, needs_norm, tab, quirks,
                        stats)
        if stats is not None:
            dbg.dprint("[grid DDA] rays={r} entered={e} cells_visited={v} "
                       "tri_hits={h}", r=out[0].numel(), e=stats[1],
                       v=stats[2], h=(out[1] == 4).sum())
        return out
    return _walk_plain(o, d, t, m, nx, ny, nz, needs_norm,
                       torch.from_numpy(_tri_table(scn)), grid, quirks)


def _walk_plain(o, d, t, m, nx, ny, nz, needs_norm, table, grid, quirks):
    """The plain walk of :func:`traverse_triangles` over the (N, 12)
    triangle table ``table``, on the rays' device."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    dev = o.device
    rx, ry, rz = grid.res
    vmin = grid.vmin.to(dev)
    cs = grid.cell_size.to(dev)
    vmax = vmin + cs * torch.as_tensor([rx, ry, rz], dtype=torch.float32,
                                       device=dev)
    table = table.to(dev)
    items = grid.items.to(dev)
    counts = grid.counts.to(dev)
    cap = items.shape[1]
    t = torch.broadcast_to(t, ox.shape)
    vminx, vminy, vminz = vmin.unbind(0)
    vmaxx, vmaxy, vmaxz = vmax.unbind(0)
    csx, csy, csz = cs.unbind(0)

    invx, invy, invz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    ex0 = torch.minimum((vminx - ox) * invx, (vmaxx - ox) * invx)
    ex1 = torch.maximum((vminx - ox) * invx, (vmaxx - ox) * invx)
    ey0 = torch.minimum((vminy - oy) * invy, (vmaxy - oy) * invy)
    ey1 = torch.maximum((vminy - oy) * invy, (vmaxy - oy) * invy)
    ez0 = torch.minimum((vminz - oz) * invz, (vmaxz - oz) * invz)
    ez1 = torch.maximum((vminz - oz) * invz, (vmaxz - oz) * invz)
    t0 = torch.maximum(torch.maximum(ex0, ey0), ez0)
    t1 = torch.minimum(torch.minimum(ex1, ey1), ez1)
    active = t0 <= t1   # the ray hits the grid box (ocl:165)

    inside = ((ox >= vminx) & (ox <= vmaxx) & (oy >= vminy) & (oy <= vmaxy)
              & (oz >= vminz) & (oz <= vmaxz))
    px = torch.where(inside, ox, ox + dx * t0)
    py = torch.where(inside, oy, oy + dy * t0)
    pz = torch.where(inside, oz, oz + dz * t0)

    def cell_of(p, v, c, r):
        return torch.clamp(torch.floor((p - v) / c).to(torch.int32), 0,
                           r - 1)

    f32 = torch.float32
    ix = cell_of(px, vminx, csx, rx)
    iy = cell_of(py, vminy, csy, ry)
    iz = cell_of(pz, vminz, csz, rz)
    # divide by tensors: torch divides a CUDA tensor by a Python scalar as
    # a multiply by its reciprocal (two roundings)
    rf = torch.tensor([rx, ry, rz], dtype=f32, device=dev)
    dlx = (ex1 - ex0) / rf[0]
    dly = (ey1 - ey0) / rf[1]
    dlz = (ez1 - ez0) / rf[2]
    posx, posy, posz = dx > 0, dy > 0, dz > 0
    nxx = torch.where(posx, ex0 + (ix + 1).to(f32) * dlx,
                      ex0 + float(rx) * dlx - ix.to(f32) * dlx)
    nxy = torch.where(posy, ey0 + (iy + 1).to(f32) * dly,
                      ey0 + float(ry) * dly - iy.to(f32) * dly)
    nxz = torch.where(posz, ez0 + (iz + 1).to(f32) * dlz,
                      ez0 + float(rz) * dlz - iz.to(f32) * dlz)
    stx = torch.where(posx, 1, -1).to(torch.int32)
    sty = torch.where(posy, 1, -1).to(torch.int32)
    stz = torch.where(posz, 1, -1).to(torch.int32)
    spx = torch.where(posx, rx, -1).to(torch.int32)
    spy = torch.where(posy, ry, -1).to(torch.int32)
    spz = torch.where(posz, rz, -1).to(torch.int32)

    # PT_KERNEL_DEBUG=1: the analog of the reference's commented-out DDA
    # printf (ocl:192) - aggregate visit statistics instead of per-ray
    # lines (utils/debug.py); unset, nothing is counted
    debug = dbg.enabled()
    entered = active
    visited = 0
    # a static trip count, as in the JAX package
    for _ in range(rx + ry + rz + 2):
        if debug:
            visited = visited + active.sum()
        cell = torch.clamp(iz * (rx * ry) + iy * rx + ix, 0,
                           rx * ry * rz - 1).to(torch.int64)
        cnt = counts[cell]
        rows = items[cell]                                  # (R, cap)
        trows = table[torch.clamp_min(rows, 0).to(torch.int64)]
        for kk in range(cap):
            tri = rows[:, kk]
            live = active & (kk < cnt) & (tri >= 0)
            row = trows[:, kk, :]                           # (R, 12)
            ok, rd = _mt_test(ox, oy, oz, dx, dy, dz, row.unbind(-1), quirks)
            ok = live & ok & (rd < t)
            t = torch.where(ok, rd, t)
            m = torch.where(ok, 4, m)
            nx = torch.where(ok, row[:, 9], nx)
            ny = torch.where(ok, row[:, 10], ny)
            nz = torch.where(ok, row[:, 11], nz)
            needs_norm = needs_norm & ~ok

        # step along the axis with the smallest next crossing (ocl:191-193)
        selx = (nxx <= nxy) & (nxx <= nxz)
        sely = ~selx & (nxy <= nxz)
        selz = ~selx & ~sely
        nxx = torch.where(selx, nxx + dlx, nxx)
        nxy = torch.where(sely, nxy + dly, nxy)
        nxz = torch.where(selz, nxz + dlz, nxz)
        next_ax = torch.where(selx, nxx, torch.where(sely, nxy, nxz))
        cont = ~(t < next_ax)                               # ocl:195
        ix = torch.where(cont & selx, ix + stx, ix)
        iy = torch.where(cont & sely, iy + sty, iy)
        iz = torch.where(cont & selz, iz + stz, iz)
        at_stop = (torch.where(selx, ix, torch.where(sely, iy, iz))
                   == torch.where(selx, spx, torch.where(sely, spy, spz)))
        active = active & cont & ~at_stop
    if debug:
        dbg.dprint(
            "[grid DDA] rays={r} entered={e} cells_visited={v} tri_hits={h}",
            r=entered.numel(), e=entered.sum(), v=visited, h=(m == 4).sum())
    return t, m, nx, ny, nz, needs_norm
