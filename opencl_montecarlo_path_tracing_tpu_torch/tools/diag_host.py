"""Host side of the grid cell-walk diagnostic (``tools/diag_dda.py``).

The port's copy of the host code of the JAX package's
``tools/diag_dda_pallas.py`` and ``tools/diag_blocked_host.py``, giving the
same arrays:

* ``primary_rays(size)``: all-pixel pinhole rays in float64
  (``diag_blocked_host.py:28-42``);
* the three culling structures as :class:`Boxes` - each box's triangle
  rows contiguous in one (n_rows, 16) float32 table (v0, e0, e2, unit
  normal, the triangle's index in the mesh file, 3 zeros), with its first
  row, row count and float64 AABB:
  ``cell_boxes`` (the occupied cells of the scene's triangle grid,
  ``build_tables`` at :254-274), ``morton_boxes`` (the large-mesh kernel's
  128-triangle Morton blocks, ``ops/tri_blocks.py::_tri_blocks``) and
  ``dense_boxes`` (every 128 rows of the file-order table);
* ``tile_lists``: per 64x32 pixel tile, the boxes any of the tile's rays
  crosses (``_lists_from_boxes`` and ``_interval_slab`` at :277-367),
  computed in float64 torch on any device - on the card it takes a
  fraction of a second where NumPy takes seconds a list;
* ``shadow_rays``: the shadow arm's segments from the closest-hit points
  to a light at (lx + 0.5, ly + 0.5, lz), and the kernel's inputs with
  NaN origins -> 1e9, NaN directions -> 1 and NaN limits -> -1
  (:386-417).

The TPU's (n_tiles * 16, 128) tile packing is not carried over: the port's
kernels take (height, width) maps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import make_camera
from ..ops.diag_dda import TILE_H, TILE_W
from ..ops.grid import triangle_grid
from ..ops.intersect import SceneArrays, _tri_table
from ..ops.tri_blocks import _TRI_BLOCK, _tri_blocks


class Boxes(NamedTuple):
    """A culling structure: boxes of contiguous triangle rows."""
    rows: np.ndarray    # (n_rows, 16) float32, column 12 the file index
    start: np.ndarray   # (n_boxes,) int32, first row of each box
    count: np.ndarray   # (n_boxes,) int32, rows of each box
    lo: np.ndarray      # (n_boxes, 3) float64 box corners
    hi: np.ndarray


class TileLists(NamedTuple):
    llen: np.ndarray    # (n_tiles,) int32 list lengths
    ids: np.ndarray     # (n_tiles, lmax) int32 box ids, zero padded


def primary_rays(size: int) -> tuple[np.ndarray, np.ndarray]:
    """All-pixel primary rays with zero jitter, (size * size, 3) float64
    origins and directions, pixel (ii, jj) at row jj * size + ii."""
    cam = make_camera(z_sign=-1.0)
    up = np.asarray(cam.up, np.float64)
    right = np.asarray(cam.right, np.float64)
    eyo = np.asarray(cam.eye_offset, np.float64)
    pos = np.asarray(cam.pos, np.float64)
    jj, ii = np.mgrid[0:size, 0:size].astype(np.float64)
    ax = ii.ravel() + 0.5
    ay = jj.ravel() + 0.5
    d = 16.0 * (up[None, :] * ax[:, None] + right[None, :] * ay[:, None]
                + eyo[None, :])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(pos, d.shape).copy()
    return o, d


def _rows16(tbl12: np.ndarray, index: np.ndarray) -> np.ndarray:
    rows = np.zeros((tbl12.shape[0], 16), np.float32)
    rows[:, :12] = tbl12
    rows[:, 12] = index            # exact in float32 below 2^24
    return rows


def cell_boxes(scn: SceneArrays, modifier: float = 3.0):
    """(grid, occupied cell ids, Boxes) of the scene's triangle grid: one
    box for each occupied cell, its rows the cell's triangles in grid
    order."""
    grid, _ = triangle_grid(scn, modifier)
    counts = grid.counts.numpy()
    items = grid.items.numpy()
    occ = np.flatnonzero(counts > 0)
    cnt = counts[occ].astype(np.int32)
    cap = items.shape[1]
    take = np.arange(cap)[None, :] < cnt[:, None]
    idx = items[occ][take]
    rows = _rows16(_tri_table(scn)[idx], idx)
    start = (np.cumsum(cnt) - cnt).astype(np.int32)
    rx, ry, _ = grid.res
    cz, cyx = np.divmod(occ, rx * ry)
    cy, cx = np.divmod(cyx, rx)
    cs = grid.cell_size.numpy().astype(np.float64)
    vmin = grid.vmin.numpy().astype(np.float64)
    lo = vmin + np.stack([cx, cy, cz], 1) * cs
    return grid, occ, Boxes(rows, start, cnt, lo, lo + cs)


def morton_boxes(scn: SceneArrays) -> Boxes:
    """The Morton blocks of ``_tri_blocks`` in its near-to-far order, each
    block's live rows (padding rows are not scanned); padding blocks get
    an inverted +-1e30 box that no ray crosses."""
    tblT, aabbs, _ = _tri_blocks(scn)
    nb = aabbs.shape[0]
    real = np.isfinite(aabbs).all(axis=1)
    lo = np.where(real[:, None], aabbs[:, :3], 1e30).astype(np.float64)
    hi = np.where(real[:, None], aabbs[:, 3:], -1e30).astype(np.float64)
    live = (tblT[12] < 2 ** 24).reshape(nb, _TRI_BLOCK)
    return Boxes(_rows16(tblT[:12].T, tblT[12]), np.arange(nb, dtype=np.int32)
                 * _TRI_BLOCK, live.sum(axis=1).astype(np.int32), lo, hi)


def dense_boxes(scn: SceneArrays) -> Boxes:
    """Every 128 rows of the file-order triangle table (no boxes: every
    tile lists every block)."""
    tbl = _tri_table(scn)
    nt = tbl.shape[0]
    start = np.arange(0, nt, _TRI_BLOCK, dtype=np.int32)
    count = np.minimum(_TRI_BLOCK, nt - start).astype(np.int32)
    return Boxes(_rows16(tbl, np.arange(nt)), start, count, None, None)


def dense_lists(n_boxes: int, width: int, height: int) -> TileLists:
    n_tiles = (width // TILE_W) * (height // TILE_H)
    ids = np.broadcast_to(np.arange(n_boxes, dtype=np.int32),
                          (n_tiles, n_boxes)).copy()
    return TileLists(np.full(n_tiles, n_boxes, np.int32), ids)


def _interval_slab(blo, bhi, olo, ohi, dlo, dhi, cap: float):
    """Conservative box-vs-ray-family slab: per axis the entry/exit
    interval of any ray with o in [olo, ohi], d in [dlo, dhi], from the
    4-corner inverse bound (float64 tensors; the bounds as Python
    floats)."""
    nb = blo.shape[0]
    f64, dev = torch.float64, blo.device
    res = torch.ones(nb, dtype=torch.bool, device=dev)
    tlo = torch.zeros(nb, dtype=f64, device=dev)
    thi = torch.full((nb,), min(cap, 1e30), dtype=f64, device=dev)
    zero = torch.zeros((), dtype=f64, device=dev)
    for a in range(3):
        o2 = torch.tensor([olo[a], ohi[a]], dtype=f64, device=dev)[:, None]
        lo_off = blo[:, a][None] - o2
        hi_off = bhi[:, a][None] - o2
        ds = [v for v in (dlo[a], dhi[a]) if v != 0]
        if not ds or dlo[a] < 0 < dhi[a]:
            # a ray family straddling zero direction can enter anywhere
            # along the axis: only reject when the box misses the o range
            reach = abs(cap) * max(abs(dlo[a]), abs(dhi[a]))
            miss = (bhi[:, a] < olo[a] - reach) | (blo[:, a] > ohi[a] + reach)
            res &= ~miss
            continue
        ds = torch.tensor(ds, dtype=f64, device=dev)
        invs = (torch.ones_like(ds) / ds)[:, None, None]
        cands = torch.cat([lo_off[None] * invs, hi_off[None] * invs], 0)
        cands = cands.reshape(-1, nb)
        tlo = torch.maximum(tlo, torch.maximum(cands.amin(dim=0), zero))
        thi = torch.minimum(thi, cands.amax(dim=0))
    return res & (thi >= tlo) & (thi >= 1e-2)


def tile_lists(o: np.ndarray, d: np.ndarray, boxes: Boxes, width: int,
               height: int, tmax_cap: np.ndarray | None = None,
               sort_near: bool = True, device="cpu") -> TileLists:
    """Per-tile box visitation: an interval prefilter per tile (a scalar
    slab on the tile's o/d component ranges, a superset) and then the exact
    any-lane slab on the candidates.  ``tmax_cap`` (per ray, the distance
    to the light) bounds the segment; ``sort_near`` orders a tile's boxes
    by their nearest entry.  The float64 work runs on ``device``."""
    f64 = torch.float64
    tiles_x = width // TILE_W
    n_tiles = tiles_x * (height // TILE_H)
    jj, ii = np.mgrid[0:height, 0:width]
    tile_id = ((jj // TILE_H) * tiles_x + (ii // TILE_W)).ravel()
    # each tile's rays in ascending ray order
    order = np.argsort(tile_id, kind="stable").reshape(n_tiles, -1)
    O = torch.from_numpy(o[order]).to(device, f64)
    D = torch.from_numpy(d[order]).to(device, f64)
    INV = torch.ones_like(D) / D
    CAP = (None if tmax_cap is None
           else torch.from_numpy(np.asarray(tmax_cap)[order]).to(device, f64))
    blo = torch.from_numpy(boxes.lo).to(device, f64)
    bhi = torch.from_numpy(boxes.hi).to(device, f64)
    inf = torch.tensor(float("inf"), dtype=f64, device=device)
    zero = torch.zeros((), dtype=f64, device=device)
    ids, lens = [], []
    for t in range(n_tiles):
        live = torch.isfinite(O[t]).all(dim=1)
        if not bool(live.any()):
            ids.append(np.zeros(0, np.int64))
            lens.append(0)
            continue
        osl, dsl = O[t][live], D[t][live]
        olo, ohi = osl.amin(0).tolist(), osl.amax(0).tolist()
        dlo, dhi = dsl.amin(0).tolist(), dsl.amax(0).tolist()
        cap = float("inf") if CAP is None else float(CAP[t][live].max())
        cand = _interval_slab(blo, bhi, olo, ohi, dlo, dhi, cap)
        ci = torch.nonzero(cand).flatten()
        if ci.numel() == 0:
            ids.append(np.zeros(0, np.int64))
            lens.append(0)
            continue
        invl = INV[t][live]
        t0 = (blo[ci][None] - osl[:, None]) * invl[:, None]
        t1 = (bhi[ci][None] - osl[:, None]) * invl[:, None]
        tmin = torch.maximum(torch.minimum(t0, t1).amax(dim=2), zero)
        tmax = torch.maximum(t0, t1).amin(dim=2)
        hi_ = inf if CAP is None else CAP[t][live][:, None]
        hit = (tmax >= tmin) & (tmax >= 1e-2) & (tmin <= hi_)
        take = torch.nonzero(hit.any(dim=0)).flatten()
        if sort_near:
            near = torch.where(hit[:, take], tmin[:, take], inf).amin(dim=0)
            take = take[torch.argsort(near, stable=True)]
        ids.append(ci[take].cpu().numpy())
        lens.append(int(take.numel()))
    lmax = max(1, max(lens))
    ids_a = np.zeros((n_tiles, lmax), np.int32)
    for t, x in enumerate(ids):
        ids_a[t, :len(x)] = x
    return TileLists(np.asarray(lens, np.int32), ids_a)


def hit_points(t_map: np.ndarray, m_map: np.ndarray, o: np.ndarray,
               d: np.ndarray) -> np.ndarray:
    """(R, 3) float64 closest-hit points of the primary rays, NaN where no
    triangle was hit."""
    hitm = (m_map == 4) & (t_map < 1e30)
    x = o + d * t_map.ravel()[:, None]
    x[~hitm.ravel()] = np.nan
    return x


def shadow_rays(x: np.ndarray, light) -> tuple[np.ndarray, np.ndarray]:
    """(sd, dist): unit directions and distances from the hit points ``x``
    to the light at (lx + 0.5, ly + 0.5, lz) (the 0.5 jitter), NaN where
    ``x`` is."""
    lx, ly, lz = (float(v) for v in light[:3])
    lp = np.array([lx + 0.5, ly + 0.5, lz], np.float64)
    seg = lp[None] - x
    dist = np.linalg.norm(seg, axis=1)
    with np.errstate(invalid="ignore"):
        sd = seg / dist[:, None]
    return sd, dist


def shadow_inputs(x: np.ndarray, sd: np.ndarray, dist: np.ndarray,
                  width: int, height: int):
    """The occlusion kernel's float32 (height, width, 3) origins and
    directions and (height, width) limits: NaN origins -> 1e9, NaN
    directions -> 1, NaN limits -> -1 (such a ray never tests occluded)."""
    o = np.nan_to_num(x, nan=1e9).astype(np.float32)
    d = np.nan_to_num(sd, nan=1.0).astype(np.float32)
    tl = np.nan_to_num(dist, nan=-1.0).astype(np.float32)
    return (o.reshape(height, width, 3), d.reshape(height, width, 3),
            tl.reshape(height, width))
