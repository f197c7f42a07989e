"""The exact uniform triangle grid that kernels B2/B3 and B4 walk past 512
triangles.

Kernels B2/B3 (``csrc/mega_blocked.cu``; the super family and the
trianglegrid variant's ``accel="auto"`` route on meshes of more than 512
triangles) and kernel B4's walk route (``csrc/mega_vlp.cu``, the
``kWalk`` instantiation; the bidirectional / metropolis /
metropolis_vlpgrid render pass there) walk each camera ray and each
light's shadow ray - B2/B3's uncapped any hit, or under
``shadow_carry_t`` a closest hit from the carried distance; B4's capped
any hit - through a uniform grid, one lane a ray, with a 3-D DDA
(``csrc/pt_device.cuh::exact_walk``).  Their films are held to the
brute-force plain versions, so this grid and its walk are exact where
the trianglegrid variant's DDA (``ops/grid.py``, kernels B11 / B11w)
keeps the reference's quirks:

* every (cell, triangle) pair whose AABB overlaps the cell is kept - no
  per-cell cap of 62;
* the resolution is the port's own (the image does not depend on it):
  the reference's heuristic (``ops/grid.py::grid_resolution``) at
  ``EXACT_MODIFIER`` cells a triangle, each axis clamped at ``MAX_RES``
  (the reference's 128 would cut the 1,048,576-triangle sheet's grid);
* the box is the mesh's padded by 1e-3 of its extent + 1e-4 on each
  side, so that the frame's far corner (vmin + cell size x res, in
  float32) covers every triangle;
* the walk ends when its running best distance lies before the current
  cell's exit (a margin of 1e-4 (|exit| + 1) keeps rounding from
  ending it early), not after the reference's break rule, and starts at
  the line's entry under ``accept_negative_t``, whose hits may lie behind
  the origin.

:func:`exact_grid` builds the tables once per prepared scene and device
(``intersect.derived``) with torch ops on the device: the triangles'
cell ranges enumerated pair by pair, a stable sort by cell (a cell's
triangles keep ascending index), the cell-major rows of
``_tri_table`` with each row's original index beside it, each cell's
(first row, rows) and the occupancy bitmap
(``ops/grid.py::occupancy_bits``).  The binning is
``build_grid_host``'s: floor((aabb - vmin) / cell size), clipped.

:func:`walk_twin` is the kernel's walk in NumPy float32, the same
operations in the same order, every ray in lockstep: the CPU tests hold it
to the JAX package's brute-force closest hit and any hit, and its tally
(cells, empty cells, pairs a walk) sizes the grid.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .grid import grid_resolution, occupancy_bits
from .intersect import SceneArrays, _tri_table, derived

#: Cells a triangle in the resolution heuristic, and each axis's clamp.
EXACT_MODIFIER = 3.0
MAX_RES = 512
#: The walk's termination margin: it ends when best t <= exit - margin,
#: margin = TERM_REL * (|exit| + 1) (csrc/pt_device.cuh, kTermRel).
TERM_REL = np.float32(1e-4)

_F = np.float32


class ExactGrid(NamedTuple):
    """An exact triangle grid and the tables the kernels' walk reads, on
    one device."""
    res: tuple            # (rx, ry, rz) Python ints
    frame: torch.Tensor   # (9,) float32: vmin, vmax = vmin + cell * res, cell
    occ: torch.Tensor     # (ceil(ncells / 32),) int32 occupancy bitmap
    span: torch.Tensor    # (ncells, 2) int32: each cell's (first row, rows)
    rows: torch.Tensor    # (pairs, 12) float32: cell-major triangle rows
    ids: torch.Tensor     # (pairs,) int32: each row's original index


def exact_frame(amin: np.ndarray, amax: np.ndarray,
                modifier: float = EXACT_MODIFIER,
                max_res: int = MAX_RES) -> tuple:
    """(vmin, cell size, res) of the grid over triangle boxes
    [amin, amax] (float32 numpy): the padded box and its cells."""
    lo, hi = amin.min(axis=0), amax.max(axis=0)
    pad = (_F(1e-3) * (hi - lo) + _F(1e-4)).astype(_F)
    lo, hi = (lo - pad).astype(_F), (hi + pad).astype(_F)
    res = grid_resolution(lo, hi, amin.shape[0], modifier, max_res)
    cell = ((hi - lo) / np.asarray(res, _F)).astype(_F)
    return lo, cell, res


def triangle_boxes(tri: torch.Tensor) -> tuple:
    """Each triangle's AABB (min, max of v0, v0 + e0, v0 + e2 in float32)
    from the (N, 12) table ``tri``."""
    v0 = tri[:, 0:3]
    v1, v2 = v0 + tri[:, 3:6], v0 + tri[:, 6:9]
    return (torch.minimum(torch.minimum(v0, v1), v2),
            torch.maximum(torch.maximum(v0, v1), v2))


def cell_pairs(amin, amax, vmin, cell, res) -> tuple:
    """Every (cell, triangle) pair of the binning, sorted by cell and then
    by triangle: (cell ids, triangle ids) as int64 tensors on ``amin``'s
    device.  A triangle covers the cells floor((aabb - vmin) / cell),
    clipped into the grid (``build_grid_host``'s binning)."""
    dev = amin.device
    rx, ry, rz = res
    hi_c = torch.tensor([rx - 1, ry - 1, rz - 1], dtype=torch.float32,
                        device=dev)
    vmin = torch.as_tensor(vmin, dtype=torch.float32, device=dev)
    cell = torch.as_tensor(cell, dtype=torch.float32, device=dev)

    def coords(p):
        c = torch.floor((p - vmin) / cell)
        return torch.minimum(torch.clamp_min(c, 0.0), hi_c).to(torch.int64)
    c0, c1 = coords(amin), coords(amax)
    span = c1 - c0 + 1
    per = span.prod(dim=1)
    n = int(amin.shape[0])
    tri = torch.repeat_interleave(torch.arange(n, device=dev), per)
    first = torch.cumsum(per, 0) - per
    k = torch.arange(tri.shape[0], device=dev) - first[tri]
    sx, sy = span[tri, 0], span[tri, 1]
    x = c0[tri, 0] + k % sx
    y = c0[tri, 1] + (k // sx) % sy
    z = c0[tri, 2] + k // (sx * sy)
    cid = (z * ry + y) * rx + x
    # pairs are enumerated triangle-major: a stable sort keeps each cell's
    # triangles in ascending index
    order = torch.argsort(cid, stable=True)
    return cid[order], tri[order]


def build_exact_grid(scn: SceneArrays, device,
                     modifier: float = EXACT_MODIFIER,
                     max_res: int = MAX_RES) -> ExactGrid:
    """The exact grid of ``scn``'s triangles on ``device`` (uncached)."""
    device = torch.device(device)
    tri = torch.from_numpy(_tri_table(scn)).to(device)
    amin, amax = triangle_boxes(tri)
    vmin, cell, res = exact_frame(amin.cpu().numpy(), amax.cpu().numpy(),
                                  modifier, max_res)
    cid, ids = cell_pairs(amin, amax, vmin, cell, res)
    if ids.shape[0] >= 1 << 31:
        raise ValueError(f"{ids.shape[0]} grid pairs exceed the int32 row "
                         "index")
    ncells = res[0] * res[1] * res[2]
    counts = torch.bincount(cid, minlength=ncells)
    span = torch.stack([torch.cumsum(counts, 0) - counts, counts], dim=1)
    vmin_t = torch.from_numpy(vmin).to(device)
    cell_t = torch.from_numpy(cell).to(device)
    vmax_t = vmin_t + cell_t * torch.tensor(res, dtype=torch.float32,
                                            device=device)
    return ExactGrid(res=res,
                     frame=torch.cat([vmin_t, vmax_t, cell_t]).contiguous(),
                     occ=occupancy_bits(counts),
                     span=span.to(torch.int32).contiguous(),
                     rows=tri[ids].contiguous(),
                     ids=ids.to(torch.int32).contiguous())


def exact_grid(scn: SceneArrays, device) -> ExactGrid:
    """:func:`build_exact_grid`, built once per prepared scene and
    device."""
    device = torch.device(device)
    return derived(scn, "exact_grid.exact_grid", device,
                   lambda s: build_exact_grid(s, device))


def check_tables(g: ExactGrid, device) -> None:
    """Raise ``ValueError`` unless every table is a contiguous tensor on
    ``device`` of the dtype and size the walk reads (the launchers pass
    their pointers unchecked)."""
    ncells = g.res[0] * g.res[1] * g.res[2]
    npairs = int(g.rows.shape[0])
    for name, a, dtype, n in (("frame", g.frame, torch.float32, 9),
                              ("rows", g.rows, torch.float32, 12 * npairs),
                              ("span", g.span, torch.int32, 2 * ncells),
                              ("occ", g.occ, torch.int32, (ncells + 31) // 32),
                              ("ids", g.ids, torch.int32, npairs)):
        if a.device != device or a.dtype != dtype \
                or not a.is_contiguous() or a.numel() != n:
            raise ValueError(f"grid {name} must be a contiguous {dtype} "
                             f"tensor of {n} on {device}")


def table_bytes(g: ExactGrid) -> int:
    """Bytes of the tables the kernel reads."""
    return sum(int(x.numel()) * x.element_size()
               for x in (g.frame, g.occ, g.span, g.rows, g.ids))


# ---------------------------------------------------------------------------
# the walk's NumPy twin


def _quads(r, o, d):
    """pt_device.cuh::row_quads on rows ``r`` (n, 12) and rays (n, 3):
    (dd, un_s, vn_s, tn_s), float32."""
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    pvx = dy * r[:, 8] - dz * r[:, 7]
    pvy = dz * r[:, 6] - dx * r[:, 8]
    pvz = dx * r[:, 7] - dy * r[:, 6]
    det = r[:, 3] * pvx + r[:, 4] * pvy + r[:, 5] * pvz
    tvx, tvy, tvz = o[:, 0] - r[:, 0], o[:, 1] - r[:, 1], o[:, 2] - r[:, 2]
    un = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * r[:, 5] - tvz * r[:, 4]
    qvy = tvz * r[:, 3] - tvx * r[:, 5]
    qvz = tvx * r[:, 4] - tvy * r[:, 3]
    vn = dx * qvx + dy * qvy + dz * qvz
    tn = r[:, 6] * qvx + r[:, 7] * qvy + r[:, 8] * qvz
    sg = np.where(det >= 0, _F(1), _F(-1))
    return det * sg, un * sg, vn * sg, tn * sg


def _valid(dd, un, vn, tn, neg_t):
    ok = ((dd >= _F(0.01)) & (un >= 0) & (un <= dd) & (vn >= 0)
          & (un + vn <= dd))
    return ok if neg_t else ok & (tn > _F(0.01) * dd)


class WalkTables(NamedTuple):
    """An :class:`ExactGrid`'s tables as NumPy arrays, for the twin."""
    res: tuple
    frame: np.ndarray
    span: np.ndarray
    rows: np.ndarray
    ids: np.ndarray


def walk_tables(g: ExactGrid) -> WalkTables:
    return WalkTables(g.res, g.frame.cpu().numpy(), g.span.cpu().numpy(),
                      g.rows.cpu().numpy(), g.ids.cpu().numpy())


def walk_start(o, d, tab: WalkTables, neg_t: bool) -> tuple:
    """pt_device.cuh::exact_start for every ray: whether it enters the
    grid, and the walk state (cell index (n, 3) int64, next crossings
    (n, 3), +inf on an axis with no slab, crossing steps (n, 3), direction
    signs (n, 3) bool)."""
    vmin, vmax, cs = tab.frame[0:3], tab.frame[3:6], tab.frame[6:9]
    res = np.asarray(tab.res, np.int64)
    with np.errstate(all="ignore"):
        inv = _F(1) / d
        a, b = (vmin - o) * inv, (vmax - o) * inv
        nan = np.isnan(a) | np.isnan(b)
        e0 = np.where(nan, _F(-np.inf), np.fmin(a, b))
        e1 = np.where(nan, _F(np.inf), np.fmax(a, b))
        t0 = np.maximum(np.maximum(e0[:, 0], e0[:, 1]), e0[:, 2])
        t1 = np.minimum(np.minimum(e1[:, 0], e1[:, 1]), e1[:, 2])
        enter = t0 <= t1
        if not neg_t:
            enter &= t1 >= 0
        inside = ((o >= vmin) & (o <= vmax)).all(axis=1)
        from_o = inside if not neg_t else np.zeros(len(o), bool)
        p = np.where(from_o[:, None], o, o + d * t0[:, None])
        c = np.floor((p - vmin) / cs)
        c = np.where(np.isfinite(c), c, 0)
        idx = np.clip(c, 0, res - 1).astype(np.int64)
        dl = (e1 - e0) / res.astype(_F)
        pos = d > 0
        nxt = np.where(pos, e0 + (idx + 1).astype(_F) * dl,
                       e0 + res.astype(_F) * dl - idx.astype(_F) * dl)
    # an axis with no slab never steps
    nxt = np.where(np.isnan(nxt), _F(np.inf), nxt)
    return enter, idx, nxt.astype(_F), dl.astype(_F), pos


def walk_twin(o, d, tab: WalkTables, neg_t: bool, t_limit=None, bn0=None):
    """The kernel's exact walk for every ray (o, d float32 (n, 3)):
    the closest hit from a running distance ``bn0`` (default 1e9; result
    ``(bn, bd, bi)``: t = bn / bd, bi the original index or -1) or, with
    ``t_limit``, the any hit below it (result: the occlusion booleans),
    and the per-ray tally ``{"cells", "empty", "pairs"}``.

    The rays walk in lockstep: each step every walking ray tests its
    cell's pairs in slot order, then ends or steps, as the kernel's lane
    does; a closest-hit update is the kernel's (num < den, or equal with a
    lower index), an any hit ends the walk at its first pair."""
    o, d = np.asarray(o, _F), np.asarray(d, _F)
    n = len(o)
    res = np.asarray(tab.res, np.int64)
    rx, ry, rz = (int(r) for r in res)
    ncells = rx * ry * rz
    any_hit = t_limit is not None
    tl = (np.broadcast_to(np.asarray(t_limit, _F), (n,)).copy()
          if any_hit else None)
    bn = (np.full(n, _F(1e9)) if bn0 is None
          else np.broadcast_to(np.asarray(bn0, _F), (n,)).copy())
    bd = np.ones(n, _F)
    bi = np.full(n, -1, np.int64)
    occ = np.zeros(n, bool)
    tally = {k: np.zeros(n, np.int64) for k in ("cells", "empty", "pairs")}
    go, idx, nxt, dl, pos = walk_start(o, d, tab, neg_t)
    step = np.where(pos, 1, -1)
    stop = np.where(pos, res, -1)
    counts = tab.span[:, 1].astype(np.int64)
    first = tab.span[:, 0].astype(np.int64)
    while go.any():
        w = np.nonzero(go)[0]
        c = np.clip((idx[w, 2] * ry + idx[w, 1]) * rx + idx[w, 0], 0,
                    ncells - 1)
        cnt = counts[c]
        tally["cells"][w] += 1
        tally["empty"][w] += cnt == 0
        # the pairs of every walking ray's cell, ray-major, slot order
        pr = np.repeat(w, cnt)
        slot = np.arange(pr.shape[0]) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        row = np.repeat(first[c], cnt) + slot
        dd, un, vn, tn = _quads(tab.rows[row], o[pr], d[pr])
        ok = _valid(dd, un, vn, tn, neg_t)
        if any_hit:
            hit = ok & (tn < tl[pr] * dd)
            # pairs tested: up to the first hit of the cell
            tested = cnt.copy()
            hp = np.nonzero(hit)[0]
            if hp.size:
                fr, at = np.unique(pr[hp], return_index=True)
                pos_w = np.searchsorted(w, fr)
                tested[pos_w] = slot[hp[at]] + 1
                occ[fr] = True
            tally["pairs"][w] += tested
        else:
            tally["pairs"][w] += cnt
            for j in np.nonzero(ok)[0]:   # candidates, in slot order
                r = pr[j]
                num, den = tn[j] * bd[r], bn[r] * dd[j]
                i = int(tab.ids[row[j]])
                if num < den or (num == den and i < bi[r]):
                    bn[r], bd[r], bi[r] = tn[j], dd[j], i
        # end, or step along the axis of the smallest next crossing
        nw = nxt[w]
        ex = np.fmin(np.fmin(nw[:, 0], nw[:, 1]), nw[:, 2])
        thr = ex - TERM_REL * (np.abs(ex) + _F(1))
        if any_hit:
            done = occ[w] | (thr >= tl[w])
        else:
            done = bn[w] <= thr * bd[w]
        selx = (nw[:, 0] <= nw[:, 1]) & (nw[:, 0] <= nw[:, 2])
        sely = ~selx & (nw[:, 1] <= nw[:, 2])
        ax = np.where(selx, 0, np.where(sely, 1, 2))
        moved = idx[w, ax] + step[w, ax]
        out = moved == stop[w, ax]
        idx[w, ax] = moved
        nxt[w, ax] = nxt[w, ax] + dl[w, ax]
        go[w] = ~done & ~out
    if any_hit:
        return occ, tally
    return (bn, bd, bi), tally
