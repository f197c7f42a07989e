"""Host-side block tables of the large-mesh super kernel (numpy).

``_tri_blocks`` is the JAX package's ``ops/pallas_super.py::_tri_blocks``,
bit for bit: triangles sorted along a 30-bit Morton curve of their
centroids into 128-triangle blocks, each block's AABB padded by 0.1% of
its extent + 1e-4 (so float slab tests stay conservative), padding blocks
as NaN boxes, macros of 8 Morton-consecutive blocks ordered near to far
from the fixed camera, and each row's original triangle index (row 12,
float32, exact below 2^24) for the scan's tie-break.  ``global_box`` is the
padded box around every live block (the JAX kernel's ``gbox``).

``kernel_tables`` turns these into what ``csrc/mega_blocked.cu`` walks:
only the live blocks, in the tables' near-to-far order, as

* ``rows`` (n_live * 128, 16) float32: v0, e0, e2, unit normal, the
  original index as int32 bits, 3 pad - rows past the mesh are zero
  (det = 0 never hits);
* ``boxes`` (n_live, 8) float32: lo.xyz, 0, hi.xyz, 0;
* ``macros`` (n_macros, 8) float32: lo.xyz, first live block (int32 bits),
  hi.xyz, live block count (int32 bits) - the union of the macro's live
  blocks, macros without a live block dropped.

NaN boxes never reach the kernel: it walks live blocks only, so CUDA's
NaN-dropping ``fminf``/``fmaxf`` never meet one.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import make_camera
from .intersect import SceneArrays, _tri_table

_TRI_BLOCK = 128           # triangles per Morton block
_MACRO = 8                 # blocks per macro group


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of x two apart (Morton interleave helper)."""
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
    return x


def _tri_blocks(scn: SceneArrays):
    """(tblT (16, ntp), aabbs (n_blocks, 6), aabbs_m (n_macros, 6)): the
    transposed, Morton-blocked triangle table with the original index in
    row 12 (2^24 on padding rows), the padded block AABBs (lo, hi) in
    near-to-far macro order (NaN for padding blocks) and the macro AABBs
    in the same order (an inverted +-3e38 box for a macro of padding
    blocks only)."""
    tbl = _tri_table(scn)
    nt = tbl.shape[0]
    v0 = tbl[:, 0:3]
    v1 = v0 + tbl[:, 3:6]
    v2 = v0 + tbl[:, 6:9]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    c = 0.5 * (lo + hi)
    smin = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - smin, 1e-30)
    q = np.clip((c - smin) / ext * 1023.0, 0.0, 1023.0).astype(np.uint64)
    code = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << np.uint64(1))
            | (_part1by2(q[:, 2]) << np.uint64(2)))
    order = np.argsort(code, kind="stable")
    tbl, lo, hi = tbl[order], lo[order], hi[order]

    # block count padded to whole macros (padding blocks: NaN boxes)
    n_blocks = -(-nt // _TRI_BLOCK)
    n_blocks = -(-n_blocks // _MACRO) * _MACRO
    ntp = n_blocks * _TRI_BLOCK
    big = np.float32(3e38)
    aabbs = np.empty((n_blocks, 6), np.float32)
    for b in range(n_blocks):
        s, e = b * _TRI_BLOCK, min((b + 1) * _TRI_BLOCK, nt)
        if s >= nt:
            aabbs[b, :] = np.nan
        else:
            blo = lo[s:e].min(axis=0)
            bhi = hi[s:e].max(axis=0)
            pad = 1e-3 * (bhi - blo) + 1e-4
            aabbs[b, :3] = blo - pad
            aabbs[b, 3:] = bhi + pad

    # macros of _MACRO Morton-consecutive blocks, ordered near to far from
    # the camera (empty macros last)
    n_macros = n_blocks // _MACRO
    aabbs_m = np.empty((n_macros, 6), np.float32)
    for m in range(n_macros):
        grp = aabbs[m * _MACRO:(m + 1) * _MACRO]
        nonempty = grp[:, 0] <= grp[:, 3]
        if not nonempty.any():
            aabbs_m[m, :3], aabbs_m[m, 3:] = big, -big
        else:
            aabbs_m[m, :3] = grp[nonempty, :3].min(axis=0)
            aabbs_m[m, 3:] = grp[nonempty, 3:].max(axis=0)
    campos = np.asarray(make_camera(z_sign=-1.0).pos, np.float32)
    cdist = np.linalg.norm(
        np.clip(campos, aabbs_m[:, :3],
                np.maximum(aabbs_m[:, 3:], aabbs_m[:, :3])) - campos,
        axis=-1)
    cdist[aabbs_m[:, 0] > aabbs_m[:, 3]] = np.inf
    morder = np.argsort(cdist, kind="stable")
    aabbs_m = aabbs_m[morder]
    border = (morder[:, None] * _MACRO
              + np.arange(_MACRO)[None, :]).ravel()
    aabbs = aabbs[border]

    tblT = np.zeros((16, ntp), np.float32)
    tblT[12, :] = np.float32(2 ** 24)
    for newb, oldb in enumerate(border):
        s = oldb * _TRI_BLOCK
        e = min(s + _TRI_BLOCK, nt)
        if s >= nt:
            continue
        ds_ = newb * _TRI_BLOCK
        tblT[:12, ds_:ds_ + (e - s)] = tbl[s:e].T
        tblT[12, ds_:ds_ + (e - s)] = order[s:e].astype(np.float32)
    return tblT, aabbs, aabbs_m


def global_box(aabbs: np.ndarray) -> tuple:
    """The padded box around every live block AABB (the JAX kernel's
    ``gbox``, film_super_mega): (lo.xyz, hi.xyz) as Python floats."""
    live = aabbs[:, 0] <= aabbs[:, 3]
    glo = aabbs[live, :3].min(axis=0)
    ghi = aabbs[live, 3:].max(axis=0)
    gpad = 0.01 * float((ghi - glo).max()) + 0.01
    return tuple(float(v) for v in np.concatenate([glo - gpad, ghi + gpad]))


def kernel_tables(scn: SceneArrays):
    """(rows, boxes, macros) for ``csrc/mega_blocked.cu`` (module
    docstring), from :func:`_tri_blocks`."""
    tblT, aabbs, _ = _tri_blocks(scn)
    n_blocks = aabbs.shape[0]
    live = aabbs[:, 0] <= aabbs[:, 3]          # NaN boxes fail
    live_ids = np.flatnonzero(live)
    rows = np.zeros((n_blocks, _TRI_BLOCK, 16), np.float32)
    rows[:, :, :12] = tblT[:12].T.reshape(n_blocks, _TRI_BLOCK, 12)
    idx = tblT[12].astype(np.int64)
    idx[idx >= 2 ** 24] = -1                   # padding rows (det = 0)
    rows[:, :, 12] = idx.astype(np.int32).view(np.float32).reshape(
        n_blocks, _TRI_BLOCK)
    rows = np.ascontiguousarray(rows[live_ids]).reshape(-1, 16)
    boxes = np.zeros((live_ids.size, 8), np.float32)
    boxes[:, 0:3] = aabbs[live_ids, :3]
    boxes[:, 4:7] = aabbs[live_ids, 3:]
    macros = []
    pos = np.cumsum(live) - 1                  # block -> live position
    for m in range(n_blocks // _MACRO):
        ids = np.arange(m * _MACRO, (m + 1) * _MACRO)
        ids = ids[live[ids]]
        if not ids.size:
            continue
        rec = np.zeros(8, np.float32)
        rec[0:3] = aabbs[ids, :3].min(axis=0)
        rec[4:7] = aabbs[ids, 3:].max(axis=0)
        rec[3:4] = np.array([pos[ids[0]]], np.int32).view(np.float32)
        rec[7:8] = np.array([ids.size], np.int32).view(np.float32)
        macros.append(rec)
    macros = np.stack(macros) if macros else np.zeros((0, 8), np.float32)
    return rows, boxes, macros
