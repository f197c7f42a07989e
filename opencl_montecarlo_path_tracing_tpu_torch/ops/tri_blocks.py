"""Host-side block tables of the large-mesh super kernel (numpy).

``_tri_blocks`` is the JAX package's ``ops/pallas_super.py::_tri_blocks``,
bit for bit: triangles sorted along a 30-bit Morton curve of their
centroids into 128-triangle blocks, each block's AABB padded by 0.1% of
its extent + 1e-4 (so float slab tests stay conservative), padding blocks
as NaN boxes, macros of 8 Morton-consecutive blocks ordered near to far
from the fixed camera, and each row's original triangle index (row 12,
float32, exact below 2^24) for the scan's tie-break.  ``global_box`` is the
padded box around every live block (the JAX kernel's ``gbox``).

``walk_tables`` turns these into what ``csrc/mega_blocked.cu`` walks.
The blocks it scans: only the live blocks, in the tables' near-to-far
order, as

* ``rows`` (n_live * 128, 16) float32: v0, e0, e2, unit normal, the
  original index as int32 bits, 3 pad - rows past the mesh are zero
  (det = 0 never hits);
* ``boxes`` (n_live, 8) float32: lo.xyz, 0, hi.xyz, 0;

and the two levels the kernel walks around them (port-only; the JAX
kernel has neither):

* ``subs`` (n_live * 4, 8) float32: each block's four 32-row sub-blocks,
  lo.xyz, real row count (int32 bits), hi.xyz, 0 - the box of the
  sub-block's triangles padded by its block's pad (never tighter than
  the block's own), so it lies inside the block's box;
* ``nodes`` (n_nodes, 8) float32: a tree over the macros in depth-first
  order.  A leaf is a macro (``_kernel_tables``: the union box of a
  macro's live blocks, macros without a live block dropped): lo.xyz, live
  block count, hi.xyz, first live block (int32 bits).  An internal node
  groups up to 8 Morton-consecutive children
  (macros, then groups of groups) under their union box: lo.xyz, the index
  of the node after its subtree, hi.xyz, -1 (int32 bits).  Siblings are
  ordered near to far from the camera, and levels are added until at most
  8 nodes are left at the top.

NaN boxes never reach the kernel: it walks live blocks only, so CUDA's
NaN-dropping ``fminf``/``fmaxf`` never meet one.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import make_camera
from .intersect import SceneArrays, _tri_table

_TRI_BLOCK = 128           # triangles per Morton block
_MACRO = 8                 # blocks per macro group
_SUB = 32                  # rows per sub-block (walk_tables)
_FAN = 8                   # children per tree node (walk_tables)


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
    return _tri_blocks_ordered(scn)[:3]


def _camera_distance(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Distance from the fixed camera to each box (lo, hi), 0 inside; inf
    for an inverted box."""
    campos = np.asarray(make_camera(z_sign=-1.0).pos, np.float32)
    d = np.linalg.norm(np.clip(campos, lo, np.maximum(hi, lo)) - campos,
                       axis=-1)
    d[lo[:, 0] > hi[:, 0]] = np.inf
    return d


def _tri_blocks_ordered(scn: SceneArrays):
    """:func:`_tri_blocks` and the macros' Morton order: ``morder[i]`` is
    the Morton-order index of the macro at near-to-far position i."""
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
    cdist = _camera_distance(aabbs_m[:, :3], aabbs_m[:, 3:])
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
    return tblT, aabbs, aabbs_m, morder


def global_box(aabbs: np.ndarray) -> tuple:
    """The padded box around every live block AABB (the JAX kernel's
    ``gbox``, film_super_mega): (lo.xyz, hi.xyz) as Python floats."""
    live = aabbs[:, 0] <= aabbs[:, 3]
    glo = aabbs[live, :3].min(axis=0)
    ghi = aabbs[live, 3:].max(axis=0)
    gpad = 0.01 * float((ghi - glo).max()) + 0.01
    return tuple(float(v) for v in np.concatenate([glo - gpad, ghi + gpad]))


def _kernel_tables(blocked):
    """(rows, boxes, macros, macro_morton): the live blocks' tables (module
    docstring) and each kept macro's Morton-order index, from
    :func:`_tri_blocks_ordered`."""
    tblT, aabbs, _, morder = blocked
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
    macros, morton = [], []
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
        morton.append(int(morder[m]))
    macros = np.stack(macros) if macros else np.zeros((0, 8), np.float32)
    return rows, boxes, macros, np.asarray(morton, np.int64)


def _i32(v) -> np.ndarray:
    """int32 values as the float32 bit patterns the kernel reads back."""
    return np.asarray(v, np.int32).view(np.float32)


def sub_boxes(rows: np.ndarray) -> np.ndarray:
    """(n_live * 4, 8) sub-block records of the live blocks in ``rows``
    (module docstring): the triangles' bounds as ``_tri_blocks`` computes
    them (v0, v0 + e0, v0 + e2 in float32), padded by the block's own pad
    ``1e-3 * extent + 1e-4`` of its triangles' bounds."""
    n_live = rows.shape[0] // _TRI_BLOCK
    r = rows.reshape(n_live, _TRI_BLOCK, 16)
    real = r[:, :, 12].view(np.int32) >= 0
    v0 = r[:, :, 0:3]
    v1 = v0 + r[:, :, 3:6]
    v2 = v0 + r[:, :, 6:9]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    if not real.all():                         # the last block's tail
        lo[~real] = np.inf
        hi[~real] = -np.inf
    k = _TRI_BLOCK // _SUB
    slo = lo.reshape(n_live, k, _SUB, 3).min(axis=2)
    shi = hi.reshape(n_live, k, _SUB, 3).max(axis=2)
    pad = 1e-3 * (shi.max(axis=1) - slo.min(axis=1)) + 1e-4   # the block's
    slo = slo - pad[:, None]
    shi = shi + pad[:, None]
    count = real.reshape(n_live, k, _SUB).sum(axis=2)
    empty = count == 0
    slo[empty] = 0.0
    shi[empty] = 0.0
    subs = np.zeros((n_live, k, 8), np.float32)
    subs[..., 0:3] = slo
    subs[..., 3] = _i32(count)
    subs[..., 4:7] = shi
    return subs.reshape(-1, 8)


def node_tree(macros: np.ndarray, morton: np.ndarray) -> np.ndarray:
    """(n_nodes, 8) depth-first tree over ``macros`` (module docstring):
    macros grouped by Morton index // 8, groups by // 64, ... until at
    most 8 nodes are left; siblings ordered near to far."""
    # a node: (lo (3,), hi (3,), its children as a list of nodes, or the
    # macro index of a leaf)
    items = [(macros[m, 0:3], macros[m, 4:7], m) for m in
             range(macros.shape[0])]
    keys = np.asarray(morton, np.int64)
    while len(items) > _FAN:
        keys = keys // _FAN
        groups = {}
        for item, key in zip(items, keys):
            groups.setdefault(int(key), []).append(item)
        items, new_keys = [], []
        for key in sorted(groups):
            ch = _near_to_far(groups[key])
            lo = np.min([c[0] for c in ch], axis=0)
            hi = np.max([c[1] for c in ch], axis=0)
            items.append((lo, hi, ch))
            new_keys.append(key)
        keys = np.asarray(new_keys, np.int64)
    out = []

    def emit(node):
        lo, hi, ch = node
        rec = np.zeros(8, np.float32)
        rec[0:3], rec[4:7] = lo, hi
        out.append(rec)
        if not isinstance(ch, list):           # a macro leaf
            rec[3] = macros[ch, 7]             # live block count
            rec[7] = macros[ch, 3]             # first live block
            return
        for c in ch:
            emit(c)
        rec[3] = _i32(len(out))                # the node after the subtree
        rec[7] = _i32(-1)

    for node in _near_to_far(items):
        emit(node)
    return np.stack(out) if out else np.zeros((0, 8), np.float32)


def _near_to_far(items: list) -> list:
    """``items`` ordered by their box's distance from the camera (stable)."""
    lo = np.stack([i[0] for i in items])
    hi = np.stack([i[1] for i in items])
    order = np.argsort(_camera_distance(lo, hi), kind="stable")
    return [items[i] for i in order]


def walk_tables(scn: SceneArrays):
    """(rows, boxes, subs, nodes): what ``csrc/mega_blocked.cu`` walks
    (module docstring)."""
    rows, boxes, macros, morton = _kernel_tables(_tri_blocks_ordered(scn))
    return rows, boxes, sub_boxes(rows), node_tree(macros, morton)
