"""The per-tile box-list walk of the grid diagnostic (kernels B8-dda-closest
and B8-dda-occ): wrappers and plain versions.

``closest(lists, table, width, height)`` returns, for the pinhole primary
rays of a width x height image (the thin-lens camera with all four
uniforms at 0.5), the (height, width) float32 distance ``t`` of the
closest triangle among the rows of the boxes listed for the ray's 64x32
tile (3e38 where none is hit) and the int32 material ``m`` (4 on a hit,
else 0).  ``occluded(lists, table, o, d, tl)`` returns the (height,
width) int32 0/1 map of the rays (o, d) blocked by a listed triangle
before ``tl``.  The row tests are the division-free Moller-Trumbore of
``ops/intersect.py::_mt_quads`` with the running minimum carried
det-scaled as (bn, bd) and a strict <, in list order, then row order; an
exact tie of the cross-multiplied comparison goes to the lowest triangle
index (row column 12), so the map does not depend on the order in which
the lists give the rows (the JAX kernel keeps the first tested).

On a CUDA tensor they launch the hand-written kernels of
``csrc/diag_dda.cu``, which replace the TPU kernels of the JAX package's
``tools/diag_dda_pallas.py``: ``make_pallas_fn`` -> ``_dda_kernel``
(``pl.pallas_call`` at :163) and ``make_occ_fn`` -> ``_occ_kernel`` (:198).
``closest_plain`` and ``occluded_plain`` are the same functions in plain
PyTorch, on any device; the wrappers take them only when the tensors lie
on the CPU.  Both sides round every multiply and add on its own (the
kernels build with --fmad=false), so the kernel's maps equal the plain
ones bit for bit.  Each call is one launch.  Its blocks take the tiles
in the order ``Lists.order`` gives, which :func:`ranked` sets once per set
of lists to the tiles by descending listed rows, so that the longest
tiles start first; without it they take them in index order.  The order
moves only the time, never a map.  ``closest_stats`` / ``occluded_stats``
launch the counting instantiation (:data:`STAT_NAMES`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import make_camera, primary_rays
from .intersect import _EPS, _mt_quads, _mt_valid

#: Launches of each CUDA kernel since the last reset (the wrappers add one
#: per launch and nowhere else).
CLOSEST_LAUNCHES = 0
OCC_LAUNCHES = 0

TILE_W, TILE_H = 64, 32          # the TPU kernels' pixel tile (_TW, _TH)
MISS_T = float(np.float32(3e38))
_CHUNK = 16        # rows tested together by the plain versions


class Table(NamedTuple):
    """Boxes of contiguous triangle rows, on one device."""
    rows: torch.Tensor    # (n_rows, 16) float32: v0, e0, e2, n, index, 3 0
    start: torch.Tensor   # (n_boxes,) int32 first row of each box
    count: torch.Tensor   # (n_boxes,) int32 rows of each box


class Lists(NamedTuple):
    """Each tile's list of box ids, on one device, and the order in which
    the kernels take the tiles (None: index order; see :func:`ranked`)."""
    llen: torch.Tensor    # (n_tiles,) int32
    ids: torch.Tensor     # (n_tiles, lmax) int32
    order: torch.Tensor | None = None   # (n_tiles,) int32 permutation


def table_on(boxes, device) -> Table:
    """A host ``tools.diag_host.Boxes`` as a :class:`Table` on ``device``."""
    return Table(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in (boxes.rows, boxes.start, boxes.count)))


def lists_on(lists, device) -> Lists:
    """A host ``tools.diag_host.TileLists`` as :class:`Lists`."""
    return Lists(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in (lists.llen, lists.ids)))


def ranked(lists: Lists, table: Table) -> Lists:
    """``lists`` with ``order`` the tiles by descending listed rows, ties
    by index (plain PyTorch, on the lists' device; made once per set of
    lists, as the lists themselves are)."""
    order = torch.sort(tile_rows(lists, table), descending=True,
                       stable=True).indices
    return lists._replace(order=order.to(torch.int32).contiguous())


def tile_pixels(width: int, height: int, device):
    """(px, py), each (n_tiles, 2048) int64: the pixels of each tile in the
    kernels' order (tile-major, 64 pixels a row inside the tile)."""
    tiles_x = width // TILE_W
    n_tiles = tiles_x * (height // TILE_H)
    tile = torch.arange(n_tiles, device=device)[:, None]
    idx = torch.arange(TILE_W * TILE_H, device=device)[None, :]
    px = (tile % tiles_x) * TILE_W + idx % TILE_W
    py = (tile // tiles_x) * TILE_H + idx // TILE_W
    return px, py


def pinhole_rays(width: int, height: int, device):
    """The closest kernel's rays: origins and directions (n_tiles, 2048, 3)
    float32 in :func:`tile_pixels` order."""
    px, py = tile_pixels(width, height, device)
    ii = px.to(torch.float32)
    half = torch.full_like(ii, 0.5)
    return primary_rays(make_camera(z_sign=-1.0), ii,
                        py.to(torch.float32), half, half, half, half)


_CAM = None   # the closest kernel's camera, 12 host floats


def _camera():
    """The 12-float camera the closest kernel takes by value (up, right,
    eye_offset, pos), as a ctypes array."""
    global _CAM
    if _CAM is None:
        cam = make_camera(z_sign=-1.0)
        v = np.concatenate([cam.up, cam.right, cam.eye_offset, cam.pos])
        _CAM = (ctypes.c_float * 12)(*v.astype(np.float32).tolist())
    return _CAM


def _check(width: int, height: int, lists: Lists, table: Table, dev):
    if width <= 0 or height <= 0 or width % TILE_W or height % TILE_H:
        raise ValueError(f"{width}x{height} is not a whole number of "
                         f"{TILE_W}x{TILE_H} tiles")
    n_tiles = (width // TILE_W) * (height // TILE_H)
    if tuple(lists.llen.shape) != (n_tiles,) or lists.ids.dim() != 2 \
            or lists.ids.shape[0] != n_tiles:
        raise ValueError(f"lists do not cover {n_tiles} tiles")
    if lists.order is not None and tuple(lists.order.shape) != (n_tiles,):
        raise ValueError(f"the order must hold {n_tiles} tiles")
    if table.rows.dim() != 2 or table.rows.shape[1] != 16:
        raise ValueError("the row table must be (n_rows, 16)")
    if table.start.shape != table.count.shape:
        raise ValueError("start and count must have one entry a box")
    for name, a, dt in (("llen", lists.llen, torch.int32),
                        ("ids", lists.ids, torch.int32),
                        ("rows", table.rows, torch.float32),
                        ("start", table.start, torch.int32),
                        ("count", table.count, torch.int32),
                        ("order", lists.order, torch.int32)):
        if a is None:
            continue
        if a.dtype != dt or a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}")


def _row_sequence(lists: Lists, table: Table):
    """(seq, valid), each (n_tiles, S): every tile's rows in walk order
    (list order, then row order), padded to the longest tile."""
    dev = lists.ids.device
    lmax = lists.ids.shape[1]
    k = torch.arange(lmax, device=dev)[None, :]
    box = lists.ids.to(torch.int64)
    n = torch.where(k < lists.llen[:, None].to(torch.int64),
                    table.count.to(torch.int64)[box], 0)
    ends = torch.cumsum(n, dim=1)
    total = int(ends[:, -1].max()) if ends.numel() else 0
    s = torch.arange(total, device=dev)[None, :].expand(box.shape[0], -1)
    entry = torch.searchsorted(ends, s.contiguous(), right=True)
    valid = entry < lmax
    entry = torch.clamp(entry, max=lmax - 1)
    first = torch.gather(ends - n, 1, entry)
    seq = table.start.to(torch.int64)[torch.gather(box, 1, entry)] + s - first
    return torch.where(valid, seq, 0), valid


def _chunks(lists: Lists, table: Table, o, d):
    """Yield (ok, dd, tn_s, index) of each chunk of rows against the rays
    o, d (n_tiles, 2048, 3): each (n_tiles, 2048, chunk) but the rows'
    (n_tiles, 1, chunk) index, ``ok`` the inside, front-facing test of a
    listed row."""
    seq, valid = _row_sequence(lists, table)
    ox, oy, oz = (v[..., None] for v in o.unbind(-1))
    dx, dy, dz = (v[..., None] for v in d.unbind(-1))
    for s0 in range(0, seq.shape[1], _CHUNK):
        rw = table.rows[seq[:, s0:s0 + _CHUNK]]          # (T, C, 16)
        r = [rw[:, None, :, q] for q in range(12)]
        dd, un_s, vn_s, tn_s = _mt_quads(ox, oy, oz, dx, dy, dz, r)
        ok = (valid[:, None, s0:s0 + _CHUNK] & _mt_valid(dd, un_s, vn_s)
              & (tn_s > _EPS * dd))
        yield ok, dd, tn_s, rw[:, None, :, 12]


def _to_map(v, px, py, width: int, height: int):
    out = torch.empty((height, width), dtype=v.dtype, device=v.device)
    out[py, px] = v
    return out


def closest_plain(lists: Lists, table: Table, width: int, height: int):
    """Plain PyTorch version of :func:`closest`, on any device."""
    dev = table.rows.device
    _check(width, height, lists, table, dev)
    o, d = pinhole_rays(width, height, dev)
    bn = torch.full(o.shape[:2], MISS_T, dtype=torch.float32, device=dev)
    bd = torch.ones_like(bn)
    bi = torch.full_like(bn, -1.0)
    m = torch.zeros(o.shape[:2], dtype=torch.int32, device=dev)
    for ok, dd, tn_s, idx in _chunks(lists, table, o, d):
        for c in range(ok.shape[-1]):
            num = tn_s[..., c] * bd
            den = bn * dd[..., c]
            upd = ok[..., c] & ((num < den) | ((num == den)
                                               & (idx[..., c] < bi)))
            bn = torch.where(upd, tn_s[..., c], bn)
            bd = torch.where(upd, dd[..., c], bd)
            bi = torch.where(upd, idx[..., c], bi)
            m = torch.where(upd, 4, m)
    t = torch.where(m == 4, bn / bd, MISS_T)
    px, py = tile_pixels(width, height, dev)
    return _to_map(t, px, py, width, height), _to_map(m, px, py, width,
                                                      height)


def _rays_in_tiles(o, d, tl, width: int, height: int):
    px, py = tile_pixels(width, height, o.device)
    return o[py, px], d[py, px], tl[py, px]


def _check_rays(o, d, tl, width: int, height: int, dev):
    for name, a, shape in (("o", o, (height, width, 3)),
                           ("d", d, (height, width, 3)),
                           ("tl", tl, (height, width))):
        if tuple(a.shape) != shape or a.dtype != torch.float32 \
                or a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {dev}")


def occluded_plain(lists: Lists, table: Table, o, d, tl):
    """Plain PyTorch version of :func:`occluded`, on any device."""
    height, width = tl.shape
    dev = table.rows.device
    _check(width, height, lists, table, dev)
    _check_rays(o, d, tl, width, height, dev)
    ot, dt, tlt = _rays_in_tiles(o, d, tl, width, height)
    occ = torch.zeros(tlt.shape, dtype=torch.bool, device=dev)
    for ok, dd, tn_s, _ in _chunks(lists, table, ot, dt):
        occ |= (ok & (tn_s < tlt[..., None] * dd)).any(dim=-1)
    px, py = tile_pixels(width, height, dev)
    return _to_map(occ.to(torch.int32), px, py, width, height)


def needed_pairs(lists: Lists, table: Table, o, d, tl) -> int:
    """(ray, row) pairs an occlusion call needs: each ray's rows in walk
    order up to its first occluder, or all of them (plain PyTorch)."""
    height, width = tl.shape
    ot, dt, tlt = _rays_in_tiles(o, d, tl, width, height)
    first = torch.zeros(tlt.shape, dtype=torch.int64, device=tl.device)
    for c, (ok, dd, tn_s, _) in enumerate(_chunks(lists, table, ot, dt)):
        hit = ok & (tn_s < tlt[..., None] * dd)
        pos = hit.to(torch.int8).argmax(-1) + c * _CHUNK + 1
        first = torch.where((first == 0) & hit.any(-1), pos, first)
    rows = tile_rows(lists, table)[:, None]
    return int(torch.where(first > 0, first, rows).sum())


def _launch(name: str, *args):
    from ..utils.build import load
    lib = load()
    err = getattr(lib, f"diag_dda_{name}_launch")(*args)
    if err != 0:
        msg = lib.diag_dda_error_string(err).decode()
        raise RuntimeError(f"diag_dda {name} launch failed: CUDA error {err} "
                           f"({msg})")


def _device(table: Table):
    dev = table.rows.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if table.rows.data_ptr() % 16:
        raise ValueError("the row table must be 16-byte aligned (the "
                         "kernels copy it 16 bytes at a time)")
    return dev


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _order_ptr(lists: Lists):
    return None if lists.order is None else lists.order.data_ptr()


def _closest_launch(lists: Lists, table: Table, width: int, height: int,
                    stats):
    dev = _device(table)
    _check(width, height, lists, table, dev)
    t = torch.empty((height, width), dtype=torch.float32, device=dev)
    m = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("closest", lists.llen.data_ptr(), lists.ids.data_ptr(),
                int(lists.ids.shape[1]), table.start.data_ptr(),
                table.count.data_ptr(), table.rows.data_ptr(),
                ctypes.addressof(_camera()), width // TILE_W,
                height // TILE_H, t.data_ptr(), m.data_ptr(),
                _order_ptr(lists),
                None if stats is None else stats.data_ptr(), _stream(dev))
    return t, m


def _occ_launch(lists: Lists, table: Table, o, d, tl, stats):
    dev = _device(table)
    height, width = tl.shape
    _check(width, height, lists, table, dev)
    _check_rays(o, d, tl, width, height, dev)
    occ = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("occ", lists.llen.data_ptr(), lists.ids.data_ptr(),
                int(lists.ids.shape[1]), table.start.data_ptr(),
                table.count.data_ptr(), table.rows.data_ptr(), o.data_ptr(),
                d.data_ptr(), tl.data_ptr(), width // TILE_W,
                height // TILE_H, occ.data_ptr(),
                _order_ptr(lists),
                None if stats is None else stats.data_ptr(), _stream(dev))
    return occ


def closest(lists: Lists, table: Table, width: int, height: int):
    """(t, m) (height, width) maps; a CUDA table launches the kernel (or
    raises), a CPU one takes :func:`closest_plain`."""
    global CLOSEST_LAUNCHES
    if table.rows.device.type == "cpu":
        return closest_plain(lists, table, width, height)
    out = _closest_launch(lists, table, width, height, None)
    CLOSEST_LAUNCHES += 1
    return out


def occluded(lists: Lists, table: Table, o, d, tl):
    """(height, width) int32 0/1 occlusion map; a CUDA table launches the
    kernel (or raises), a CPU one takes :func:`occluded_plain`."""
    global OCC_LAUNCHES
    if table.rows.device.type == "cpu":
        return occluded_plain(lists, table, o, d, tl)
    out = _occ_launch(lists, table, o, d, tl, None)
    OCC_LAUNCHES += 1
    return out


#: The counting launches' tally (csrc/diag_dda.cu, Tally): (ray, row)
#: pairs the warps test (their lanes' rays x the rows a warp runs) and the
#: pairs the rays need (closest: every listed pair; occlusion: each ray's
#: rows up to its first occluder), rows copied into shared memory and
#: stages (summed over blocks), and clock64 cycles summed over warps
#: loading list chunks and issuing copies, waiting for copies, in
#: barriers, testing rows, and in the whole kernel.
STAT_NAMES = ("tested", "needed", "rows_staged", "stages", "issue_cycles",
              "wait_cycles", "barrier_cycles", "test_cycles",
              "kernel_cycles")


def _stats(launch, dev) -> dict:
    stats = torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=dev)
    launch(stats)
    return dict(zip(STAT_NAMES, stats.tolist()))


def closest_stats(lists: Lists, table: Table, width: int, height: int):
    """The work of one :func:`closest` call: a launch of the counting
    instantiation on the card (not counted in ``CLOSEST_LAUNCHES``; the
    maps are discarded), its tally by :data:`STAT_NAMES`."""
    return _stats(lambda s: _closest_launch(lists, table, width, height, s),
                  _device(table))


def occluded_stats(lists: Lists, table: Table, o, d, tl):
    """The work of one :func:`occluded` call, as :func:`closest_stats`."""
    return _stats(lambda s: _occ_launch(lists, table, o, d, tl, s),
                  _device(table))


def occupancy() -> dict:
    """Resident blocks an SM and threads a block of the two timed kernels
    on the current card (the occupancy calculator's)."""
    from ..utils.build import load
    lib, out = load(), {}
    for which, name in enumerate(("closest", "occ")):
        threads = ctypes.c_int(0)
        blocks = lib.diag_dda_occupancy(which, ctypes.byref(threads))
        out[name] = {"blocks_per_sm": blocks, "threads": threads.value}
    return out


def tile_rows(lists: Lists, table: Table) -> torch.Tensor:
    """(n_tiles,) int64: the rows each tile's list names."""
    k = torch.arange(lists.ids.shape[1], device=lists.ids.device)[None, :]
    n = table.count.to(torch.int64)[lists.ids.to(torch.int64)]
    return torch.where(k < lists.llen[:, None].to(torch.int64), n, 0).sum(1)
