"""Kernels B11 / B11w's tables and their walk's schedules, on the CPU.

* ``ops/grid.py::occupancy_bits``, the bitmap the kernels test before they
  read a cell, equals ``counts > 0`` bit for bit, and ``cell_rows`` copies
  each cell's triangle rows in slot order, the pairs the plain walk tests;
* a stepping form of the NumPy twin of ``csrc/pt_device.cuh::grid_closest``
  (``tests/test_torch_grid_walk.py``: one cell a step, as the kernels'
  ``dda_start`` / ``dda_cell`` / ``dda_advance``), held bit for bit to the
  twin, runs a band of a ripple sheet under two schedules of a warp's
  walks: lockstep (every lane's camera walk of sample s, then its shadow
  walks, together: B11w's and B11's shadow walks; B11's camera walks
  also cross each run of empty cells in an inner loop) and per lane
  (each lane moves on to its next walk as soon as one ends; Aila and
  Laine, "Understanding the Efficiency of Ray Traversal on GPUs", HPG
  2009).  They give each pixel the same hits in the same order, and the
  warp steps lockstep and per lane pay equal the counts the kernels'
  tally reads from the walks' cells (``STAT_NAMES``: ``cam_warp_steps``
  + ``shadow_warp_steps``, ``sched_all``);
* the warp's pooled pair test (B11w): the least ``hit_key`` of an owner's
  hits picks the pair the sequential slot-order scan keeps;
* B11w's wrapper reads each hit column through a pointer and an element
  stride (``ops/grid.py::_column``): broadcast scalars and tensors, strided
  views and other dtypes give the values of the broadcast column.
"""

import functools

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
    make_camera, primary_rays)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
from opencl_montecarlo_path_tracing_tpu_torch.ops import intersect as TI
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
    _tri_table)
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    demo_scene, large_mesh_scene)
from tests.test_torch_gpu import grid_state, sheet_scene, window_torus
from tests.test_torch_grid_walk import (
    BIG, F, max_nan, min_nan, mt_div, rays as case_rays, setup, walk_twin)


# ---------------------------------------------------------------------------
# the kernels' tables


def bits_of(occ: torch.Tensor, n: int) -> np.ndarray:
    """The first n bits of an int32 bitmap, bit c % 32 of word c // 32."""
    words = occ.numpy().view(np.uint32)
    return ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(
        bool).reshape(-1)[:n]


def odd_grid():
    """A host-built grid of 5 x 3 x 7 = 105 cells (not a multiple of 32)
    over 40 random triangles' boxes."""
    g = np.random.default_rng(2)
    lo = g.uniform(0, 9, (40, 3)).astype(np.float32)
    hi = lo + g.uniform(0, 2, (40, 3)).astype(np.float32)
    return G.build_grid_host(lo, hi, np.zeros(3, np.float32),
                             np.float32([2.0, 3.5, 1.5]), (5, 3, 7), cap=7)


@functools.lru_cache(maxsize=None)
def scene_grid(name):
    if name == "odd":
        return odd_grid()
    scene = {"sheet": large_mesh_scene, "torus": lambda: demo_scene()[0],
             "window torus": window_torus}[name]()
    return G.triangle_grid(TI.prep_scene(scene))[0]


@pytest.mark.parametrize("name", ["sheet", "torus", "window torus", "odd"])
def test_occupancy_bits_equal_counts(name):
    """occupancy_bits == counts > 0, bit for bit, every bit past the last
    cell clear; grid_tables carries it (and the cell rows) for the
    kernels."""
    grid = scene_grid(name)
    n = int(grid.counts.numel())
    occ = G.occupancy_bits(grid.counts)
    assert occ.dtype == torch.int32 and occ.shape == ((n + 31) // 32,)
    bits = bits_of(occ, occ.numel() * 32)
    np.testing.assert_array_equal(bits[:n], grid.counts.numpy() > 0)
    assert not bits[n:].any()
    assert 0 < bits.sum() < n or name == "odd"
    if name != "odd":
        tab = G.grid_tables(TI.prep_scene(
            {"sheet": large_mesh_scene, "torus": lambda: demo_scene()[0],
             "window torus": window_torus}[name]()), grid, "cpu")
        assert torch.equal(tab.occ, occ)
        assert tab.rows.shape[0] == int(grid.counts.sum())


@pytest.mark.parametrize("name", ["sheet", "torus", "window torus", "odd"])
def test_cell_rows_are_the_cells_triangles_in_slot_order(name):
    """cell_rows: cell c's span (first, n) holds, in slot order, the rows
    of the triangles of its live slots (k < counts[c], id >= 0), cells in
    index order, every row a copy of the table's; a grid with a -1 among
    its live slots skips it as the plain walk does."""
    grid = scene_grid(name)
    items, counts = grid.items.numpy(), grid.counts.numpy()
    g = np.random.default_rng(4)
    table = torch.from_numpy(g.normal(size=(int(items.max()) + 1, 12))
                             .astype(np.float32))
    if name == "odd":       # a hole among the live slots
        c = int(np.argmax(counts))
        items = items.copy()
        items[c, 0] = -1
        grid = grid._replace(items=torch.from_numpy(items))
    rows, span = G.cell_rows(grid, table)
    assert rows.dtype == torch.float32 and span.dtype == torch.int32
    assert span.shape == (counts.size, 2) and rows.shape[1] == 12
    first, n = span.numpy().T
    want_first = 0
    for c in range(counts.size):
        ids = [i for i in items[c, :counts[c]] if i >= 0]
        assert (first[c], n[c]) == (want_first, len(ids))
        np.testing.assert_array_equal(
            rows.numpy()[first[c]:first[c] + n[c]], table.numpy()[ids])
        want_first += len(ids)
    assert rows.shape[0] == want_first


# ---------------------------------------------------------------------------
# the stepping twin


class Walks:
    """The twin's walks of rays (o, d) from the running distances t (or,
    with ``any_hit``, occlusion below t), one cell a ``step``: dda_start
    at construction, then for each ray still walking dda_cell, the cell's
    pairs (grid_cell_scan, in slot order) and dda_advance.  Records each
    ray's cells and its hits in order (triangle, rd)."""

    def __init__(self, o, d, t, grid, table, neg_t=False, any_hit=False):
        o, d = np.asarray(o, F).reshape(-1, 3), np.asarray(d, F).reshape(-1, 3)
        self.o, self.d, self.table = o, d, table
        self.neg_t, self.any_hit = neg_t, any_hit
        self.t = np.asarray(t, F).reshape(-1).copy()
        self.items, self.counts = grid.items.numpy(), grid.counts.numpy()
        frame = G.grid_frame(grid).numpy()
        vmin, vmax, cs = frame[0:3], frame[3:6], frame[6:9]
        res = np.asarray(grid.res, np.int64)
        self.res = res
        res_f = res.astype(F)
        with np.errstate(all="ignore"):
            inv = F(1) / d
            a, b = (vmin - o) * inv, (vmax - o) * inv
            e0, e1 = min_nan(a, b), max_nan(a, b)
            t0 = max_nan(max_nan(e0[:, 0], e0[:, 1]), e0[:, 2])
            t1 = min_nan(min_nan(e1[:, 0], e1[:, 1]), e1[:, 2])
            inside = ((o >= vmin) & (o <= vmax)).all(axis=1)
            p = np.where(inside[:, None], o, o + d * t0[:, None])
            c = np.floor((p - vmin) / cs)
        self.entered = t0 <= t1
        self.live = self.entered.copy()
        c = np.where(np.isfinite(c), c, 0).astype(np.int64)
        self.idx = np.clip(c, 0, res - 1)
        self.pos = d > 0
        with np.errstate(all="ignore"):
            self.dl = (e1 - e0) / res_f
            self.nxt = np.where(
                self.pos, e0 + (self.idx + 1).astype(F) * self.dl,
                e0 + res_f * self.dl - self.idx.astype(F) * self.dl)
        self.left = np.full(len(o), int(res.sum()) + 2)
        self.occ = np.zeros(len(o), bool)
        self.m = np.zeros(len(o), np.int32)
        self.cells = np.zeros(len(o), np.int64)
        self.hits = [[] for _ in range(len(o))]

    def step(self, sel=None) -> None:
        """One cell of every walking ray (of ``sel``, when given)."""
        rays = np.nonzero(self.live)[0] if sel is None else \
            np.asarray(sel)[self.live[sel]]
        rx, ry, rz = self.res
        for r in rays:
            ix, iy, iz = self.idx[r]
            c = min(max(iz * rx * ry + iy * rx + ix, 0), rx * ry * rz - 1)
            self.cells[r] += 1
            limit = BIG if self.any_hit else self.t[r]
            for k in range(int(self.counts[c])):
                tri = int(self.items[c, k])
                if tri < 0:
                    continue
                with np.errstate(all="ignore"):
                    ok, rd = mt_div(self.table[tri][None], self.o[r][None],
                                    self.d[r][None], self.neg_t)
                if ok[0] and rd[0] < limit:
                    self.hits[r].append((tri, float(rd[0])))
                    if self.any_hit:
                        self.occ[r] = True
                        break
                    self.t[r] = limit = rd[0]
                    self.m[r] = 4
            if self.occ[r]:
                self.live[r] = False
                continue
            nx = self.nxt[r]
            ax = 0 if nx[0] <= nx[1] and nx[0] <= nx[2] else (
                1 if nx[1] <= nx[2] else 2)
            with np.errstate(all="ignore"):
                nx[ax] = nx[ax] + self.dl[r, ax]
            go = not (limit < nx[ax])
            if go:
                self.idx[r, ax] += 1 if self.pos[r, ax] else -1
            self.left[r] -= 1
            self.live[r] = go and self.left[r] > 0 and self.idx[r, ax] != (
                self.res[ax] if self.pos[r, ax] else -1)

    def run(self) -> "Walks":
        while self.live.any():
            self.step()
        return self

    def on_occupied(self) -> np.ndarray:
        """Whether each ray's current cell holds a triangle."""
        rx, ry, rz = self.res
        ix, iy, iz = self.idx.T
        c = np.clip(iz * rx * ry + iy * rx + ix, 0, rx * ry * rz - 1)
        return self.counts[c] > 0

    def run_nested(self) -> int:
        """The walks with an inner loop over each run of empty cells
        (grid_dda's kNest, in lockstep): the rays on empty cells step on
        together until each is on an occupied cell or done, then the rays
        on occupied cells take theirs; returns the iterations."""
        iters = 0
        while self.live.any():
            while (self.live & ~self.on_occupied()).any():
                iters += 1
                self.step(np.nonzero(self.live & ~self.on_occupied())[0])
            if self.live.any():
                iters += 1
                self.step()
        return iters


@pytest.mark.parametrize("kind", ["camera", "shadow", "inside", "planes"])
def test_stepping_twin_equals_the_twin(kind):
    """The stepping twin's walks == walk_twin's on the grid-walk cases of
    the 1,800-triangle sheet bit for bit: t, material, cells and pairs
    (closest), and the occlusion booleans (any hit)."""
    _, scn, _, grid = setup("sheet")
    o, d, t = case_rays("sheet", kind)
    m, nrm, needs = grid_state(len(o))
    table = _tri_table(scn)
    (tw, mw, _, _), tally = walk_twin(o, d, t, m, nrm, needs, grid, table,
                                      False)
    w = Walks(o, d, t, grid, table).run()
    np.testing.assert_array_equal(w.t, tw)
    np.testing.assert_array_equal(np.where(w.m == 4, 4, m), mw)
    assert int(w.cells.sum()) == tally["cells"]
    assert int(w.entered.sum()) == tally["entered"]
    occ, _ = walk_twin(o, d, t, m, nrm, needs, grid, table, False,
                       any_hit=True)
    np.testing.assert_array_equal(
        Walks(o, d, t, grid, table, any_hit=True).run().occ, occ)


# ---------------------------------------------------------------------------
# a warp's walks under two schedules


BAND = (240, 248, 0, 16)   # rows, columns of the 512 x 512 frame: 4 warps
SPP = 3


@functools.lru_cache(maxsize=None)
def band():
    """The band's pixels in the kernels' warp layout (8 x 4 patches),
    their camera rays of samples 0..SPP-1 with the floor / squares /
    spheres' running hit, the scene and its grid."""
    scn = TI.prep_scene(sheet_scene(30, 30))
    grid, _ = G.triangle_grid(scn)
    r0, r1, c0, c1 = BAND
    jj, ii = np.mgrid[r0:r1, c0:c1]
    warp = (jj - r0) // 4 * ((c1 - c0) // 8) + (ii - c0) // 8
    lane = (jj - r0) % 4 * 8 + (ii - c0) % 8
    order = np.lexsort((lane.ravel(), warp.ravel()))
    ii = torch.from_numpy(ii.ravel()[order].astype(np.float32))
    jj = torch.from_numpy(jj.ravel()[order].astype(np.float32))
    rays = []
    for s in range(SPP):
        ray_id = (jj * 512 + ii).to(torch.int64) * 64 + s
        o, d = primary_rays(make_camera(z_sign=-1.0), ii, jj,
                            *R.randn_draws((3, 1), ray_id, C.SITE_CAMERA, 4))
        pre = TI.trace_ray(o, d, scn, triangles=False)
        rays.append((o.numpy(), d.numpy(), pre.t.numpy()))
    return scn, grid, _tri_table(scn), rays


def shadow_ray(scn, o, d, t, m):
    """Light i's shadow ray from a camera walk's hit (unjittered, float32)
    where it hit the floor, a square or the sheet, else None."""
    if m == 0:
        return None
    x = (o + d * t).astype(F)
    out = []
    for light in scn.lights:
        ld = (light[:3].astype(F) - x).astype(F)
        ld = (ld / np.sqrt(F((ld * ld).sum()))).astype(F)
        out.append((x, ld))
    return out


def lane_program(scn, grid, table, rays, p):
    """Pixel p's walks in the kernel's order, each set up when the one
    before it ends: for every sample its camera walk (closest hit from the
    pre-stage's t), then a shadow walk to each light from that hit (any
    hit).  Yields (kind, Walks of one ray) and receives nothing: a walk's
    result is read from the object once it ends."""
    for s, (o, d, t0) in enumerate(rays):
        cam = Walks(o[p], d[p], t0[p], grid, table)
        yield ("camera", s, -1), cam
        m = 4 if cam.m[0] == 4 else (1 if t0[p] < BIG else 0)
        for i, sr in enumerate(shadow_ray(scn, o[p], d[p], cam.t[0], m)
                               or ()):
            yield ("shadow", s, i), Walks(sr[0], sr[1], BIG, grid, table,
                                          any_hit=True)


def per_lane(scn, grid, table, rays, lanes):
    """The per-lane schedule of one warp: every iteration each lane whose
    walk has ended sets up its next one (walks that never enter the grid
    end at once), then every walking lane steps one cell.  Returns the
    iterations and each lane's walks [(tag, cells, hits, occ)]."""
    progs = [lane_program(scn, grid, table, rays, p) for p in lanes]
    cur = [None] * len(lanes)
    done = [[] for _ in lanes]
    iters = 0
    while True:
        for j, prog in enumerate(progs):
            while prog is not None and (cur[j] is None
                                        or not cur[j][1].live[0]):
                if cur[j] is not None:
                    w = cur[j][1]
                    done[j].append((cur[j][0], int(w.cells[0]), w.hits[0],
                                    bool(w.occ[0])))
                cur[j] = next(prog, None)
                if cur[j] is None:
                    progs[j] = prog = None
        walking = [c for c in cur if c is not None and c[1].live[0]]
        if not walking:
            return iters, done
        iters += 1
        for _, w in walking:
            w.step()


def lockstep(scn, grid, table, rays, lanes, nest_camera=False):
    """The lockstep schedule: sample by sample the camera walks of all
    lanes together, then light by light their shadow walks, each group
    stepping until its last walk ends; with ``nest_camera`` the camera
    walks cross each run of empty cells in an inner loop (kernel B11's
    schedule).  Returns the iterations and each lane's walks [(tag,
    cells, hits, occ)]."""
    done = [[] for _ in lanes]
    iters = 0
    for s, (o, d, t0) in enumerate(rays):
        cam = Walks(o[lanes], d[lanes], t0[lanes], grid, table)
        if nest_camera:
            iters += cam.run_nested()
        while cam.live.any():
            iters += 1
            cam.step()
        for j in range(len(lanes)):
            done[j].append((("camera", s, -1), int(cam.cells[j]),
                            cam.hits[j], False))
        srs = [shadow_ray(scn, o[p], d[p], cam.t[j],
                          4 if cam.m[j] == 4 else
                          (1 if t0[p] < BIG else 0))
               for j, p in enumerate(lanes)]
        for i in range(len(scn.lights)):
            js = [j for j, sr in enumerate(srs) if sr]
            if not js:
                continue
            sh = Walks(np.stack([srs[j][i][0] for j in js]),
                       np.stack([srs[j][i][1] for j in js]), BIG, grid,
                       table, any_hit=True)
            while sh.live.any():
                iters += 1
                sh.step()
            for k, j in enumerate(js):
                done[j].append((("shadow", s, i), int(sh.cells[k]),
                                sh.hits[k], bool(sh.occ[k])))
    return iters, done


def want_lane_of(walks) -> int:
    """A warp's largest lane sum of cells: no schedule pays fewer steps."""
    return max(sum(x[1] for x in lane) for lane in walks)


def test_per_lane_schedule_keeps_each_pixels_hits():
    """On 4 warps of the 1,800-triangle sheet (rows 240-247, columns
    0-15, 3 samples, a shadow walk to each light from each hit): the
    per-lane schedule and B11's (camera walks crossing each run of empty
    cells in an inner loop) give every pixel the walks, cells and hits (in
    order, rd bit for bit) of the lockstep one, which is the stepping
    twin run walk by walk; each schedule's warp steps equal the tally's
    reading of the walks' cells - lockstep: the sum over walk slots of the
    lanes' largest, per lane: the lanes' largest sum - and the per-lane
    schedule pays no more."""
    scn, grid, table, rays = band()
    n = len(rays[0][0])
    assert n == 128
    total = {"lockstep": 0, "per_lane": 0, "cells": 0, "hits": 0}
    for w0 in range(0, n, 32):
        lanes = list(range(w0, w0 + 32))
        li, lock = lockstep(scn, grid, table, rays, lanes)
        pi, mine = per_lane(scn, grid, table, rays, lanes)
        ni, nest = lockstep(scn, grid, table, rays, lanes, nest_camera=True)
        for a, b, n in zip(lock, mine, nest):
            assert [x[0] for x in a] == [x[0] for x in b]
            assert [x[0] for x in a] == [x[0] for x in n]
            for (tag, ca, ha, oa), (_, cb, hb, ob), (_, cn, hn, on) in zip(
                    a, b, n):
                assert (ca, oa) == (cb, ob) == (cn, on), tag
                for hx in (hb, hn):
                    assert np.array_equal(np.asarray(ha, np.float64),
                                          np.asarray(hx, np.float64)), tag
        assert ni >= want_lane_of(lock)
        # the tally's reading of the cells
        slots = sorted({x[0] for lane in lock for x in lane})
        cells = {(j, x[0]): x[1] for j, lane in enumerate(lock) for x in lane}
        want_lock = sum(max(cells.get((j, sl), 0) for j in range(32))
                        for sl in slots)
        want_lane = max(sum(x[1] for x in lane) for lane in lock)
        assert li == want_lock and pi == want_lane
        assert pi <= li
        total["lockstep"] += li
        total["per_lane"] += pi
        total["cells"] += sum(x[1] for lane in lock for x in lane)
        total["hits"] += sum(len(x[2]) for lane in lock for x in lane)
    # the band really walks: hits, shadow walks, and lanes out of step
    assert total["hits"] > 100 and total["per_lane"] < total["lockstep"]
    assert total["cells"] <= 32 * total["lockstep"]


# ---------------------------------------------------------------------------
# B11w's columns


@pytest.mark.parametrize("case", ["scalar", "zero_dim", "one", "full",
                                  "strided", "row", "int64", "bool"])
def test_walk_columns_read_the_broadcast_values(case):
    """_column(x, shape, n, dtype): (tensor, stride) with tensor.flatten()
    [i * stride] == broadcast_to(x, shape).flatten()[i] for every ray i,
    in the kernel's dtype: stride 0 for one value (a Python scalar, a 0-d
    or 1-element tensor), a view's stride where one exists, a copy where
    the dtype differs or the broadcast has no single stride."""
    shape, n = (6, 7), 42
    g = np.random.default_rng(1)
    base = torch.from_numpy(g.normal(size=(6, 14)).astype(np.float32))
    x, dtype, want_stride = {
        "scalar": (1e9, torch.float32, 0),
        "zero_dim": (torch.tensor(2.5), torch.float32, 0),
        "one": (torch.tensor([3.5]), torch.float32, 0),
        "full": (base[:, :7].contiguous(), torch.float32, 1),
        "strided": (base.reshape(-1)[::2].reshape(shape), torch.float32, 2),
        "row": (base[0, :7], torch.float32, 1),
        "int64": (torch.arange(n).reshape(shape), torch.int32, 1),
        "bool": (torch.arange(n).reshape(shape) % 3 == 0, torch.bool, 1),
    }[case]
    col, stride = G._column(x, shape, n, dtype, torch.device("cpu"))
    assert col.dtype == dtype and stride == want_stride
    want = torch.broadcast_to(torch.as_tensor(x).to(dtype), shape).reshape(-1)
    flat = torch.as_strided(col, (n,), (stride,), col.storage_offset())
    assert torch.equal(flat, want)


def test_grid_walk_cpu_takes_broadcast_inputs():
    """grid_walk on CPU tensors (the plain walk) with a scalar t, a 0-d m,
    one-element normals and a broadcast needs == with the columns
    materialised, bit for bit, on the 1,800-triangle sheet's camera rays."""
    _, scn, _, grid = setup("sheet")
    o, d, _ = case_rays("sheet", "camera")
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    n = o.shape[0]
    tab = G.grid_tables(scn, grid, "cpu")
    one = (1e9, torch.tensor(1, dtype=torch.int32), torch.tensor([0.0]),
           torch.tensor([0.0]), torch.tensor([1.0]), torch.tensor(True))
    full = (torch.full((n,), 1e9), torch.ones(n, dtype=torch.int32),
            torch.zeros(n), torch.zeros(n), torch.ones(n),
            torch.ones(n, dtype=torch.bool))
    a = G.grid_walk(o, d, *one, tab, DEFAULT)
    b = G.grid_walk(o, d, *full, tab, DEFAULT)
    for x, y in zip(a, b):
        assert x.shape == (n,)
        assert torch.equal(x, y)
    assert int((b[1] == 4).sum()) > 0.05 * n


# ---------------------------------------------------------------------------
# the warp's pooled pair test


def hit_key(rd, k):
    """csrc/pt_device.cuh::hit_key: float32 distances (not NaN) and slots ->
    uint64 keys, ordered by distance (-0 == +0), then slot."""
    rd = np.where(rd == 0, F(0), rd).astype(F)
    b = rd.view(np.uint32).astype(np.uint64)
    o = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return (o << np.uint64(32)) | np.asarray(k, np.uint64)


@pytest.mark.parametrize("seed", range(6))
def test_pooled_merge_equals_the_sequential_scan(seed):
    """The owner's least key among its cell's hitting pairs (rd < the t it
    entered the cell with; any-hit walks key by slot) picks the pair the
    sequential slot-order scan keeps - its strict `rd < t` taking the
    first of equal distances, -0 and +0 equal, NaN never - bit for bit,
    on cells of random distances thick with ties, signed zeros, NaNs and
    misses; and the keys order any two distances as float32 does."""
    g = np.random.default_rng(seed)
    for _ in range(400):
        n = int(g.integers(1, 40))
        pool = np.array([0.0, -0.0, 0.5, 0.5, 1.25, -3.0, 7.0, np.nan, 9.0,
                         1e9], F)
        rd = g.choice(pool, n)
        fresh = g.random(n) < 0.3
        rd[fresh] = g.normal(0, 5, int(fresh.sum())).astype(F)
        ok = g.random(n) < 0.7
        t0 = F(g.choice([8.0, 1e9, 0.5, -1.0]))
        t, win = t0, -1
        for k in range(n):                  # grid_cell_scan's order
            if ok[k] and rd[k] < t:
                t, win = rd[k], k
        hits = np.nonzero(ok & (rd < t0))[0]
        if win < 0:
            assert len(hits) == 0
            continue
        keys = hit_key(rd[hits], hits)
        best = int(hits[np.argmin(keys)])
        assert best == win
        assert rd[best].view(np.uint32) == t.view(np.uint32)
        first = int(hits.min())             # any hit: the first slot
        assert first == next(k for k in range(n) if ok[k] and rd[k] < t0)
    x = np.concatenate([g.normal(0, 3, 500), [0.0, -0.0, 1e-30, -1e-30,
                                              3e38, -3e38]]).astype(F)
    kx = hit_key(x, np.zeros(len(x), np.int64))
    i, j = g.integers(0, len(x), (2, 2000))
    assert np.array_equal(kx[i] < kx[j], x[i] < x[j])
    assert np.array_equal(kx[i] == kx[j], x[i] == x[j])
