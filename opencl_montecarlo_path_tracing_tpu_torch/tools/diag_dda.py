"""The grid cell-walk diagnostic: do a uniform grid's per-tile cell lists
beat disjoint Morton blocks as the culling structure of a triangle scan?

The port of the JAX package's ``tools/diag_dda_pallas.py::main``.  For each
scene, at size x size pixels in 64x32 tiles, one kernel
(``ops/diag_dda.py``, kernels B8-dda-closest and B8-dda-occ) walks each
tile's list of boxes and tests their triangle rows against the tile's rays:

  cell-list walk     the occupied grid cells any of the tile's primary rays
                     crosses (the host's slab test, which the grid's DDA
                     visitation equals);
  morton take-list   the large-mesh kernel's 128-triangle Morton blocks
                     (ops/tri_blocks.py) with per-tile slab lists - the
                     same kernel on the structure the blocked scan uses;
  shadow arms        the same walk as an occlusion pass from the closest-hit
                     points to each light, over lists built from the
                     segments, for both structures;
  dense scan         every 128-row block (meshes of <= 25,000 triangles);
  per-lane DDA       ops/grid.py::traverse_triangles: kernel B11w on
                     the card, plain PyTorch on the CPU (<= 25,000
                     triangles).

It prints each arm's best time of 3 warm calls and the checks: cell and
Morton closest-hit maps agree (hit masks equal, the largest relative
difference of t printed), and so do their occlusion maps; a mismatch
raises.  The host list build's seconds are printed apart from the kernel
times.

    python -m opencl_montecarlo_path_tracing_tpu_torch.tools.diag_dda \\
        [--device cuda|cpu] [--size 512] [--scenes demo,5k,20k,65k]

``--device cpu`` runs the kernels' plain versions (the counterpart of the
JAX tool's interpret mode).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import diag_dda as K
from ..ops.grid import traverse_triangles
from ..ops.intersect import SceneArrays, prep_scene
from ..scene.builtin import demo_scene, ripple_sheet_mesh
from ..scene.scene import Scene
from . import diag_host as H
from .timing import best_ms

#: ripple-sheet meshes by tag: 2 * n_major * n_minor triangles
SHEETS = {"5k": (50, 50), "20k": (144, 72), "65k": (256, 128),
          "262k": (512, 256)}
DENSE_MAX = 25000   # the dense scan and per-lane DDA run up to this size
REPEATS = 3


class Arm(NamedTuple):
    """One timed kernel call: its inputs, output and best ms."""
    lists: K.Lists
    table: K.Table
    rays: tuple | None    # (o, d, tl) of an occlusion call
    out: object           # (t, m) maps, or the occlusion map
    ms: float


def scene_arrays(tag: str) -> SceneArrays:
    """The demo scene, or its spheres, squares and lights with a ripple
    sheet (dense tori fall under the reference's det cutoff)."""
    base, _ = demo_scene()
    if tag == "demo":
        return prep_scene(base)
    if tag not in SHEETS:
        raise ValueError(f"unknown scene {tag!r}: demo or one of "
                         f"{sorted(SHEETS)}")
    return prep_scene(Scene(sphere_centers=base.sphere_centers,
                            square_kj=base.square_kj,
                            triangles=ripple_sheet_mesh(*SHEETS[tag]),
                            lights=base.lights))


def _bench(fn, device, size: int, tag: str):
    out, best, first = best_ms(fn, device, REPEATS)
    rate = size * size / best / 1e3
    print(f"  {tag:28s}: {best:8.2f} ms ({rate:7.2f} Mpaths/s) "
          f"[first {first:.1f} ms]", flush=True)
    return out, best


def _host(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _closest(lists, boxes, size, device, tag):
    tb = K.table_on(boxes, device)
    ls = K.ranked(K.lists_on(lists, device), tb)
    out, ms = _bench(lambda: K.closest(ls, tb, size, size), device, size,
                     tag)
    return Arm(ls, tb, None, out, ms)


def _shadow(name, boxes, x, lights, size, device):
    """The occlusion pass for each light over ``boxes``: (arms, host s)."""
    arms, host_s = [], 0.0
    tb = K.table_on(boxes, device)
    for li, light in enumerate(lights):
        sd, dist = H.shadow_rays(x, light)
        lists, s = _host(lambda: H.tile_lists(
            x, sd, boxes, size, size, tmax_cap=dist, sort_near=False,
            device=device))
        host_s += s
        ls = K.ranked(K.lists_on(lists, device), tb)
        rays = tuple(torch.from_numpy(a).to(device)
                     for a in H.shadow_inputs(x, sd, dist, size, size))
        out, ms = _bench(lambda: K.occluded(ls, tb, *rays), device, size,
                         f"{name} shadow L{li} (lists mean "
                         f"{np.mean(lists.llen):.0f})")
        arms.append(Arm(ls, tb, rays, out, ms))
    return arms, host_s


def _np(a) -> np.ndarray:
    return a.cpu().numpy()


def run_scene(tag: str, size: int, device) -> dict:
    """Every arm on one scene; returns the arms (inputs, outputs, best ms),
    the host seconds and the per-lane DDA's ms."""
    scn = scene_arrays(tag)
    nt = int(scn.tri_v0.shape[0])
    (grid, occ, cells), s_cells = _host(lambda: H.cell_boxes(scn))
    o, d = H.primary_rays(size)
    cl, s_cl = _host(lambda: H.tile_lists(o, d, cells, size, size,
                                          device=device))
    lens = cl.llen
    tris = [int(cells.count[cl.ids[t, :n]].sum()) for t, n in enumerate(lens)]
    print(f"{tag}: nt={nt} res={grid.res} occupied={len(occ)} cell lists "
          f"mean {np.mean(lens):.0f} max {lens.max()} (host build "
          f"{s_cells + s_cl:.2f} s; sum tris/tile mean {np.mean(tris):.0f})",
          flush=True)
    cell = _closest(cl, cells, size, device, "cell-list closest")
    t_l = _np(cell.out[0])

    morton, s_mb = _host(lambda: H.morton_boxes(scn))
    ml, s_ml = _host(lambda: H.tile_lists(o, d, morton, size, size,
                                          device=device))
    print(f"  morton blocks={len(morton.start)} lists mean "
          f"{np.mean(ml.llen):.0f} max {ml.llen.max()} (host build "
          f"{s_mb + s_ml:.2f} s)", flush=True)
    mort = _closest(ml, morton, size, device, "morton take-list closest")
    t_m, m_m = (_np(v) for v in mort.out)

    hit = t_m < 1e30
    if not hit.any():
        raise RuntimeError(f"{tag}: no primary ray hits a triangle")
    dl = np.abs(t_l - t_m)[hit] / np.maximum(t_m[hit], 1.0)
    same = bool(((t_l < 1e30) == hit).all())
    print(f"  cell vs morton closest: hits {int(hit.sum())}, max rel "
          f"{dl.max():.2e}; miss masks equal: {same}", flush=True)
    if not same:
        raise RuntimeError(f"{tag}: cell and Morton hit masks differ")

    # shadow arms over the same hit set (from the Morton maps)
    x = H.hit_points(t_m, m_m, o, d)
    lights = np.asarray(scn.lights, np.float64)
    sh_cell, s_sc = _shadow("cell", cells, x, lights, size, device)
    sh_mort, s_sm = _shadow("morton", morton, x, lights, size, device)
    for li in range(len(lights)):
        eq = _np(sh_cell[li].out) == _np(sh_mort[li].out)
        print(f"  occ L{li} equal: {bool(eq.all())} (mismatch "
              f"{int((~eq).sum())})", flush=True)
        if not eq.all():
            raise RuntimeError(f"{tag}: cell and Morton occlusion maps "
                               f"differ for light {li}")
    tot_cell = cell.ms + sum(a.ms for a in sh_cell)
    tot_mort = mort.ms + sum(a.ms for a in sh_mort)
    print(f"  TOTALS closest+shadow: cell {tot_cell:.2f} ms, morton "
          f"{tot_mort:.2f} ms -> cell/morton {tot_mort / tot_cell:.2f}x "
          f"({'cell wins' if tot_cell < tot_mort else 'morton wins'})",
          flush=True)
    host_s = {"cells": s_cells, "cell_lists": s_cl, "morton": s_mb,
              "morton_lists": s_ml, "shadow_lists": s_sc + s_sm}
    print(f"  host: tables {s_cells + s_mb:.2f} s, lists {s_cl:.2f} + "
          f"{s_ml:.2f} + shadow {s_sc + s_sm:.2f} s ({device})", flush=True)
    res = {"tag": tag, "nt": nt, "host_s": host_s,
           "closest": {"cell": cell, "morton": mort},
           "shadow": {"cell": sh_cell, "morton": sh_mort},
           "totals": {"cell": tot_cell, "morton": tot_mort},
           "dda_ms": None}
    if nt > DENSE_MAX:
        return res

    # dense twin and the per-lane DDA only where they are tractable
    dense = H.dense_boxes(scn)
    dlists = H.dense_lists(len(dense.start), size, size)
    res["closest"]["dense"] = arm = _closest(dlists, dense, size, device,
                                             "dense scan")
    t_d = _np(arm.out[0])
    dl = np.abs(t_l - t_d)[hit] / np.maximum(t_d[hit], 1.0)
    print(f"  cell-list vs dense: max rel {dl.max():.2e}; speedup "
          f"cell/dense {arm.ms / cell.ms:.2f}x", flush=True)

    R = size * size
    of = torch.from_numpy(o.astype(np.float32)).to(device)
    df = torch.from_numpy(d.astype(np.float32)).to(device)
    big = torch.full((R,), K.MISS_T, dtype=torch.float32, device=device)
    zero = torch.zeros(R, dtype=torch.float32, device=device)
    m0 = torch.zeros(R, dtype=torch.int32, device=device)
    ones = torch.ones(R, dtype=torch.bool, device=device)
    out, res["dda_ms"] = _bench(lambda: traverse_triangles(
        of, df, big, m0, zero, zero, zero, ones, scn, grid)[0], device, size,
        "per-lane DDA")
    t_x = _np(out).reshape(size, size)
    hx = t_x < 1e30
    both = hit & hx
    dx = np.abs(t_x - t_m)[both] / np.maximum(t_m[both], 1.0)
    print(f"  per-lane DDA vs morton: both-hit {int(both.sum())} (mask "
          f"mismatches {int((hx != hit).sum())}), max rel "
          f"{dx.max() if both.any() else 0.0:.2e}; cell/DDA "
          f"{res['dda_ms'] / cell.ms:.1f}x", flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--scenes", default="demo,5k")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "false")
    for tag in args.scenes.split(","):
        run_scene(tag, args.size, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
