"""The per-warp culls of kernels B2/B3 and B5 never skip a hit.

The CUDA kernels run only on a GPU, so these tests hold a torch twin of
each kernel's cull predicate - the same float32 operations in the same
order, no FMA - against the plain intersection tests on the CPU:

* B2/B3 (``csrc/mega_blocked.cu``, tables from
  ``ops/tri_blocks.py::walk_tables``): every (ray, triangle) pair that the
  plain row test accepts passes the slab predicate of the triangle's
  32-row sub-block, its 128-row block, its macro and every tree node above
  it, with the running best set to the pair's own distance (the tightest
  prune under which the pair could still win), for closest-hit and
  occlusion rays, with and without the negative-t quirk.  The rays are
  camera rays, shadow rays from their hits, random rays, and axis-parallel
  rays whose origin lies on a box plane (the slab's 0 * inf).  Every child
  box lies inside its parent's.
* B5 (``csrc/mega_simple.cu``, groups from
  ``ops/mega_simple.py::sphere_groups``): every (ray, sphere) pair that the
  plain sphere test hits (q > 0, eps < s) passes the card's and the
  sphere's group predicate with t = s, on random rays, rays that graze a
  sphere at distance 1 +- a few ulps, and rays from far away (where the
  discriminant's rounding reaches past the unit radius).

Exact: a twin must never reject a hit pair (no tolerance).
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
    make_camera, primary_rays)
from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
    simple_arrays)
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_simple as M5
from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_blocks as TB
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    large_mesh_scene)
from tests.test_torch_gpu import sheet_scene, soup_scene

F32 = torch.float32
EPS = torch.tensor(0.01, dtype=F32)
BIG = torch.tensor(1e9, dtype=F32)
SLACK = torch.tensor(1.001, dtype=F32)
INF = torch.tensor(float("inf"), dtype=F32)


def t32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def slab(lo, hi, o, inv):
    """pt_device.cuh::slab: (tmin, tmax); a NaN axis is unconstrained."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    nan = torch.isnan(t0) | torch.isnan(t1)
    tn = torch.where(nan, -INF, torch.minimum(t0, t1))
    tf = torch.where(nan, INF, torch.maximum(t0, t1))
    tmin = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]), tn[..., 2])
    tmax = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]), tf[..., 2])
    return tmin, tmax


# ---------------------------------------------------------------- B2/B3


def box_closest(lo, hi, o, inv, bn, bd, neg_t):
    """mega_blocked.cu::box_closest."""
    tmin, tmax = slab(lo, hi, o, inv)
    hit = tmax >= tmin
    if not neg_t:
        hit = hit & (tmax >= EPS) & (
            torch.clamp_min(tmin, 0.0) * bd <= bn * SLACK)
    return hit


def box_occ(lo, hi, o, inv, tl, neg_t):
    """mega_blocked.cu::box_occ."""
    tmin, tmax = slab(lo, hi, o, inv)
    hit = tmax >= tmin
    if not neg_t:
        hit = hit & (tmax >= EPS) & (tmin <= tl * SLACK)
    return hit


def row_quads(rows, o, d):
    """pt_device.cuh::row_quads of rays (R, 3) x rows (N, 16): (dd, un_s,
    vn_s, tn_s), each (R, N)."""
    v0, e0, e2 = (rows[None, :, k:k + 3] for k in (0, 3, 6))
    ox, oy, oz = (o[:, None, k] for k in range(3))
    dx, dy, dz = (d[:, None, k] for k in range(3))
    e0x, e0y, e0z = e0[..., 0], e0[..., 1], e0[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e0x * pvx + e0y * pvy + e0z * pvz
    tvx, tvy, tvz = ox - v0[..., 0], oy - v0[..., 1], oz - v0[..., 2]
    un = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * e0z - tvz * e0y
    qvy = tvz * e0x - tvx * e0z
    qvz = tvx * e0y - tvy * e0x
    vn = dx * qvx + dy * qvy + dz * qvz
    tn = e2x * qvx + e2y * qvy + e2z * qvz
    sg = torch.where(det >= 0, 1.0, -1.0).to(F32)
    return det * sg, un * sg, vn * sg, tn * sg


def quads_valid(dd, un, vn, tn, neg_t):
    ok = (dd >= EPS) & (un >= 0) & (un <= dd) & (vn >= 0) & (un + vn <= dd)
    return ok if neg_t else ok & (tn > EPS * dd)


def tree_ancestors(nodes: np.ndarray, n_blocks: int):
    """For each block, the node indices of its macro leaf and of every
    internal node above it; checks the depth-first layout on the way."""
    ints = nodes[:, [3, 7]].view(np.int32)
    anc = [None] * n_blocks
    stack = []                                # (node, end)
    for i in range(nodes.shape[0]):
        while stack and stack[-1][1] <= i:
            stack.pop()
        a, first = ints[i]
        if first < 0:                          # internal: a = subtree end
            assert i < a <= nodes.shape[0]
            stack.append((i, a))
            continue
        for b in range(first, first + a):
            assert anc[b] is None              # every block once
            anc[b] = [i] + [s[0] for s in stack]
    assert all(x is not None for x in anc)
    return anc


def camera_rays(n_side: int, seed: int):
    """Jittered camera rays of an n_side^2 grid of the 512x512 frame."""
    g = torch.Generator().manual_seed(seed)
    step = 512 // n_side
    jj, ii = torch.meshgrid(torch.arange(n_side, dtype=F32) * step,
                            torch.arange(n_side, dtype=F32) * step,
                            indexing="ij")
    r = [torch.rand(n_side * n_side, generator=g) for _ in range(4)]
    return primary_rays(make_camera(z_sign=-1.0), ii.reshape(-1),
                        jj.reshape(-1), *r)


def walk_rays(scn, rows, boxes, seed=0):
    """Camera rays, shadow rays from their closest hits to each light,
    random rays through the mesh's box, and axis-parallel rays whose
    origin lies on a block box's plane."""
    g = np.random.default_rng(seed)
    o, d = camera_rays(32, seed)
    # and rays from around the camera aimed at random triangles
    real = rows[:, 12].view(torch.int32) >= 0
    tri = rows[real]
    cen = tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3.0
    pick = t32(g.integers(0, tri.shape[0], 1024)).long()
    ao = t32(np.asarray(make_camera(z_sign=-1.0).pos, np.float32)
             + g.normal(0.0, 3.0, (1024, 3)))
    ad = cen[pick] - ao
    o = torch.cat([o, ao])
    d = torch.cat([d, ad / ad.norm(dim=-1, keepdim=True)])
    dd, un, vn, tn = row_quads(rows, o, d)
    ok = quads_valid(dd, un, vn, tn, False)
    t = torch.where(ok, tn / torch.where(ok, dd, 1.0), INF).min(1).values
    hit = torch.isfinite(t)
    x = o[hit] + d[hit] * t[hit, None]
    rays = [(o, d)]
    for light in np.asarray(scn.lights, np.float32)[:, :3]:
        ld = t32(light) - x
        rays.append((x, ld / ld.norm(dim=-1, keepdim=True)))
    lo, hi = boxes[:, 0:3].min(0), boxes[:, 4:7].max(0)
    n = 512
    ro = t32(g.uniform(lo - 2.0, hi + 2.0, (n, 3)))
    rd = t32(g.normal(size=(n, 3)))
    rays.append((ro, rd / rd.norm(dim=-1, keepdim=True)))
    ax = []
    for b in g.choice(boxes.shape[0], 16):
        c = 0.5 * (boxes[b, 0:3] + boxes[b, 4:7])
        for k in range(3):
            oo = c.copy()
            oo[k] = boxes[b, k]                # on the lo plane
            oo[(k + 1) % 3] -= 5.0
            dv = np.zeros(3, np.float32)
            dv[(k + 1) % 3] = 1.0
            ax.append((oo, dv))
    rays.append((t32([a for a, _ in ax]), t32([b for _, b in ax])))
    return (torch.cat([r[0] for r in rays]).contiguous(),
            torch.cat([r[1] for r in rays]).contiguous())


SCENES = {"sheet_1800": lambda: sheet_scene(30, 30),
          "soup_axis_aligned": soup_scene,
          "sheet_9216_tree": lambda: large_mesh_scene(96, 48)}


@pytest.mark.parametrize("name", list(SCENES))
def test_walk_tables_nest(name):
    """Sub-blocks hold the block's rows in order and lie inside its box
    (padded by the block's own pad); blocks lie inside their macro leaf,
    leaves inside every node above them; the tree covers every block
    once."""
    scn = prep_scene(SCENES[name]())
    rows, boxes, subs, nodes = TB.walk_tables(scn)
    macros = TB._kernel_tables(TB._tri_blocks_ordered(scn))[2]
    nb = boxes.shape[0]
    assert subs.shape == (nb * 4, 8)
    count = subs[:, 3].view(np.int32).reshape(nb, 4)
    real = rows[:, 12].view(np.int32).reshape(nb, 4, 32) >= 0
    np.testing.assert_array_equal(count, real.sum(-1))
    assert (real.reshape(nb, 128)[:, :-1] >= real.reshape(nb, 128)[:, 1:]
            ).all()                            # real rows come first
    live = count > 0
    sb = np.repeat(boxes, 4, axis=0)[live.reshape(-1)]
    sl = subs[live.reshape(-1)]
    assert (sl[:, 0:3] >= sb[:, 0:3]).all() and (sl[:, 4:7] <= sb[:, 4:7]).all()
    # each sub-box holds its rows' triangles
    r = rows.reshape(nb * 4, 32, 16)[live.reshape(-1)]
    rr = real.reshape(nb * 4, 32)[live.reshape(-1)]
    for k in (0, 3, 6):
        p = r[..., 0:3] + (r[..., k:k + 3] if k else 0)
        assert ((p >= sl[:, None, 0:3]) | ~rr[..., None]).all()
        assert ((p <= sl[:, None, 4:7]) | ~rr[..., None]).all()
    anc = tree_ancestors(nodes, nb)
    for b in range(nb):
        for a in anc[b]:
            assert (boxes[b, 0:3] >= nodes[a, 0:3]).all()
            assert (boxes[b, 4:7] <= nodes[a, 4:7]).all()
    leaves = nodes[:, 7].view(np.int32) >= 0
    assert leaves.sum() == macros.shape[0]
    if name == "sheet_9216_tree":
        assert (~leaves).sum() > 0             # a level above the macros


@pytest.mark.parametrize("neg_t", [False, True], ids=["default", "neg_t"])
@pytest.mark.parametrize("name", list(SCENES))
def test_walk_cull_never_rejects_a_hit(name, neg_t):
    scn = prep_scene(SCENES[name]())
    rows, boxes, subs, nodes = TB.walk_tables(scn)
    nb = boxes.shape[0]
    anc = tree_ancestors(nodes, nb)
    o, d = walk_rays(scn, t32(rows), boxes)
    inv = torch.reciprocal(d)
    trows = t32(rows)
    real = torch.from_numpy(rows[:, 12].view(np.int32) >= 0)
    n_pairs = 0
    for c0 in range(0, o.shape[0], 256):
        oc, dc, ic = o[c0:c0 + 256], d[c0:c0 + 256], inv[c0:c0 + 256]
        dd, un, vn, tn = row_quads(trows, oc, dc)
        ok = quads_valid(dd, un, vn, tn, neg_t) & real[None]
        ray, row = torch.nonzero(ok, as_tuple=True)
        if not ray.numel():
            continue
        n_pairs += int(ray.numel())
        blk = row // 128
        sub = row // 32
        bn, bd = tn[ray, row], dd[ray, row]
        levels = [(t32(subs[sub.numpy(), 0:3]), t32(subs[sub.numpy(), 4:7])),
                  (t32(boxes[blk.numpy(), 0:3]),
                   t32(boxes[blk.numpy(), 4:7]))]
        depth = max(len(a) for a in anc)
        for lv in range(depth):
            ids = np.array([anc[b][min(lv, len(anc[b]) - 1)]
                            for b in blk.numpy()])
            levels.append((t32(nodes[ids, 0:3]), t32(nodes[ids, 4:7])))
        for lo, hi in levels:
            closest = box_closest(lo, hi, oc[ray], ic[ray], bn, bd, neg_t)
            assert bool(closest.all()), int((~closest).sum())
            occ = box_occ(lo, hi, oc[ray], ic[ray], BIG, neg_t)
            assert bool(occ.all()), int((~occ).sum())
    assert n_pairs > 1000


# ---------------------------------------------------------------- B5


def lane_pad(groups, o):
    """mega_simple.cu::make_cull's pad (the card's centre and half
    diagonal as the kernel computes them)."""
    lo, hi = t32(groups[0, 0:3]), t32(groups[0, 4:7])
    half = torch.tensor(0.5, dtype=F32)
    c = half * (lo + hi)
    e = hi - lo
    hd = half * torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) \
        * torch.tensor(1.001, dtype=F32)
    q = o - c
    P = torch.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]
                   + q[:, 2] * q[:, 2]) + hd
    E = torch.tensor(2e-6, dtype=F32) * (P * P + 1.0)
    return (torch.sqrt(1.0 + E) - 1.0) + torch.tensor(0.01, dtype=F32) \
        + torch.tensor(1e-5, dtype=F32) * P


def group_need(rec, o, d, pad, t):
    """mega_simple.cu::group_need for records ``rec`` (m, 8), rays (m, 3),
    pads and bounds (m,)."""
    lo = t32(rec[:, 0:3]) - pad[:, None]
    hi = t32(rec[:, 4:7]) + pad[:, None]
    tmin, tmax = slab(lo, hi, o, torch.reciprocal(d))
    return (tmax >= tmin) & (tmax >= 0) & (
        torch.clamp_min(tmin, 0.0) <= t * SLACK)


def sphere_hits(o, d, centers):
    """pt_device.cuh's sphere test, rays (R, 3) x spheres (S, 3): (hit, s)
    with hit = q > 0 and eps < s < kBig."""
    c = t32(centers)
    px = o[:, None, 0] - c[None, :, 0]
    py = o[:, None, 1] - c[None, :, 1]
    pz = o[:, None, 2] - c[None, :, 2]
    dx, dy, dz = (d[:, None, k] for k in range(3))
    b = px * dx + py * dy + pz * dz
    cc = px * px + py * py + pz * pz - 1.0
    q = b * b - cc
    s = -b - torch.sqrt(torch.clamp_min(q, 0.0))
    return (q > 0) & (s < BIG) & (s > EPS), s


def grazing_rays(centers, g, n, dist_range):
    """Rays passing a random sphere's centre at distance 1 +- up to 8 ulps,
    from dist_range away along the ray."""
    c = centers[g.integers(0, len(centers), n)].astype(np.float64)
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = np.cross(d, g.normal(size=(n, 3)))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    D = np.float32(1.0) + g.integers(-8, 9, n) * np.spacing(np.float32(1.0))
    L = g.uniform(*dist_range, n)
    o = c + w * D.astype(np.float64)[:, None] - d * L[:, None]
    return t32(o), t32(d)


def test_sphere_groups_cover_the_card():
    scn = simple_arrays()
    c = scn.sphere_centers
    recs = M5.sphere_groups(c)
    first = recs[:, 3].view(np.int32)
    count = recs[:, 7].view(np.int32)
    assert (first[0], count[0]) == (0, len(c))
    np.testing.assert_array_equal(first[1:], np.concatenate(
        [[0], np.cumsum(count[1:])[:-1]]))
    assert count[1:].sum() == len(c) and (count[1:] <= M5.MAX_GROUP).all()
    for r in recs[1:]:
        cs = c[r[3:4].view(np.int32)[0]:][:r[7:8].view(np.int32)[0]]
        assert (cs[:, 0] == cs[0, 0]).all()    # one column of the card
        np.testing.assert_array_equal(r[0:3], cs.min(0) - 1.0)
        np.testing.assert_array_equal(r[4:7], cs.max(0) + 1.0)
        assert (r[0:3] >= recs[0, 0:3]).all() and (r[4:7] <= recs[0, 4:7]).all()
    assert len(recs) - 1 < len(c)              # groups hold several spheres


@pytest.mark.parametrize("kind", ["random", "camera", "graze_near",
                                  "graze_far", "far_floor"])
def test_sphere_cull_never_rejects_a_hit(kind):
    scn = simple_arrays()
    centers = scn.sphere_centers
    recs = M5.sphere_groups(centers)
    g = np.random.default_rng(["random", "camera", "graze_near", "graze_far",
                               "far_floor"].index(kind))
    n = 4096
    if kind == "random":
        o = t32(g.uniform([-5, -5, -2], [25, 20, 18], (n, 3)))
        d = t32(g.normal(size=(n, 3)))
        d = d / d.norm(dim=-1, keepdim=True)
    elif kind == "camera":
        o, d = camera_rays(64, 3)
    elif kind == "graze_near":
        o, d = grazing_rays(centers, g, n, (1.5, 40.0))
    elif kind == "graze_far":
        o, d = grazing_rays(centers, g, n, (1e3, 1e5))
    else:                                      # shadow rays of far floor hits
        r = g.uniform(50.0, 1e6, n)
        a = g.uniform(0, 2 * np.pi, n)
        o = t32(np.stack([9 + r * np.cos(a), 9 + r * np.sin(a),
                          np.zeros(n)], -1))
        tgt = t32(g.uniform([-1, -1, 3], [19, 1, 13], (n, 3)))
        d = tgt - o
        d = d / d.norm(dim=-1, keepdim=True)
    hit, s = sphere_hits(o, d, centers)
    ray, sph = torch.nonzero(hit, as_tuple=True)
    assert ray.numel() > 50                    # not vacuous
    pad = lane_pad(recs, o)
    group = np.searchsorted(np.cumsum(recs[1:, 7].view(np.int32)),
                            sph.numpy(), side="right") + 1
    t = s[ray, sph]
    for rec in (np.repeat(recs[:1], len(group), 0), recs[group]):
        need = group_need(rec, o[ray], d[ray], pad[ray], t)
        assert bool(need.all()), int((~need).sum())
    # the cull is not vacuous either: some rays skip the card entirely
    card = group_need(np.repeat(recs[:1], n, 0), o, d, pad,
                      BIG.expand(n))
    if kind in ("random", "camera"):
        assert bool((~card).any())
