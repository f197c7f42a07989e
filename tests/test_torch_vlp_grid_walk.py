"""Kernels B2/B3 and kernel B4's walk route past 512 triangles, modelled
on the CPU: the exact uniform grid they walk (``ops/exact_grid.py``) and
the NumPy twin of the walk (``exact_grid.walk_twin``,
``csrc/pt_device.cuh::exact_walk``'s operations in their order) held to
the JAX package's brute force.

The brute force is the JAX package's own: on meshes below its matmul
route (2,048 triangles) ``ops/intersect.py``'s ``trace_ray`` and
``any_hit`` themselves, under ``jax.disable_jit()`` (compiled, XLA:CPU
contracts multiply-adds into FMAs); on the 20,736-triangle sheet, whose
JAX closest hit takes the matmul route, that function's division-free
scan: its per-pair ``_mt_quads_scalar``, run op by op over every
(ray, triangle) pair, and the fori loop's validity and strict-< running
minimum applied in index order.  The walk must give the same (t, index)
for every camera ray and the same any-hit bit at the light distance for
every shadow ray, bit for bit, under the default and the reference
quirks: the sheet's rows >= 384 (where the trianglegrid DDA's break rule
ends 3.0% of the walks before their hit), exact ties (duplicate
triangles, and two coplanar ones whose det-scaled distances tie exactly,
the higher index met first in an earlier cell), a fan of 96 triangles
through one cell (the reference grid keeps 62) and rays from outside
and inside the grid.  B2/B3's two shadow modes are held the same way on
the sheet, the tie mesh and the fan, toward the benchmark's two lights:
the uncapped any hit, and under ``shadow_carry_t`` the closest hit from
a carried distance.  The build is held to the JAX package's NumPy
``build_grid_host`` with its cap at the true occupancy (the same pairs).
The card's own checks are in ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.ops import grid as JG
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
    make_camera, primary_rays)
from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
from opencl_montecarlo_path_tracing_tpu_torch.ops import exact_grid as X
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
    _tri_table, prep_scene)
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    large_mesh_scene)
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene

F = np.float32
EPS = F(0.01)
BIG = F(1e9)


def camera_rays(rows, n, seed=0):
    """(o, d) float32 of ``n`` random pixels of the 512 x 512 frame in
    ``rows`` (a range), sample 1 of 4."""
    g = np.random.default_rng(seed)
    ii = g.integers(0, 512, n)
    jj = g.integers(rows.start, rows.stop, n)
    ray_id = torch.from_numpy((jj * 512 + ii) * 4 + 1)
    r = R.randn_draws((3, 7), ray_id, C.SITE_CAMERA, 4)
    o, d = primary_rays(make_camera(z_sign=-1.0),
                        torch.from_numpy(ii.astype(F)),
                        torch.from_numpy(jj.astype(F)), *r)
    return o.numpy().astype(F), d.numpy().astype(F)


def shadow_rays(o, d, t, lights, seed=1):
    """From each hit o + d t to each light, jittered in x and y as the
    kernel's shadow rays are: (origins, unit directions, the un-jittered
    light distances)."""
    g = np.random.default_rng(seed)
    x = (o + d * t[:, None]).astype(F)
    so, sd, tl = [], [], []
    for light in lights:
        jit = np.concatenate([g.random((len(x), 2)), np.zeros((len(x), 1))],
                             1).astype(F)
        v = (light[:3] + jit - x).astype(F)
        so.append(x)
        sd.append(v / np.sqrt((v * v).sum(1, keepdims=True)))
        q = (light[:3] - x).astype(F)
        tl.append(np.sqrt((q * q).sum(1)))
    return (np.concatenate(so).astype(F), np.concatenate(sd).astype(F),
            np.concatenate(tl).astype(F))


def jax_quads(o, d, table, chunk=192):
    """The JAX package's ``_mt_quads_scalar`` for every (ray, triangle)
    pair, op by op, sign-adjusted as trace_ray's fori body does it:
    (dd, un_s, vn_s, tn_s) as (rays, triangles) float32 arrays."""
    rows = jnp.asarray(table.T)
    out = []
    with jax.disable_jit():
        for c in range(0, len(o), chunk):
            oc, dc = o[c:c + chunk], d[c:c + chunk]
            args = [jnp.asarray(a[:, None]) for a in
                    (oc[:, 0], oc[:, 1], oc[:, 2], dc[:, 0], dc[:, 1],
                     dc[:, 2])]
            det, un, vn, tn = (np.asarray(a) for a in
                               JI._mt_quads_scalar(*args, rows))
            sg = np.where(det >= 0, F(1), F(-1))
            out.append((det * sg, un * sg, vn * sg, tn * sg))
    return tuple(np.concatenate(a) for a in zip(*out))


def jax_valid(dd, un, vn, tn, neg_t):
    ok = ((dd >= EPS) & (un >= 0) & (un <= dd) & (vn >= 0)
          & (un + vn <= dd))
    return ok if neg_t else ok & (tn > EPS * dd)


def brute_closest(quads, neg_t, bn0=BIG):
    """trace_ray's triangle scan: the strict-< det-scaled running minimum
    in index order from (bn0, 1); only valid pairs can update it, so the
    scan runs over them.  Returns (t, index) (index -1: no triangle)."""
    dd, un, vn, tn = quads
    ok = jax_valid(dd, un, vn, tn, neg_t)
    n = dd.shape[0]
    bn = np.broadcast_to(np.asarray(bn0, F), (n,)).copy()
    bd = np.ones(n, F)
    bi = np.full(n, -1, np.int64)
    for r, i in zip(*np.nonzero(ok)):   # row-major: index order a ray
        if tn[r, i] * bd[r] < bn[r] * dd[r, i]:
            bn[r], bd[r], bi[r] = tn[r, i], dd[r, i], i
    return bn / bd, bi


def brute_any(quads, neg_t, tl):
    dd, un, vn, tn = quads
    return (jax_valid(dd, un, vn, tn, neg_t)
            & (tn < tl[:, None] * dd)).any(axis=1)


def twin(scn, o, d, neg_t, t_limit=None, bn0=None, **grid_kw):
    tab = X.walk_tables(X.build_exact_grid(scn, "cpu", **grid_kw))
    out, tally = X.walk_twin(o, d, tab, neg_t, t_limit=t_limit, bn0=bn0)
    if t_limit is not None:
        return out, tally
    bn, bd, bi = out
    return (bn / bd, bi), tally


@pytest.fixture(scope="module")
def sheet():
    """The 20,736-triangle sheet, 2,304 camera rays (1,280 of them in rows
    384-511) and the brute force's quads for them."""
    scn = prep_scene(large_mesh_scene())
    o1, d1 = camera_rays(range(0, 384), 1024)
    o2, d2 = camera_rays(range(384, 512), 1280, seed=2)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    return scn, o, d, jax_quads(o, d, _tri_table(scn))


@pytest.mark.parametrize("neg_t", [False, True],
                         ids=["default", "reference"])
def test_camera_walks_equal_the_brute_force_on_the_sheet(sheet, neg_t):
    """Every camera ray's (t, index) from the exact walk equals the JAX
    brute force's on the 20,736 sheet, bit for bit; a walk visits ~30
    cells and tests ~35 pairs against the sheet's 20,736."""
    scn, o, d, quads = sheet
    (t, i), tally = twin(scn, o, d, neg_t)
    bt, bi = brute_closest(quads, neg_t)
    assert (bi >= 0).mean() > 0.99
    np.testing.assert_array_equal(i, bi)
    np.testing.assert_array_equal(t, bt)
    assert 0 < tally["pairs"].mean() < 100 and tally["cells"].mean() < 200


@pytest.mark.parametrize("neg_t", [False, True],
                         ids=["default", "reference"])
def test_shadow_walks_equal_the_brute_force_on_the_sheet(sheet, neg_t):
    """Each light's jittered shadow ray from the camera rays' hits: the
    walk's any-hit bit at the un-jittered light distance equals the brute
    force's, with occluded and open rays both present."""
    scn, o, d, quads = sheet
    bt, bi = brute_closest(quads, False)
    keep = bi >= 0
    so, sd, tl = shadow_rays(o[keep][::3], d[keep][::3], bt[keep][::3],
                             scn.lights)
    occ, tally = twin(scn, so, sd, neg_t, t_limit=tl)
    want = brute_any(jax_quads(so, sd, _tri_table(scn)), neg_t, tl)
    np.testing.assert_array_equal(occ, want)
    assert 0 < want.mean() < 1 or neg_t
    assert (tally["pairs"] > 0).all()


def tie_mesh() -> np.ndarray:
    """Exact ties: a 6 x 4 ripple sheet's 48 triangles, each again at
    index + 50 with the same rows; and at indices 48-49 two coplanar
    triangles of the plane z = x + 8 whose det-scaled distances tie
    exactly on rays along -z (the large one, index 49, reaches the
    higher cells the rays cross first)."""
    base = large_mesh_scene(6, 4).triangles.astype(F)
    big = np.array([[0, 0, 8], [4, 0, 12], [0, 4, 8]], F)
    small = np.array([[1, 1, 9], [2, 1, 10], [1, 2, 9]], F)
    return np.concatenate([base, small[None], big[None], base])


def fan_mesh() -> np.ndarray:
    """96 triangles fanned around one vertex (each a little higher than
    the last), all through the cell that holds it, and a 6 x 4 sheet."""
    c = np.array([2.0, 3.0, 6.0], F)
    a = np.linspace(0, 2 * np.pi, 97)
    tris = [[c, c + [2 * np.cos(a[k]), 2 * np.sin(a[k]), 0.01 * k],
             c + [2 * np.cos(a[k + 1]), 2 * np.sin(a[k + 1]), 0.01 * k]]
            for k in range(96)]
    return np.concatenate([np.asarray(tris, F),
                           large_mesh_scene(6, 4).triangles.astype(F)])


def mesh_scene(tris) -> Scene:
    return Scene(sphere_centers=np.zeros((0, 3), F),
                 square_kj=np.zeros((0, 2), F), triangles=tris,
                 lights=np.array([[-3.0, 2.0, 30.0, 200.0]], F))


def hard_rays(scn, seed=3):
    """Rays of every kind on a mesh (128 each): from above along -z onto
    the tie pair's small triangle (the first 64) and the region of the
    duplicated sheet, onto the fan (near its centre, then across it),
    camera rays (256), rays from outside the grid's box aimed into it,
    and rays from inside it in random directions."""
    g = np.random.default_rng(seed)
    n = 128
    down = np.zeros((2 * n, 3), F)
    down[:, 2] = -1
    uv = g.random((n // 2, 2))
    uv = np.where(uv.sum(1, keepdims=True) > 1, 1 - uv, uv)
    top = np.concatenate([1 + uv, g.uniform(0.5, 3.5, (n // 2, 2))])
    fan = np.concatenate([g.uniform(-0.15, 0.15, (n // 2, 2)),
                          g.uniform(-1.4, 1.4, (n // 2, 2))]) + [2.0, 3.0]
    o_down = np.concatenate([np.concatenate([top, fan]),
                             np.full((2 * n, 1), 20.0)], 1)
    oc, dc = camera_rays(range(0, 512), 2 * n, seed)
    v = np.concatenate([scn.tri_v0, scn.tri_v0 + scn.tri_e0])
    lo, hi = v.min(0), v.max(0)
    aim = lo + g.random((n, 3)) * (hi - lo)
    u = g.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o_out = aim + u * 1.5 * np.linalg.norm(hi - lo)
    o_in = lo + g.random((n, 3)) * (hi - lo)
    o = np.concatenate([o_down, oc, o_out, o_in]).astype(F)
    d = np.concatenate([down, dc, -u, g.normal(size=(n, 3))]).astype(F)
    d = (d / np.sqrt((d * d).sum(1, keepdims=True))).astype(F)
    return o, d


def j_scene(tris):
    s = mesh_scene(tris)
    return JI.prep_scene(JScene(sphere_centers=s.sphere_centers,
                                square_kj=s.square_kj, triangles=s.triangles,
                                lights=s.lights))


@pytest.mark.parametrize("neg_t", [False, True],
                         ids=["default", "reference"])
@pytest.mark.parametrize("mesh", ["ties", "fan"])
def test_walk_equals_jax_trace_ray_on_hard_meshes(mesh, neg_t):
    """On the tie mesh and the fan (fewer than 2,048 triangles: the JAX
    package's ``trace_ray`` and ``any_hit`` run their own division-free
    scans, op by op), from the floor's running distance: the walk's t is
    trace_ray's bit for bit, its index the one whose normal trace_ray
    returns, the exact ties go to the lower index, and the any-hit bit at
    a capped distance is any_hit's."""
    from opencl_montecarlo_path_tracing_tpu.core.quirks import (
        DEFAULT as JD, REFERENCE as JR)
    tris = tie_mesh() if mesh == "ties" else fan_mesh()
    scn = prep_scene(mesh_scene(tris))
    jscn = j_scene(tris)
    o, d = hard_rays(scn)
    q = JR if neg_t else JD
    with jax.disable_jit():
        floor = JI.trace_ray(jnp.asarray(o), jnp.asarray(d), jscn, quirks=q,
                             triangles=False)
        full = JI.trace_ray(jnp.asarray(o), jnp.asarray(d), jscn, quirks=q)
    t0 = np.asarray(floor.t)
    (t, i), tally = twin(scn, o, d, neg_t, bn0=t0, modifier=24.0)
    np.testing.assert_array_equal(t, np.asarray(full.t))
    mat = np.asarray(full.material)
    np.testing.assert_array_equal(i >= 0, mat == 4)
    np.testing.assert_array_equal(scn.tri_n[i[i >= 0]],
                                  np.asarray(full.normal)[i >= 0])
    assert (i >= 0).sum() > 200
    bt, bi = brute_closest(jax_quads(o, d, _tri_table(scn)), neg_t, t0)
    np.testing.assert_array_equal(i, bi)
    if mesh == "ties":
        # the first 64 rays cross the tie pair: the lower index, 48, wins
        # though the walk meets 49 first
        assert (i[:64] == 48).all()
        dup = (i >= 0) & (i != 48) & (i != 49)
        assert dup.sum() > 50 and (i[dup] < 48).all()
    else:
        assert np.isin(i[128:256], np.arange(96)).mean() > 0.9
        assert (i[128:256] >= 62).any()
    # caps just past the closest hit (even rays) and just short of it
    scale = np.where(np.arange(len(t)) % 2, F(0.999), F(1.001))
    tl = np.minimum(t * scale, F(50)).astype(F)
    occ, _ = twin(scn, o, d, neg_t, t_limit=tl, modifier=24.0)
    with jax.disable_jit():
        want = JI.any_hit(jnp.asarray(o), jnp.asarray(d), jscn,
                          t_limit=jnp.asarray(tl), quirks=q)
        w_floor = JI.any_hit(jnp.asarray(o), jnp.asarray(d), jscn,
                             t_limit=jnp.asarray(tl), quirks=q,
                             triangles=False)
    # any_hit also counts the floor: the walk's bit or the floor's
    np.testing.assert_array_equal(occ | np.asarray(w_floor),
                                  np.asarray(want))


#: The benchmark's two point lights (``benchmark/configs/*.json``: the
#: upstream super scene's), which kernel B2/B3's shadow rays aim at.
BENCH_LIGHTS = np.array([[10, 4, 10, 200], [15, 2, 7, 150]], F)


@pytest.fixture(scope="module")
def b23_shadows(sheet):
    """B2/B3's shadow rays on a mesh ("sheet", "ties" or "fan"), made once
    a mesh: from the closest hits of its camera rays (the sheet's) or of
    ``hard_rays`` toward each of ``BENCH_LIGHTS``, jittered as the
    kernel's are; returns (scene, origins, directions, the brute force's
    quads for them, the carried distance of each: its camera ray's hit
    distance, cut to a twentieth on every third ray)."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            if mesh == "sheet":
                scn, o, d, quads = sheet
                o, d, quads = o[::3], d[::3], tuple(q[::3] for q in quads)
            else:
                tris = tie_mesh() if mesh == "ties" else fan_mesh()
                scn = prep_scene(mesh_scene(tris))
                o, d = hard_rays(scn)
                quads = jax_quads(o, d, _tri_table(scn))
            t, i = brute_closest(quads, False)
            keep = i >= 0
            so, sd, _ = shadow_rays(o[keep], d[keep], t[keep], BENCH_LIGHTS)
            carried = np.tile(t[keep], len(BENCH_LIGHTS))
            carried[::3] *= F(0.05)
            cache[mesh] = (scn, so, sd, jax_quads(so, sd, _tri_table(scn)),
                           carried.astype(F))
        return cache[mesh]
    return get


@pytest.mark.parametrize("neg_t", [False, True],
                         ids=["default", "reference"])
@pytest.mark.parametrize("mesh", ["sheet", "ties", "fan"])
def test_uncapped_shadow_walks_equal_the_brute_force(b23_shadows, mesh,
                                                     neg_t):
    """B2/B3's shadow rays without ``shadow_carry_t``: the uncapped any
    hit (t_limit 1e9, ``occluded(..., kBig, ...)``) toward the
    benchmark's lights.  The walk's occlusion bit is the brute force's for
    every ray, some rays are occluded, and an open ray's walk runs on
    until it leaves the grid (no cap ends it)."""
    scn, so, sd, quads, _ = b23_shadows(mesh)
    occ, tally = twin(scn, so, sd, neg_t, t_limit=BIG,
                      **({} if mesh == "sheet" else dict(modifier=24.0)))
    want = brute_any(quads, neg_t, np.full(len(so), BIG))
    np.testing.assert_array_equal(occ, want)
    assert want.any()
    if not want.all():
        assert tally["cells"][~want].mean() >= tally["cells"][want].mean()


@pytest.mark.parametrize("neg_t", [False, True],
                         ids=["default", "reference"])
@pytest.mark.parametrize("mesh", ["sheet", "ties", "fan"])
def test_carried_shadow_walks_equal_the_brute_force(b23_shadows, mesh,
                                                    neg_t):
    """B2/B3's shadow rays under ``shadow_carry_t``: a closest-hit walk
    from the carried distance (the running t the previous trace left).
    The walk's (t, index) is the brute force's scan from the same
    distance, bit for bit; a triangle before the carried distance wins on
    some rays, none on others (t stays the carried one, also where a
    triangle lies beyond it), and exact ties go to the lower index."""
    scn, so, sd, quads, carried = b23_shadows(mesh)
    (t, i), tally = twin(scn, so, sd, neg_t, bn0=carried,
                         **({} if mesh == "sheet" else dict(modifier=24.0)))
    bt, bi = brute_closest(quads, neg_t, carried)
    np.testing.assert_array_equal(i, bi)
    np.testing.assert_array_equal(t, bt)
    assert (i >= 0).any()
    np.testing.assert_array_equal(t[i < 0], carried[i < 0])
    # rays whose triangle lies past the carried distance keep it
    beyond = brute_any(quads, neg_t, np.full(len(so), BIG)) & (i < 0)
    assert beyond.any() or neg_t
    if mesh == "sheet":
        # the cull engages: a walk tests a few dozen of 20,736 triangles
        assert tally["pairs"].mean() < 100


def test_rays_from_outside_enter_and_miss_as_the_brute_force():
    """Rays that start outside the grid's box (aimed into it, and the
    same rays turned away from it) and rays along grid planes with a zero
    component: the walk's hits are the brute force's, and a ray that
    misses the box visits no cell."""
    scn = prep_scene(mesh_scene(large_mesh_scene(30, 30).triangles))
    o, d = hard_rays(scn, seed=9)
    o, d = o[512:640], d[512:640]   # the outside rays
    g = X.build_exact_grid(scn, "cpu")
    fr = g.frame.numpy()
    ax = np.arange(len(o)) % 3
    planes = o.copy()
    # even rays on the box's face (the slab meets 0 * inf), odd ones on
    # an inner grid plane
    planes[np.arange(len(o)), ax] = np.where(
        np.arange(len(o)) % 2, fr[ax] + fr[6 + ax] * 3, fr[ax])
    dz = d.copy()
    dz[np.arange(len(o)), ax] = 0.0
    dz = (dz / np.sqrt((dz * dz).sum(1, keepdims=True))).astype(F)
    oo = np.concatenate([o, o, planes]).astype(F)
    dd = np.concatenate([d, -d, dz]).astype(F)
    quads = jax_quads(oo, dd, _tri_table(scn))
    (t, i), tally = twin(scn, oo, dd, False)
    bt, bi = brute_closest(quads, False)
    np.testing.assert_array_equal(i, bi)
    np.testing.assert_array_equal(t, bt)
    assert (i[:128] >= 0).sum() > 64
    assert (bi[128:256] < 0).all() and (tally["cells"][128:256] == 0).all()


@pytest.mark.parametrize("mesh", ["sheet", "fan"])
def test_grid_pairs_equal_the_jax_host_build(mesh):
    """The device build's pairs (each cell's triangles in ascending index)
    are the JAX package's NumPy ``build_grid_host``'s on the same frame
    with its cap at the true occupancy; every row is its triangle's, and
    the bitmap marks exactly the cells with pairs.  The fan's centre cell
    holds all 96 of its triangles, past the reference's cap of 62."""
    tris = (large_mesh_scene(72, 36).triangles if mesh == "sheet"
            else fan_mesh())
    scn = prep_scene(mesh_scene(tris))
    g = X.build_exact_grid(scn, "cpu")
    fr = g.frame.numpy()
    vmin, cell = fr[0:3], fr[6:9]
    tab = _tri_table(scn)
    amin, amax = (a.numpy() for a in X.triangle_boxes(torch.from_numpy(tab)))
    counts = g.span[:, 1].numpy()
    jg = JG.build_grid_host(amin, amax, vmin, cell, g.res,
                            cap=int(counts.max()))
    np.testing.assert_array_equal(np.asarray(jg.counts), counts)
    items = np.asarray(jg.items)
    slot = np.arange(items.shape[1])
    want = items[slot[None, :] < counts[:, None]]
    np.testing.assert_array_equal(g.ids.numpy(), want)
    np.testing.assert_array_equal(g.rows.numpy(), tab[want])
    first = np.cumsum(counts) - counts
    np.testing.assert_array_equal(g.span[:, 0].numpy(), first)
    bits = np.unpackbits(g.occ.numpy().view(np.uint8),
                         bitorder="little")[:counts.size]
    np.testing.assert_array_equal(bits.astype(bool), counts > 0)
    if mesh == "fan":
        assert counts.max() >= 96
    # the frame's far corner covers every triangle
    assert (fr[3:6] >= amax.max(0)).all() and (vmin <= amin.min(0)).all()


def test_walk_route_inputs_are_the_exact_grid():
    """``kernel_inputs(walk=True)`` returns the exact grid's tables (the
    cached ``ExactGrid``), and the route is decided by the mesh's size
    before any launch."""
    scn = prep_scene(large_mesh_scene(30, 30))
    assert M.uses_walk(scn)
    buf, ntp, boxes, xg = M.kernel_inputs(scn, "cpu", walk=True)
    assert xg is X.exact_grid(scn, "cpu") and ntp == 0 and boxes is None
    assert xg.rows.dtype == torch.float32 and xg.ids.dtype == torch.int32
    assert X.table_bytes(xg) == sum(
        a.numel() * a.element_size()
        for a in (xg.frame, xg.occ, xg.span, xg.rows, xg.ids))


@pytest.mark.parametrize("bad", ["dtype", "size", "device"])
def test_check_tables_refuses_tables_the_walk_cannot_read(bad):
    """Both launchers pass the grid's pointers to the kernel unchecked, so
    ``check_tables`` accepts the cached grid and refuses a table of the
    wrong dtype, size or device before any launch."""
    scn = prep_scene(large_mesh_scene(30, 30))
    xg = X.exact_grid(scn, "cpu")
    X.check_tables(xg, torch.device("cpu"))
    broken = {"dtype": xg._replace(ids=xg.ids.to(torch.int64)),
              "size": xg._replace(span=xg.span[:-1]),
              "device": xg._replace(frame=xg.frame.to("meta"))}[bad]
    with pytest.raises(ValueError, match="grid"):
        X.check_tables(broken, torch.device("cpu"))
