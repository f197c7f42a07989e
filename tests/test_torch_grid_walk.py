"""Kernels B11 / B11w's walk, modelled on the CPU: a NumPy float32 twin of
``csrc/pt_device.cuh::grid_closest`` (and ``grid_occluded``) held bit for
bit to the port's plain walk (``ops/grid.py::traverse_triangles``) and,
through ``convert.grid_from_numpy``, to the JAX package's walk on its own
grid; the route of ``models/trianglegrid.py``; the grid's packed frame and
its cache.

The twin follows the kernel's control flow, not the plain walk's: a ray
leaves the loop when it stops (the plain walk keeps it as an inactive
lane), each cell's slots run only up to its count, min / max propagate NaN
in the kernel's own form, and the loop runs at most rx + ry + rz + 2 steps.
All three compute each float32 operation once, in the same order, so the
comparisons are exact (``np.array_equal``).  The JAX walk runs under
``jax.disable_jit()``: compiled, XLA:CPU contracts multiply-adds into FMAs
(``tests/test_torch_trianglegrid.py`` holds the compiled walk to rtol
1e-5).  The cards' own checks are in ``tests/test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT as J_DEFAULT, REFERENCE as J_REFERENCE)
from opencl_montecarlo_path_tracing_tpu.ops import grid as JG
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
from opencl_montecarlo_path_tracing_tpu_torch.convert import grid_from_numpy
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE)
from opencl_montecarlo_path_tracing_tpu_torch.models import trianglegrid as TG
from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
from opencl_montecarlo_path_tracing_tpu_torch.ops import intersect as TI
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
    _tri_table)
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from tests.test_torch_gpu import (
    GRID_KINDS, GRID_SCENES, grid_rays, grid_state as seeded_state,
    sheet_scene, window_torus)

F = np.float32
EPS = F(0.01)
BIG = F(1e9)


# ---------------------------------------------------------------------------
# the twin


def min_nan(a, b):
    """pt_device.cuh::min_nan: a if a is NaN, else b if b is NaN, else
    fminf."""
    return np.where(a != a, a, np.where(b != b, b, np.fmin(a, b)))


def max_nan(a, b):
    return np.where(a != a, a, np.where(b != b, b, np.fmax(a, b)))


def mt_div(r, o, d, neg_t):
    """pt_device.cuh::mt_div on rows ``r`` (n, 12) and rays (n, 3):
    (ok, rd)."""
    v0, e0, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    pvx = dy * e2[:, 2] - dz * e2[:, 1]
    pvy = dz * e2[:, 0] - dx * e2[:, 2]
    pvz = dx * e2[:, 1] - dy * e2[:, 0]
    det = e0[:, 0] * pvx + e0[:, 1] * pvy + e0[:, 2] * pvz
    ok = np.abs(det) >= EPS
    inv = F(1) / np.where(ok, det, F(1))
    tv = o - v0
    u = (tv[:, 0] * pvx + tv[:, 1] * pvy + tv[:, 2] * pvz) * inv
    ok &= (u >= 0) & (u <= 1)
    qvx = tv[:, 1] * e0[:, 2] - tv[:, 2] * e0[:, 1]
    qvy = tv[:, 2] * e0[:, 0] - tv[:, 0] * e0[:, 2]
    qvz = tv[:, 0] * e0[:, 1] - tv[:, 1] * e0[:, 0]
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    ok &= (v >= 0) & (u + v <= 1)
    rd = (e2[:, 0] * qvx + e2[:, 1] * qvy + e2[:, 2] * qvz) * inv
    if not neg_t:
        ok &= rd > EPS
    return ok, rd


def walk_twin(o, d, t, m, n, needs, grid, table, neg_t, any_hit=False):
    """grid_closest (or, with ``any_hit``, grid_occluded from t = t_limit)
    for every ray: the DDA set-up, then the step loop, each ray leaving it
    when it stops.  Returns the updated (t, m, n, needs) copies (any_hit:
    the occlusion booleans) and the tally (entered, cells, pairs)."""
    o, d = o.astype(F), d.astype(F)
    t, m, n, needs = t.copy(), m.copy(), n.copy(), needs.copy()
    items, counts = grid.items.numpy(), grid.counts.numpy()
    frame = G.grid_frame(grid).numpy()
    vmin, vmax, cs = frame[0:3], frame[3:6], frame[6:9]
    res = np.asarray(grid.res, np.int64)
    res_f = res.astype(F)
    with np.errstate(all="ignore"):
        inv = F(1) / d
        a, b = (vmin - o) * inv, (vmax - o) * inv
        e0, e1 = min_nan(a, b), max_nan(a, b)
        t0 = max_nan(max_nan(e0[:, 0], e0[:, 1]), e0[:, 2])
        t1 = min_nan(min_nan(e1[:, 0], e1[:, 1]), e1[:, 2])
    alive = t0 <= t1
    occ = np.zeros(len(o), bool)
    tally = {"entered": int(alive.sum()), "cells": 0, "pairs": 0}
    rays = np.nonzero(alive)[0]
    oa, da, t0a = o[rays], d[rays], t0[rays]
    inside = ((oa >= vmin) & (oa <= vmax)).all(axis=1)
    p = np.where(inside[:, None], oa, oa + da * t0a[:, None])
    with np.errstate(all="ignore"):
        c = np.floor((p - vmin) / cs)
    # the float -> int cast of a NaN or inf only meets a 1-cell axis
    c = np.where(np.isfinite(c), c, 0).astype(np.int64)
    idx = np.clip(c, 0, res - 1)
    e0a, e1a = e0[rays], e1[rays]
    dl = (e1a - e0a) / res_f
    pos = da > 0
    with np.errstate(all="ignore"):
        nxt = np.where(pos, e0a + (idx + 1).astype(F) * dl,
                       e0a + res_f * dl - idx.astype(F) * dl)
    step = np.where(pos, 1, -1)
    stop = np.where(pos, res, -1)
    tt = t if not any_hit else np.full(len(o), BIG, F)
    plane, ncells = res[0] * res[1], res[0] * res[1] * res[2]
    live = np.ones(len(rays), bool)
    for _ in range(int(res.sum()) + 2):
        if not live.any():
            break
        k_live = np.nonzero(live)[0]
        ray = rays[k_live]
        ix = idx[k_live]
        cell = np.clip(ix[:, 2] * plane + ix[:, 1] * res[0] + ix[:, 0], 0,
                       ncells - 1)
        cnt = counts[cell]
        tally["cells"] += len(k_live)
        for k in range(int(cnt.max(initial=0))):
            sel = (k < cnt) & (items[cell, np.minimum(k, items.shape[1] - 1)]
                               >= 0)
            if any_hit:
                sel &= ~occ[ray]
            if not sel.any():
                continue
            rr = ray[sel]
            tri = items[cell[sel], k]
            tally["pairs"] += int(sel.sum())
            with np.errstate(all="ignore"):
                ok, rd = mt_div(table[tri], o[rr], d[rr], neg_t)
            hit = ok & (rd < tt[rr])
            h = rr[hit]
            if any_hit:
                occ[h] = True
                continue
            t[h] = rd[hit]
            m[h] = 4
            n[h] = table[tri[hit], 9:12]
            needs[h] = False
        if any_hit:      # a walk ends at its first hit
            done = occ[ray]
            live[k_live[done]] = False
            k_live, ray, ix = k_live[~done], ray[~done], ix[~done]
        nx = nxt[k_live]
        selx = (nx[:, 0] <= nx[:, 1]) & (nx[:, 0] <= nx[:, 2])
        sely = ~selx & (nx[:, 1] <= nx[:, 2])
        ax = np.where(selx, 0, np.where(sely, 1, 2))
        j = np.arange(len(k_live))
        with np.errstate(all="ignore"):
            nx[j, ax] = nx[j, ax] + dl[k_live, ax]
        nxt[k_live] = nx
        go = ~(tt[ray] < nx[j, ax])
        ix = ix.copy()
        ix[j, ax] += np.where(go, step[k_live, ax], 0)
        idx[k_live] = ix
        live[k_live] = go & (ix[j, ax] != stop[k_live, ax])
    if any_hit:
        return occ, tally
    return (t, m, n, needs), tally


# ---------------------------------------------------------------------------
# the cases (their rays: tests/test_torch_gpu.py::grid_rays)


def j_scene(scene: Scene) -> JScene:
    return JScene(scene.sphere_centers, scene.square_kj, scene.triangles,
                  scene.lights)


SCENES = GRID_SCENES
KINDS = GRID_KINDS


@functools.lru_cache(maxsize=None)
def setup(name):
    """(scene, prepared scene, the JAX grid, the port's copy of it)."""
    scene = SCENES[name]()
    scn = TI.prep_scene(scene)
    jgrid, _ = JG.triangle_grid(JI.prep_scene(j_scene(scene)), modifier=3.0,
                                device=False)
    return scene, scn, jgrid, grid_from_numpy(jgrid)


def rays(name, kind):
    _, scn, _, grid = setup(name)
    return grid_rays(name, kind, scn, grid)


def port_plain(o, d, t, m, nrm, needs, scn, grid, quirks):
    out = G.traverse_triangles(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
        torch.from_numpy(m), *(torch.from_numpy(np.ascontiguousarray(c))
                               for c in nrm.T),
        torch.from_numpy(needs), scn, grid, quirks)
    t2, m2, nx, ny, nz, nd = (x.numpy() for x in out)
    return t2, m2, np.stack([nx, ny, nz], 1), nd


def jax_walk(o, d, t, m, nrm, needs, name, quirks):
    _, _, jgrid, _ = setup(name)
    jscn = JI.prep_scene(j_scene(setup(name)[0]))
    jgrid = jgrid._replace(items=jnp.asarray(jgrid.items),
                           counts=jnp.asarray(jgrid.counts),
                           vmin=jnp.asarray(jgrid.vmin),
                           cell_size=jnp.asarray(jgrid.cell_size))
    with jax.disable_jit():
        out = JG.traverse_triangles(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(m),
            jnp.asarray(nrm[:, 0]), jnp.asarray(nrm[:, 1]),
            jnp.asarray(nrm[:, 2]), jnp.asarray(needs), jscn, jgrid, quirks)
    t2, m2, nx, ny, nz, nd = (np.asarray(x) for x in out)
    return t2, m2, np.stack([nx, ny, nz], 1), nd


def assert_same(a, b, what):
    for name, x, y in zip(("t", "m", "normal", "needs"), a, b):
        assert x.dtype == y.dtype or name == "m", (what, name)
        assert np.array_equal(x, y, equal_nan=True), (
            what, name, int((x != y).sum()))


@pytest.mark.parametrize("qname", ["default", "reference"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(SCENES))
def test_twin_equals_plain_walk(name, kind, qname):
    """The twin == traverse_triangles' plain walk on the CPU, bit for bit,
    on every ray of the case; the case really walks (hits, and for the
    planes case NaN-inactive rays beside walking ones)."""
    _, scn, _, grid = setup(name)
    o, d, t = rays(name, kind)
    m, nrm, needs = seeded_state(len(o))
    quirks = {"default": DEFAULT, "reference": REFERENCE}[qname]
    table = _tri_table(scn)
    (tw, mw, nw, dw), tally = walk_twin(o, d, t, m, nrm, needs, grid, table,
                                        quirks.accept_negative_t)
    assert_same((tw, mw, nw, dw),
                port_plain(o, d, t, m, nrm, needs, scn, grid, quirks),
                f"{name} {kind} {qname}: twin vs plain")
    assert tally["pairs"] > 0 and 0 < tally["entered"] <= len(o)
    if kind in ("camera", "short", "inside"):
        assert (mw == 4).sum() > 0.05 * len(o)
    if kind == "planes":
        assert tally["entered"] < len(o)        # the faces' NaN slabs


@pytest.mark.parametrize("name, kind, qname", [
    ("torus", "camera", "default"), ("sheet", "shadow", "reference"),
    ("sheet", "planes", "default")])
def test_twin_equals_jax_walk(name, kind, qname):
    """The twin == the JAX package's walk (op by op, ``disable_jit``: 4-9 s
    a case) on its own grid carried over by ``grid_from_numpy``, bit for
    bit: camera rays, shadow rays under the reference's negative-t quirk,
    and the axis-parallel rays on grid planes."""
    _, scn, _, grid = setup(name)
    o, d, t = rays(name, kind)
    m, nrm, needs = seeded_state(len(o), seed=4)
    quirks, jq = {"default": (DEFAULT, J_DEFAULT),
                  "reference": (REFERENCE, J_REFERENCE)}[qname]
    twin, _ = walk_twin(o, d, t, m, nrm, needs, grid, _tri_table(scn),
                        quirks.accept_negative_t)
    assert_same(twin, jax_walk(o, d, t, m, nrm, needs, name, jq),
                f"{name} {kind}: twin vs JAX")


@pytest.mark.parametrize("name", list(SCENES))
def test_any_hit_walk_equals_closest_trace_material(name):
    """grid_occluded's boolean (the twin's any-hit walk, after the floor /
    square / sphere stage) == the plain shadow query of the DDA route, a
    closest-hit trace from t = 1e9 read as material != 0
    (models/super.py::illum_direct), under both quirk sets, on shadow rays,
    rays from inside the grid and camera rays."""
    _, scn, _, grid = setup(name)
    o, d, t = (np.concatenate(a) for a in zip(
        *(rays(name, kind) for kind in ("shadow", "inside", "camera"))))
    for quirks in (DEFAULT, REFERENCE):
        ot, dt = torch.from_numpy(o), torch.from_numpy(d)
        want = TI.trace_ray(ot, dt, scn, quirks=quirks, tri_override=(
            functools.partial(TG._override, scn=scn, grid=grid,
                              quirks=quirks))).material.numpy() != 0
        pre = TI.any_hit(ot, dt, scn, quirks=quirks, triangles=False).numpy()
        occ, tally = walk_twin(o, d, t, np.zeros(len(o), np.int32),
                               np.zeros((len(o), 3), F),
                               np.zeros(len(o), bool), grid, _tri_table(scn),
                               quirks.accept_negative_t, any_hit=True)
        np.testing.assert_array_equal(pre | occ, want)
        assert (occ & ~pre).sum() > 10 and (~want).sum() > 10


def test_twin_tally_equals_the_debug_hook(monkeypatch, capsys):
    """The kernels' tally (entered walks, cells visited) is the plain walk's
    PT_KERNEL_DEBUG statistics, on the sheet's camera rays."""
    _, scn, _, grid = setup("sheet")
    o, d, t = rays("sheet", "camera")
    m, nrm, needs = seeded_state(len(o))
    (_, mw, _, _), tally = walk_twin(o, d, t, m, nrm, needs, grid,
                                     _tri_table(scn), False)
    monkeypatch.setenv("PT_KERNEL_DEBUG", "1")
    port_plain(o, d, t, m, nrm, needs, scn, grid, DEFAULT)
    out = capsys.readouterr().out
    assert (f"[grid DDA] rays={len(o)} entered={tally['entered']} "
            f"cells_visited={tally['cells']} tri_hits={(mw == 4).sum()}"
            ) in out


def test_grid_frame_and_tables():
    """The packed frame is (vmin, vmin + cell_size * res, cell_size) in
    float32, the JAX walk's vmax bit for bit; the tables' triangle rows
    are _tri_table's; ``triangle_tables`` builds once per prepared scene,
    modifier, build and device, and its grid is ``triangle_grid``'s."""
    _, scn, jgrid, grid = setup("sheet")
    frame = G.grid_frame(grid).numpy()
    res = np.asarray(grid.res, F)
    vmin, cs = np.asarray(jgrid.vmin, F), np.asarray(jgrid.cell_size, F)
    np.testing.assert_array_equal(frame[0:3], vmin)
    np.testing.assert_array_equal(frame[3:6], vmin + cs * res)
    np.testing.assert_array_equal(frame[6:9], cs)
    jv = np.asarray(jnp.asarray(jgrid.vmin) + jnp.asarray(jgrid.cell_size)
                    * jnp.asarray(res))
    np.testing.assert_array_equal(frame[3:6], jv)
    assert frame.dtype == F and frame.shape == (9,)
    tab = G.triangle_tables(scn, 3.0, True, "cpu")
    assert G.triangle_tables(scn, 3.0, True, "cpu") is tab
    assert G.triangle_tables(scn, 2.0, True, "cpu") is not tab
    np.testing.assert_array_equal(tab.tri.numpy(), _tri_table(scn))
    want, _ = G.triangle_grid(scn, modifier=3.0)
    for a, b in ((tab.grid.items, want.items), (tab.grid.counts, want.counts),
                 (tab.frame, G.grid_frame(want))):
        assert a.is_contiguous() and torch.equal(a, b)
    assert tab.grid.res == want.res


def test_route():
    """The route is decided from the configuration before any launch (no
    card needed): on CUDA inside the super kernels' gate auto takes B1 or
    B2/B3 and dda B11; more than 8 lights, max_bounces < 1 and the CPU
    take the DDA wavefront; an unknown accel raises."""
    small = TI.prep_scene(window_torus())
    large = TI.prep_scene(sheet_scene(30, 30))
    nine = sheet_scene(30, 30)
    nine = TI.prep_scene(Scene(nine.sphere_centers, nine.square_kj,
                               nine.triangles,
                               np.tile(nine.lights, (5, 1))[:9]))
    assert TG.route(small, 5, "auto", "cuda") == "mega_super"
    assert TG.route(large, 5, "auto", "cuda:0") == "mega_blocked"
    assert TG.route(small, 5, "dda", "cuda") == "mega_grid"
    assert TG.route(large, 1, "dda", "cuda") == "mega_grid"
    for args in ((nine, 5, "dda", "cuda"), (nine, 5, "auto", "cuda"),
                 (large, 0, "dda", "cuda"), (large, 5, "dda", "cpu"),
                 (large, 5, "auto", "cpu")):
        assert TG.route(*args) == "wavefront"
    with pytest.raises(ValueError, match="accel"):
        TG.route(small, 5, "bvh", "cuda")


def test_cpu_mega_grid_is_the_plain_dda_film():
    """On the CPU ``film_grid_mega`` is its plain version, the DDA
    wavefront with every trace plain, and ``api.render(accel="dda")``
    renders the same film."""
    import opencl_montecarlo_path_tracing_tpu_torch as tpt
    scene = window_torus()
    scn = TI.prep_scene(scene)
    tab = G.triangle_tables(scn, 3.0, True, "cpu")
    film = G.film_grid_mega((23, 0), scn, tab, 40, 158, 1, row_offset=150,
                            rows=8, device="cpu")
    want = TG.film_trianglegrid((23, 0), scn, tab.grid, 40, 158, 1, 0, 1,
                                DEFAULT, row_offset=150, rows=8,
                                device="cpu")
    assert film.shape == (8, 40, 3) and film.var() > 1e-5
    torch.testing.assert_close(film, want, rtol=0, atol=0)
    full = tpt.render("trianglegrid", scene, 40, 158, spp=1, seed=23,
                      accel="dda", device="cpu")
    torch.testing.assert_close(full[150:], film, rtol=0, atol=0)


def test_break_rule_ends_a_walk_before_its_hit():
    """The DDA's break rule (trianglegrid/pathtracer.ocl:195: after a step
    the walk ends when the running t lies before the stepped axis's next
    crossing) ends a walk early when the running t is already a farther
    hit and the stepped axis crosses rarely: this camera ray of the
    20,736-triangle sheet (pixel (67, 296), sample 0 of 64), nearly
    parallel to -y, steps once along x (a crossing ~232 ahead) past the
    floor's t = 105.1 and stops, where the brute-force scan hits the
    sheet at t = 19.8.  The JAX package's walk, the plain walk and the
    kernels' twin agree, so the DDA route's film is not the brute-force
    one on such pixels (3% of the sheet's camera rays, rows >= 384)."""
    from opencl_montecarlo_path_tracing_tpu.models import trianglegrid as JTG
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    scene = large_mesh_scene()
    scn = TI.prep_scene(scene)
    grid, _ = G.triangle_grid(scn)
    o = torch.tensor([[17.000078, 15.99997, 7.99463]])
    d = torch.tensor([[0.00162161, -0.99710274, -0.07604921]])
    dda = TI.trace_ray(o, d, scn, tri_override=functools.partial(
        TG._override, scn=scn, grid=grid, quirks=DEFAULT))
    brute = TI.trace_ray(o, d, scn)
    assert int(dda.material) == 1 and float(dda.t) > 100.0
    assert int(brute.material) == 4 and float(brute.t) < 20.0
    pre = TI.trace_ray(o, d, scn, triangles=False)
    (tw, mw, _, _), tally = walk_twin(
        o.numpy(), d.numpy(), pre.t.numpy(), pre.material.numpy(),
        pre.normal.numpy(), np.zeros(1, bool), grid, _tri_table(scn), False)
    assert int(mw[0]) == 1 and tw[0] == float(dda.t)
    assert tally["cells"] == 6      # 5 steps along -y, then one along x
    jscn = JI.prep_scene(j_scene(scene))
    jgrid, _ = JG.triangle_grid(jscn, modifier=3.0, device=False)
    jgrid = jgrid._replace(items=jnp.asarray(jgrid.items),
                           counts=jnp.asarray(jgrid.counts),
                           vmin=jnp.asarray(jgrid.vmin),
                           cell_size=jnp.asarray(jgrid.cell_size))
    want = JI.trace_ray(o.numpy(), d.numpy(), jscn, quirks=J_DEFAULT,
                        sphere_material=3, tri_override=functools.partial(
                            JTG._override, scn=jscn, grid=jgrid,
                            quirks=J_DEFAULT))
    assert int(np.asarray(want.material)[0]) == 1
    assert float(np.asarray(want.t)[0]) == float(dda.t)
