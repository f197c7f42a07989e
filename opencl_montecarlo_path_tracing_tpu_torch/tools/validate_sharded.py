"""Sharded against unsharded films, on a group of ranks.

Port of ``tools/validate_sharded_chip.py``: the sharded renderers of
``parallel/mesh.py`` (super, trianglegrid, simple, bidirectional,
metropolis, nodof, and the 2-D rows x spp meshes) against the unsharded
renders of the same configuration.  What each check holds:

* spp-split films: the CRN contract (utils/crn.py; ``SIMPLE`` for the
  simple tracer) against the unsharded film - the same samples summed in
  another order; on a mesh of one rank, bit for bit;
* the VLP light pass windowed over the mesh (``bpt_light_pass``,
  ``mlt_light_pass``): the gathered table the render used bit for bit
  against the unsharded ``emit_vlps`` / ``mlt_vlps`` table, and the
  bidirectional film bit for bit against the replicated light pass's;
* nodof row bands: bit for bit against the single render;
* 2-D meshes: the gathered row bands against the 1-D spp-sharded film of
  the same ranks, under the CRN contract.

Run under torchrun, one rank a device; rank 0 prints one line a check and
the command exits 1 if one fails:

    torchrun --nproc-per-node 2 -m \\
        opencl_montecarlo_path_tracing_tpu_torch.tools.validate_sharded \\
        [--device cpu] [--size 64] [--spp 8]

:func:`run_ranks` spawns such a group from one process instead (each rank
a ``spawn`` child, a file store for the rendezvous, a timeout on every
join); ``chip_smoke.py`` and the CPU tests drive the checks that way.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import queue
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.quirks import DEFAULT
from ..parallel import mesh as PM
from ..parallel import multihost
from ..utils.crn import SIMPLE, SUPER, crn_ok


def launch_counts() -> dict:
    """The render kernels' and the light pass's launch counters (each
    wrapper adds one where it launches its kernel)."""
    from ..ops import light_pass, mega_simple, mega_super, mega_vlp
    return {"mega_super": mega_super.LAUNCHES,
            "mega_blocked": mega_super.BLOCKED_LAUNCHES,
            "mega_vlp": mega_vlp.LAUNCHES,
            "mega_simple": mega_simple.LAUNCHES,
            "light_emit": light_pass.EMIT_LAUNCHES,
            "light_mlt_seed": light_pass.SEED_LAUNCHES,
            "light_mlt_chain": light_pass.CHAIN_LAUNCHES}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def mesh_of(spec, device) -> PM.Mesh:
    """``(n,)`` an spp mesh of n ranks, ``("y", n)`` a row mesh, ``(ny,
    ns)`` a rows x spp mesh."""
    if len(spec) == 1:
        return PM.make_spp_mesh(spec[0], device=device)
    if spec[0] == "y":
        return PM.make_spp_mesh(spec[1], axis="y", device=device)
    return PM.make_mesh_2d(spec[0], spec[1], device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _ms(fn, runs: int, device) -> float:
    """Mean wall ms of ``fn`` over ``runs`` calls after a warm-up; each
    call ends in a device sync (a sharded call ends in a collective)."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / runs


@contextlib.contextmanager
def _recorded(name: str, tables: list):
    """``parallel.mesh.<name>`` (a light pass) appends each table it
    returns to ``tables`` meanwhile: the table a sharded render used."""
    fn = getattr(PM, name)

    def record(*a, **kw):
        tables.append(fn(*a, **kw))
        return tables[-1]

    setattr(PM, name, record)
    try:
        yield
    finally:
        setattr(PM, name, fn)


def _result(name, mesh, ok, detail, out, counts, **extra) -> dict:
    return {"name": name, "mesh": dict(mesh.shape), "ok": bool(ok),
            "detail": detail, "out": out, "counts": counts, **extra}


def _crn(a, b, spp, contract=SUPER, exact=False):
    """(ok, detail): bit for bit when ``exact``, else the contract."""
    if exact:
        same = torch.equal(a.cpu(), b.cpu())
        return same, "bit-equal" if same else "NOT bit-equal"
    ok, st = crn_ok(a, b, spp, contract)
    return ok, (f"p{contract.quantile * 100:g} {st['q']:.3e} ties "
                f"{st['tie_frac'] * 100:.3f}% max_abs {st['max_abs']:.3e}")


def check_super(spec, key, scene, width, height, spp, device="cuda",
                runs: int = 0) -> dict:
    """super sharded over ``spec`` against the unsharded render (a 2-D
    mesh: against the 1-D spp-sharded film of the same ranks).  With
    ``runs``, both are also timed (ms a render)."""
    from ..models.super import render_super
    mesh = mesh_of(spec, device)
    two_d = len(mesh.shape) == 2
    before = launch_counts()
    if two_d:
        fn = lambda: PM.render_super_sharded_2d(  # noqa: E731
            key, scene, width, height, spp, mesh)
    else:
        fn = lambda: PM.render_super_sharded(  # noqa: E731
            key, scene, width, height, spp, mesh)
    film = fn()
    _sync(device)
    counts = _since(before)
    if two_d:
        ref = PM.render_super_sharded(key, scene, width, height, spp,
                                      mesh_of((mesh.size,), device))
    elif mesh.rank == 0:
        ref = render_super(key, scene, width, height, spp, device=mesh.device)
    extra = {}
    if runs:
        extra["ms"] = _ms(fn, runs, device)
        if not two_d and mesh.rank == 0:
            extra["unsharded_ms"] = _ms(lambda: render_super(
                key, scene, width, height, spp, device=mesh.device), runs,
                device)
    if mesh.rank != 0:
        return _result("super", mesh, True, "", None, counts, **extra)
    ok, detail = _crn(film, ref, spp, exact=mesh.size == 1)
    return _result("super", mesh, ok, detail, film.cpu().numpy(), counts,
                   **extra)


def check_trianglegrid(spec, key, scene, width, height, spp,
                       cell_size_modifier=3.0, device="cuda") -> dict:
    from ..models.trianglegrid import render_trianglegrid
    mesh = mesh_of(spec, device)
    before = launch_counts()
    film = PM.render_trianglegrid_sharded(
        key, scene, width, height, spp, mesh,
        cell_size_modifier=cell_size_modifier)
    _sync(device)
    counts = _since(before)
    if mesh.rank != 0:
        return _result("trianglegrid", mesh, True, "", None, counts)
    ref = render_trianglegrid(key, scene, width, height, spp,
                              cell_size_modifier, device=mesh.device)
    ok, detail = _crn(film, ref, spp, exact=mesh.size == 1)
    return _result("trianglegrid", mesh, ok, detail, film.cpu().numpy(),
                   counts)


def check_simple(spec, key, width, height, spp, device="cuda") -> dict:
    from ..models.simple import render_simple
    mesh = mesh_of(spec, device)
    before = launch_counts()
    film = PM.render_simple_sharded(key, width, height, spp, mesh)
    _sync(device)
    counts = _since(before)
    if mesh.rank != 0:
        return _result("simple", mesh, True, "", None, counts)
    ref = render_simple(key, width, height, spp, device=mesh.device)
    ok, detail = _crn(film, ref, spp, SIMPLE, exact=mesh.size == 1)
    return _result("simple", mesh, ok, detail, film.cpu().numpy(), counts)


def check_bidirectional(spec, key, scene, width, height, spp, n_vlp=512,
                        use_grid=False, device="cuda") -> dict:
    """The windowed light pass's table bit for bit against
    ``emit_vlps``; the film against the replicated light pass's bit for
    bit (1-D) and against the unsharded render (1-D) or the 1-D
    spp-sharded film (2-D) under the contract."""
    from ..models.bidirectional import render_bidirectional
    from ..ops.intersect import prep_scene
    from ..ops.vlp import emit_vlps
    scn = prep_scene(scene)
    mesh = mesh_of(spec, device)
    two_d = len(mesh.shape) == 2
    windowed = PM._shard_light(mesh, n_vlp, int(scn.lights.shape[0]))
    before, tables = launch_counts(), []
    with _recorded("bpt_light_pass", tables):
        if two_d:
            film = PM.render_bidirectional_sharded_2d(
                key, scn, width, height, spp, mesh, n_vlp=n_vlp,
                use_grid=use_grid)
        else:
            film = PM.render_bidirectional_sharded(
                key, scn, width, height, spp, mesh, n_vlp=n_vlp,
                use_grid=use_grid)
    _sync(device)
    counts = _since(before)
    [table] = tables
    same_table = torch.equal(table, emit_vlps(key, scn, n_vlp,
                                              device=mesh.device))
    if two_d:
        ref = PM.render_bidirectional_sharded(
            key, scn, width, height, spp, mesh_of((mesh.size,), device),
            n_vlp=n_vlp, use_grid=use_grid)
        same_film = True
    else:
        same_film = torch.equal(film, PM.render_bidirectional_sharded(
            key, scn, width, height, spp, mesh, n_vlp=n_vlp,
            use_grid=use_grid, light_pass="replicated"))
        if mesh.rank == 0:
            ref = render_bidirectional(key, scn, width, height, spp,
                                       n_vlp=n_vlp, use_grid=use_grid,
                                       device=mesh.device)
    live = int((table[:, 3] > 0).sum())
    if mesh.rank != 0:
        return _result("bidirectional", mesh, same_table and same_film, "",
                       None, counts, windowed=windowed)
    ok, detail = _crn(film, ref, spp, exact=mesh.size == 1)
    detail = (f"table {'bit-equal' if same_table else 'DIFFERS'} "
              f"({'windowed' if windowed else 'replicated'}, {live} of "
              f"{table.shape[0]} rows live); "
              + ("" if two_d else "film vs replicated light pass "
                 f"{'bit-equal' if same_film else 'DIFFERS'}; ")
              + f"vs {'1-D' if two_d else 'unsharded'}: {detail}")
    return _result("bidirectional", mesh, ok and same_table and same_film,
                   detail, film.cpu().numpy(), counts, windowed=windowed,
                   table=table.cpu().numpy())


def check_metropolis(spec, key, scene, width, height, spp, n_seedpaths=512,
                     mutation_rounds=8, use_grid=False, device="cuda") -> dict:
    """The chain-window table the render used bit for bit against
    ``mlt_vlps``; the film (1-D) against the unsharded render pass on that
    table, or (2-D) returned for the caller to hold."""
    from ..models.metropolis import film_metropolis, mlt_vlps
    from ..ops.intersect import prep_scene
    scn = prep_scene(scene)
    mesh = mesh_of(spec, device)
    two_d = len(mesh.shape) == 2
    windowed = PM._shard_light(mesh, n_seedpaths, int(scn.lights.shape[0]))
    kw = dict(n_seedpaths=n_seedpaths, mutation_rounds=mutation_rounds,
              use_grid=use_grid)
    before, tables = launch_counts(), []
    with _recorded("mlt_light_pass", tables):
        if two_d:
            film = PM.render_metropolis_sharded_2d(key, scn, width, height,
                                                   spp, mesh, **kw)
        else:
            film = PM.render_metropolis_sharded(key, scn, width, height,
                                                spp, mesh, **kw)
    _sync(device)
    counts = _since(before)
    [table] = tables
    if mesh.rank != 0:
        return _result("metropolis", mesh, True, "", None, counts,
                       windowed=windowed)
    full = mlt_vlps(key, scn, n_seedpaths, mutation_rounds, DEFAULT,
                    device=mesh.device)
    same_table = torch.equal(table, full)
    detail = (f"table {'bit-equal' if same_table else 'DIFFERS'} "
              f"({'windowed' if windowed else 'replicated'}, "
              f"{int((table[:, 3] > 0).sum())} of {table.shape[0]} rows "
              "live)")
    ok = same_table
    if not two_d:
        ref = film_metropolis(key, scn, width, height, spp, 0, spp,
                              n_seedpaths, mutation_rounds, DEFAULT,
                              use_grid=use_grid, precomputed_vlps=full,
                              device=mesh.device)
        film_ok, d = _crn(film, ref, spp, exact=mesh.size == 1)
        ok = ok and film_ok
        detail += f"; vs unsharded: {d}"
    return _result("metropolis", mesh, ok, detail, film.cpu().numpy(),
                   counts, windowed=windowed, table=table.cpu().numpy())


def check_nodof(spec, key, scene, width, height, sample_grid=8,
                device="cuda") -> dict:
    """Row bands bit for bit against the single render."""
    from ..models.sample_parallel import render_sample_parallel
    mesh = mesh_of(spec, device)
    before = launch_counts()
    img = PM.render_sample_parallel_sharded(key, scene, width, height,
                                            sample_grid, mesh)
    _sync(device)
    counts = _since(before)
    if mesh.rank != 0:
        return _result("nodof", mesh, True, "", None, counts)
    ref = render_sample_parallel(key, scene, width, height, sample_grid,
                                 device=mesh.device)
    n = mesh.size
    rows = height // n
    bands = [torch.equal(img[b * rows:(b + 1) * rows],
                         ref[b * rows:(b + 1) * rows]) for b in range(n)]
    return _result("nodof", mesh, all(bands),
                   f"{sum(bands)} of {n} bands bit-equal",
                   img.cpu().numpy(), counts)


def run_checks(checks, device) -> list:
    """Run ``checks`` - (function name, keyword arguments) pairs - in
    order on this rank; returns their results."""
    out = []
    for name, kw in checks:
        t0 = time.perf_counter()
        r = globals()[name](device=device, **kw)
        r["seconds"] = time.perf_counter() - t0
        out.append(r)
    return out


def _rank_main(rank, world, store, backend, device, timeout, results, fn,
               args):
    """One spawned rank: join the group, run ``fn(*args, device=...)``,
    put (rank, result or traceback) on ``results``."""
    try:
        if torch.device(device).type == "cpu":
            # one thread a rank (the ranks share the host's cores), and the
            # process's first torch.sqrt taken here: with torch 2.13.0+cpu
            # on an AVX-512 CPU a first call has returned one 2,048-element
            # segment ~2e-4 off, so no camera ray may be it
            torch.set_num_threads(1)
            torch.sqrt(torch.rand(16384) * 400.0)
        else:
            os.environ["LOCAL_RANK"] = str(rank)
        multihost.initialize(f"file://{store}", world, rank, backend=backend,
                             device=device, timeout=timeout)
        res = fn(*args, device=multihost.rank_device(device))
        dist.barrier()
        results.put((rank, res, None))
    except BaseException:   # reported to the parent, which raises
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device="cpu", backend=None,
              timeout: float = 300.0) -> list:
    """Run ``fn(*args, device=<the rank's device>)`` on ``world`` spawned
    ranks of one process group (``backend`` defaults to the device's:
    nccl for CUDA, gloo for the CPU); returns the results in rank order.
    Raises if a rank fails or does not finish within ``timeout`` seconds
    (its process is then killed)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, store, backend, str(device), min(timeout, 120.0),
            results, fn, args)) for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            # drain the queue before joining (a full pipe blocks a child)
            while len(got) < world:
                left = deadline - time.monotonic()
                try:
                    rank, res, err = results.get(timeout=max(left, 0.1))
                except queue.Empty:
                    raise RuntimeError(
                        f"ranks {sorted(set(range(world)) - set(got))} did "
                        f"not finish within {timeout} s") from None
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                got[rank] = res
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank processes exited {bad}")
    return [got[r] for r in range(world)]


def main(argv=None) -> int:
    from ..core.rng import make_key
    from ..scene.builtin import demo_scene
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8,
                    help="samples a rank (the render's spp is N times it)")
    ns = ap.parse_args(argv)
    multihost.initialize(device=ns.device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    device = multihost.rank_device(ns.device)
    scene, tag = demo_scene()
    key = make_key(31)
    s, spp = ns.size, ns.spp * n
    checks = [("check_super", dict(spec=(n,), key=key, scene=scene,
                                   width=s, height=s, spp=spp)),
              ("check_bidirectional", dict(spec=(n,), key=key, scene=scene,
                                           width=s, height=s, spp=spp)),
              ("check_metropolis", dict(spec=(n,), key=key, scene=scene,
                                        width=s, height=s, spp=spp)),
              ("check_nodof", dict(spec=("y", n), key=key, scene=scene,
                                   width=s, height=s))]
    if n >= 4 and n % 2 == 0:
        checks.append(("check_super", dict(spec=(n // 2, 2), key=key,
                                           scene=scene, width=s, height=s,
                                           spp=spp)))
    failed = 0
    for r in run_checks(checks, device):
        failed += not r["ok"]
        if multihost.is_primary():
            print(f"{r['name']} on {r['mesh']} ({tag}, {s}x{s}, "
                  f"{ns.device}): {'ok' if r['ok'] else 'FAILED'} - "
                  f"{r['detail']} ({r['seconds']:.2f} s)", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
