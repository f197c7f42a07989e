"""Command-line parity with the reference binaries.

Port of ``opencl_montecarlo_path_tracing_tpu/utils/cli.py``: every variant
is a subcommand with the same positionals:

    python -m opencl_montecarlo_path_tracing_tpu_torch simplecpu [w] [h]
    python -m opencl_montecarlo_path_tracing_tpu_torch simple    [w] [h] [lws0]
    python -m opencl_montecarlo_path_tracing_tpu_torch super     [w] [h]
    python -m opencl_montecarlo_path_tracing_tpu_torch superlmem [w] [h]
    python -m opencl_montecarlo_path_tracing_tpu_torch nodof     [w] [h]
    python -m opencl_montecarlo_path_tracing_tpu_torch trianglegrid \
        [w] [h] [CELL_SIZE_MODIFIER]
    python -m opencl_montecarlo_path_tracing_tpu_torch bidirectional \
        [w] [h] [N_VLP]
    python -m opencl_montecarlo_path_tracing_tpu_torch metropolis \
        [w] [h] [nseedpaths] [mutation_rounds] [CELL_SIZE_MODIFIER]
    python -m opencl_montecarlo_path_tracing_tpu_torch metropolis_vlpgrid \
        [w] [h] [nseedpaths] [mutation_rounds] [CELL_SIZE_MODIFIER]

Options: --scene-dir (the four reference text files), --triangles-file
(an alternate mesh file in the same format), --spp, --seed,
--out, --quirks {default,reference}, --pam-maxval {255,65535},
--dynamic-grid-res (metropolis_vlpgrid: the reference's box-derived grid
resolution, one host read of the VLP box), --checkpoint PATH and
--spp-per-step N (resumable accumulation in spp windows of N, saved to
PATH after each; re-running resumes where it left off, and a file of
another variant, scene, quirk set or parameter list starts over; super,
superlmem, trianglegrid, simple, bidirectional, metropolis and
metropolis_vlpgrid),
--profile-stages (the VLP pipelines stage by stage, in the reference's
per-stage report: 3 stages, or with --dynamic-grid-res the vlpgrid
reference's 7), and --device.  ``simple`` and ``simplecpu`` read no scene
files; the lws0 positional of the simple tracer is accepted and ignored;
``nodof`` renders an 8x8 sample grid per pixel (its --spp is not read);
``simplecpu`` is the reference's CPU tracer, rendered on the host
whatever the device, at 256x256 by default.

--shard N renders through the sharded path (parallel/mesh.py) on a
group of N ranks: N shards the spp axis (nodof: its image rows), RxS
image rows x spp on a 2-D mesh (super, superlmem, bidirectional,
metropolis, metropolis_vlpgrid); the VLP variants shard their light pass
too.  Launch it with ``torchrun --nproc-per-node N -m
opencl_montecarlo_path_tracing_tpu_torch ... --shard N`` (each rank
renders on cuda:LOCAL_RANK over NCCL, or with --device cpu over gloo);
N = 1 runs in a plain process.  Rank 0 writes the image, the checkpoint
and the report.  It composes with --checkpoint in its 1-D spp forms,
whose windows (--spp-per-step, and the last one) must divide by N; it
does not compose with --profile-stages or --dynamic-grid-res.

Device selection: an explicit --device wins.  Otherwise PT_PLATFORM
(``cuda`` or ``cpu``; a non-numeric OCL_PLATFORM is accepted in its place)
picks the backend and PT_DEVICE (or the reference's OCL_DEVICE,
ocl_boiler.h:54-131) the CUDA index; with none of them set the CLI renders
on ``cuda``.  A CUDA device renders with the CUDA kernels; a missing one
exits 1 (``no device N; have M``): the CLI never renders on the CPU
instead.

Output: a PAM (P7) RGBA file (default result.ppm, resultCPU.ppm for
simplecpu) plus a per-stage timing report in the reference's format (e.g.
CLSuperPathTracer.c:321-325).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .profiling import StageTimer


def _positional(args, i, default, cast=int):
    return cast(args[i]) if len(args) > i else default


def _select_device(requested):
    """The render device: ``requested`` (--device) when given, else the
    PT_PLATFORM / OCL_PLATFORM backend (default ``cuda``) and the
    PT_DEVICE / OCL_DEVICE index.  Returns None after printing an error
    when that device does not exist."""
    name = requested
    if not name:
        platform = os.environ.get("PT_PLATFORM")
        if not platform:
            # the reference's OCL_PLATFORM picked a platform by INDEX; here
            # platforms are named backends, so only a name is honoured
            ocl_p = os.environ.get("OCL_PLATFORM", "")
            if ocl_p and not ocl_p.isdigit():
                platform = ocl_p
        index = os.environ.get("PT_DEVICE") or os.environ.get("OCL_DEVICE")
        name = (platform or "cuda") + (f":{index}" if index else "")
    try:
        device = torch.device(name)
    except RuntimeError:
        device = None
    if device is None or device.type not in ("cuda", "cpu"):
        print(f"error: unknown device {name!r}; use cuda[:N] or cpu",
              file=sys.stderr)
        return None
    idx = device.index or 0
    have = (torch.cuda.device_count() if torch.cuda.is_available() else 0) \
        if device.type == "cuda" else 1
    if idx >= have:
        print(f"no device {idx}; have {have}", file=sys.stderr)
        return None
    if device.type == "cuda":
        device = torch.device("cuda", idx)
        print(f"Using device: {device} ({torch.cuda.get_device_name(device)})")
    else:
        print(f"Using device: {device}")
    return device


def _staged_vlp_render(timer, key, scene, w, h, spp, quirks, kind, device,
                       n_vlp=512, n_seed=512, rounds=8, use_grid=False,
                       grid_modifier=3.0, dynamic_res=False):
    """Run the VLP pipeline stage by stage with a device sync per stage -
    observability parity with the reference's per-stage event report (e.g.
    CLSuperMetropolisPathTracer_vlpgrid/...c:673-705: light pass, metropolis
    pass, min/max reduction, grid init, render).  The render stage is
    ``film_bidirectional`` on the staged VLPs and grid (kernel B4 on CUDA).

    ``dynamic_res`` (the --dynamic-grid-res parity mode) expands the mlt
    grid pipeline to the reference's exact 7-stage vlpgrid report
    (.c:691-705): the seed and Metropolis light kernels timed separately,
    the device box reduction, the BLOCKING host box read (.c:609), the
    box-derived grid init, the render, and the render read (timed by the
    caller).

    Returns the film and the VLP table it was rendered with."""
    from ..models.bidirectional import film_bidirectional
    from ..models.metropolis import mlt_mutate_emit, mlt_seed, mlt_vlps
    from ..ops import vlp as vlpmod
    from ..ops.intersect import prep_scene

    scn = prep_scene(scene)
    nlights = int(scn.lights.shape[0])
    if kind == "bpt":
        vlps = timer.run(
            "light tracer",
            lambda: vlpmod.emit_vlps(key, scn, n_vlp, quirks, device=device),
            items=n_vlp * nlights, item_label="VLPs",
            data_size=n_vlp * nlights * 16)
    elif dynamic_res and use_grid:
        # reference stage 1+2: the two light kernels timed separately
        # (lightTracer then MetropolisLightTracer, .c:691-694)
        seed_state = timer.run(
            "light paths random sampling",
            lambda: mlt_seed(key, scn, n_seed, quirks, device=device),
            items=n_seed * nlights, item_label="random light paths",
            data_size=n_seed * nlights * 64)
        vlps = timer.run(
            "light paths metropolis sampling",
            lambda: mlt_mutate_emit(key, scn, n_seed, rounds, quirks,
                                    seed_state=seed_state, device=device),
            items=n_seed * nlights * 4, item_label="virtual lights",
            data_size=n_seed * nlights * 4 * 16)
    else:
        vlps = timer.run(
            "light tracer + metropolis",
            lambda: mlt_vlps(key, scn, n_seed, rounds, quirks,
                             device=device),
            items=n_seed * nlights, item_label="paths",
            data_size=n_seed * nlights * 64)

    grid = None
    if use_grid and dynamic_res:
        nv = int(vlps.shape[0])
        # reference stages 3-5: device box reduction, BLOCKING host box
        # read, box-derived grid init (.c:595-648)
        bb = timer.run("VLPs min/max reduction (compute bounding box)",
                       lambda: vlpmod.vlp_bounds(vlps), items=nv,
                       item_label="virtual lights", data_size=nv * 16)
        t0 = time.perf_counter()
        vmin, vmax = (b.cpu().numpy() for b in bb)
        timer.record("Read VLPs bounding box",
                     (time.perf_counter() - t0) * 1e3,
                     items=1, item_label="box", data_size=32)
        res = vlpmod.vlp_grid_dynamic_res(vmin, vmax, nv, grid_modifier)
        print("VLPs grid size: %d x %d x %d" % res)
        grid = timer.run("init VLPs grid",
                         lambda: vlpmod.build_vlp_grid(vlps, res),
                         items=int(np.prod(res)), item_label="cells",
                         data_size=int(np.prod(res)) * 63 * 4)
    elif use_grid:
        res = vlpmod.vlp_grid_static_res(int(vlps.shape[0]), grid_modifier)
        grid = timer.run("min/max reduction + VLPs grid init",
                         lambda: vlpmod.build_vlp_grid(vlps, res),
                         items=int(np.prod(res)), item_label="cells",
                         data_size=int(np.prod(res)) * 63 * 4)

    film = timer.run(
        "rendering",
        lambda: film_bidirectional(key, scn, w, h, spp, 0, spp, n_vlp,
                                   quirks, use_grid=use_grid,
                                   precomputed_vlps=vlps,
                                   precomputed_grid=grid, device=device),
        items=w * h, item_label="pixels", data_size=w * h * 4)
    return film, vlps


_SHARD_2D = ("super", "superlmem", "bidirectional", "metropolis",
             "metropolis_vlpgrid")


def _shard_error(msg: str):
    print(f"error: {msg}", file=sys.stderr)
    return None


def _shard_layout(ns):
    """(n, rows, spp) of --shard (rows None for the 1-D form), checked
    against the variant and the options before anything renders; None
    after printing an error."""
    spec = ns.shard.lower()
    try:
        if "x" in spec:
            ry, sp = (int(x) for x in spec.split("x"))
        else:
            ry, sp = None, int(spec)
    except ValueError:
        return _shard_error(f"bad --shard spec {ns.shard!r} (want N or RxS)")
    n = sp if ry is None else ry * sp
    if n < 1 or sp < 1:
        return _shard_error(f"bad --shard spec {ns.shard!r} (want N or RxS)")
    if ry is not None and ns.variant not in _SHARD_2D:
        return _shard_error(f"2-D --shard is not supported for {ns.variant} "
                            "(use the 1-D N form)")
    if ns.checkpoint and (ry is not None or ns.variant == "nodof"):
        return _shard_error(
            "--checkpoint composes with the 1-D spp-sharded --shard forms "
            f"only (not {'2-D meshes' if ry is not None else ns.variant})")
    if ns.profile_stages or ns.dynamic_grid_res:
        return _shard_error("--shard is incompatible with --profile-stages "
                            "/ --dynamic-grid-res")
    if ns.checkpoint:
        step = ns.spp_per_step
        if step < 1 or step % n or (ns.spp % step) % n:
            return _shard_error(
                f"--shard {ns.shard}: every --checkpoint window must divide "
                f"by {n} (--spp-per-step {step}, last window "
                f"{ns.spp % step if step > 0 else ns.spp})")
    return n, ry, sp


def _sharded_render(ns, timer, key, scene, w, h, quirks, pos, seed, device,
                    layout, meta):
    """--shard dispatch to the parallel/mesh.py renderers on the ranks of
    the process group (beyond the reference surface: the reference is
    single-device, ocl_boiler.h:150).  Returns (mesh, film, img); (None,
    None, None) after printing an error."""
    from .. import parallel as par
    from ..parallel import multihost
    import torch.distributed as dist
    n, ry, sp = layout
    multihost.initialize(device=device)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        _shard_error(f"--shard {ns.shard} needs {n} ranks; have {have} "
                     f"(launch with torchrun --nproc-per-node {n})")
        return None, None, None
    v, spp = ns.variant, ns.spp
    label = f"rendering (sharded {ns.shard})"
    try:
        if v == "nodof":
            mesh = par.make_spp_mesh(n, axis="y", device=device)
            img = timer.run(
                "rendering+reduction (sharded rows)",
                lambda: par.render_sample_parallel_sharded(
                    key, scene, w, h, sample_grid=8, mesh=mesh,
                    quirks=quirks),
                items=w * h * 64, item_label="samples",
                data_size=w * h * 64 * 16)
            return mesh, None, img
        two_d = ry is not None
        mesh = (par.make_mesh_2d(ry, sp, device=device) if two_d
                else par.make_spp_mesh(n, device=device))
        # each variant is a window function (step, offset, total), so the
        # plain render (one full window) and --checkpoint (resumable
        # windows) share one dispatch; a 2-D mesh renders whole
        if v in ("super", "superlmem"):
            fn2 = lambda: par.render_super_sharded_2d(  # noqa: E731
                key, scene, w, h, spp, mesh, quirks)
            winfn = lambda s, off, tot: par.render_super_sharded(  # noqa
                key, scene, w, h, s, mesh, quirks, spp_offset=off,
                spp_total=tot)
        elif v == "simple":
            winfn = lambda s, off, tot: par.render_simple_sharded(  # noqa
                key, w, h, s, mesh, quirks, spp_offset=off, spp_total=tot)
        elif v == "trianglegrid":
            mod = _positional(pos, 2, 3.0, float)
            winfn = lambda s, off, tot: par.render_trianglegrid_sharded(  # noqa
                key, scene, w, h, s, mesh, cell_size_modifier=mod,
                quirks=quirks, spp_offset=off, spp_total=tot)
        elif v == "bidirectional":
            n_vlp = _positional(pos, 2, 512)
            fn2 = lambda: par.render_bidirectional_sharded_2d(  # noqa: E731
                key, scene, w, h, spp, mesh, n_vlp=n_vlp, quirks=quirks)
            winfn = lambda s, off, tot: par.render_bidirectional_sharded(  # noqa
                key, scene, w, h, s, mesh, n_vlp=n_vlp, quirks=quirks,
                spp_offset=off, spp_total=tot)
        else:   # metropolis / metropolis_vlpgrid
            kw = dict(n_seedpaths=_positional(pos, 2, 512),
                      mutation_rounds=_positional(pos, 3, 8), quirks=quirks,
                      use_grid=v.endswith("vlpgrid"),
                      grid_modifier=_positional(pos, 4, 3.0, float))
            fn2 = lambda: par.render_metropolis_sharded_2d(  # noqa: E731
                key, scene, w, h, spp, mesh, **kw)
            winfn = lambda s, off, tot: par.render_metropolis_sharded(  # noqa
                key, scene, w, h, s, mesh, spp_offset=off, spp_total=tot,
                **kw)
        if ns.checkpoint:
            from .checkpoint import render_resumable
            t0 = time.perf_counter()
            ck = render_resumable(
                lambda k, s_, ww, hh, spp, spp_offset, spp_total:
                    winfn(spp, spp_offset, spp_total),
                key, scene, w, h, spp, checkpoint_path=ns.checkpoint,
                spp_per_step=ns.spp_per_step, seed=seed, meta=meta,
                group=mesh.group)
            timer.record(f"{label} (checkpointed, {ck.spp_done} spp)",
                         (time.perf_counter() - t0) * 1e3,
                         items=w * h, item_label="pixels",
                         data_size=w * h * 4)
            return mesh, torch.from_numpy(ck.film), None
        fn = fn2 if two_d else (lambda: winfn(spp, 0, None))
        film = timer.run(label, fn, items=w * h, item_label="pixels",
                         data_size=w * h * 4)
        return mesh, film, None
    except ValueError as e:   # indivisible spp / rows
        _shard_error(f"--shard {ns.shard}: {e}")
        return None, None, None


def main(argv=None):
    from ..api import VARIANTS
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="opencl_montecarlo_path_tracing_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("variant", choices=VARIANTS)
    ap.add_argument("positionals", nargs="*")
    ap.add_argument("--scene-dir", default=".")
    ap.add_argument("--triangles-file", default="triangles.txt",
                    help="alternate mesh in the same format (the reference "
                         "ships torus.txt to swap in by renaming)")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quirks", choices=["default", "reference"],
                    default="default")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="accumulate the film in spp windows, checkpointing "
                         "to PATH after each; re-running resumes where it "
                         "left off (the same sample content)")
    ap.add_argument("--spp-per-step", type=int, default=64,
                    help="window size for --checkpoint")
    ap.add_argument("--pam-maxval", type=int, choices=[255, 65535],
                    default=255,
                    help="output sample depth: 255 = the reference's RGBA8; "
                         "65535 writes 16-bit PAM")
    ap.add_argument("--dynamic-grid-res", action="store_true",
                    help="metropolis_vlpgrid: derive the grid resolution "
                         "from the VLP box as the reference does (one "
                         "device->host read)")
    ap.add_argument("--profile-stages", action="store_true",
                    help="time the VLP pipeline stage by stage (light pass, "
                         "box reduction + grid init, render), mirroring the "
                         "reference's per-stage event report")
    ap.add_argument("--shard", default=None, metavar="N|RxS",
                    help="render through the sharded path on a group of N "
                         "ranks (launch with torchrun --nproc-per-node N): "
                         "N shards spp (nodof: rows), RxS image rows x spp "
                         "(super/superlmem/bidirectional/metropolis"
                         "[_vlpgrid]); composes with --checkpoint (1-D "
                         "forms)")
    ap.add_argument("--device", default=None,
                    help="torch device to render on (default: PT_PLATFORM "
                         "and PT_DEVICE, else cuda; under --shard the "
                         "rank's cuda:LOCAL_RANK)")
    ns = ap.parse_args(argv)
    pos = ns.positionals

    from ..core.quirks import DEFAULT, REFERENCE, REFERENCE_LMEM
    from ..core.rng import make_key
    from ..core.camera import make_camera
    from ..scene.scene import load_scene

    # superlmem + reference quirks additionally reproduces the lmem
    # binaries' shadow-trace &t aliasing (core/quirks.py::shadow_carry_t)
    if ns.quirks == "reference":
        quirks = REFERENCE_LMEM if ns.variant == "superlmem" else REFERENCE
    else:
        quirks = DEFAULT
    # the reference seeds from time/pid/clock/rdtsc (CLSuperPathTracer.c:209)
    seed = ns.seed if ns.seed is not None else (time.time_ns() & 0x7FFFFFFF)
    key = make_key(seed)
    print(f"Seed: {seed}")

    host = ns.variant == "simplecpu"
    w = _positional(pos, 0, 256 if host else 512)
    h = _positional(pos, 1, 256 if host else 512)
    out_name = ns.out or ("resultCPU.ppm" if host else "result.ppm")

    # camera printout parity (CLSuperPathTracer.c:251); the CPU tracer's
    # basis has z_vect = +1 (simpleCPUtracer.cpp:160)
    cam = make_camera(z_sign=1.0 if host else -1.0)
    print("Cam values:\nCam_forward %f %f %f\nCam_up %f %f %f\n"
          "Cam_right %f %f %f\n eye_offset %f %f %f"
          % (*cam.forward, *cam.up, *cam.right, *cam.eye_offset))

    if host:
        # the reference's CPU tracer: it renders on the host
        from ..models.oracle import render_oracle
        timer = StageTimer()
        t0 = time.perf_counter()
        film = torch.from_numpy(render_oracle(w, h, spp=ns.spp, seed=seed,
                                              gpu_layout=False))
        timer.record("rendering (host)", (time.perf_counter() - t0) * 1e3,
                     items=w * h, item_label="float", data_size=w * h * 4)
        return _write(ns, out_name, film, None, w, h, quirks, timer)

    layout = None
    if ns.shard:
        layout = _shard_layout(ns)
        if layout is None:
            return 1
    device = _select_device(ns.device)
    if device is None:
        return 1
    if ns.shard:
        from ..parallel.multihost import rank_device
        device = rank_device(device)
    timer = StageTimer(device)

    if ns.variant != "simple":
        try:
            scene = load_scene(ns.scene_dir, triangles=ns.triangles_file)
        except FileNotFoundError as e:
            print(f"error: missing scene file: {e.filename} "
                  f"(looked in {ns.scene_dir!r}; need spheres.txt, "
                  "squares.txt, triangles.txt, lights.txt)", file=sys.stderr)
            return 1
        print(f"Number of triangles: {scene.n_triangles}")
        print(f"Number of lights: {scene.n_lights}")

    # the checkpoint records what else the film depends on, so that another
    # variant, scene, quirk set or parameter list starts over instead of
    # adding to it
    meta = {"variant": ns.variant,
            "scene_dir": os.path.abspath(ns.scene_dir),
            "triangles": ns.triangles_file, "quirks": ns.quirks,
            "params": " ".join(pos[2:]),
            "dynamic_grid_res": ns.dynamic_grid_res}
    if ns.shard:
        mesh, film, img = _sharded_render(
            ns, timer, key, None if ns.variant == "simple" else scene, w, h,
            quirks, pos, seed, device, layout, meta)
        try:
            if mesh is None:
                return 1
            if mesh.rank != 0:
                return 0          # rank 0 writes
            return _write(ns, out_name, film, img, w, h, quirks, timer)
        finally:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()

    def run_maybe_resumable(name, render_fn, scene_arg, **kw):
        """Either one render or checkpointed spp windows (whose film is
        summed on the host)."""
        if not ns.checkpoint:
            return timer.run(
                name,
                lambda: render_fn(key, scene_arg, w, h, spp=ns.spp,
                                  quirks=quirks, device=device, **kw),
                items=w * h, item_label="pixels", data_size=w * h * 4)
        from .checkpoint import render_resumable
        t0 = time.perf_counter()
        ck = render_resumable(render_fn, key, scene_arg, w, h, ns.spp,
                              checkpoint_path=ns.checkpoint,
                              spp_per_step=ns.spp_per_step, seed=seed,
                              meta=meta, quirks=quirks, device=device, **kw)
        timer.record(f"{name} (checkpointed, {ck.spp_done} spp)",
                     (time.perf_counter() - t0) * 1e3,
                     items=w * h, item_label="pixels", data_size=w * h * 4)
        return torch.from_numpy(ck.film)

    img = None
    if ns.variant == "simple":
        from ..models.simple import render_simple
        film = run_maybe_resumable(
            "rendering",
            lambda k, _scene, ww, hh, **kw: render_simple(k, ww, hh, **kw),
            None)
    elif ns.variant == "nodof":
        from ..models.sample_parallel import render_sample_parallel
        film = None
        img = timer.run(
            "rendering+reduction",
            lambda: render_sample_parallel(key, scene, w, h, sample_grid=8,
                                           quirks=quirks, device=device),
            items=w * h * 64, item_label="samples",
            data_size=w * h * 64 * 16)
    elif ns.variant in ("super", "superlmem"):
        from ..models.super import render_super
        film = run_maybe_resumable("rendering", render_super, scene)
    elif ns.variant == "trianglegrid":
        from ..models.trianglegrid import render_trianglegrid
        film = run_maybe_resumable(
            "grid init + rendering", render_trianglegrid, scene,
            cell_size_modifier=_positional(pos, 2, 3.0, float))
    elif ns.variant == "bidirectional":
        n_vlp = _positional(pos, 2, 512)
        if ns.profile_stages:
            film, _ = _staged_vlp_render(timer, key, scene, w, h, ns.spp,
                                         quirks, "bpt", device, n_vlp=n_vlp)
        else:
            from ..models.bidirectional import render_bidirectional
            film = run_maybe_resumable("light pass + rendering",
                                       render_bidirectional, scene,
                                       n_vlp=n_vlp)
    else:
        n_seed = _positional(pos, 2, 512)
        rounds = _positional(pos, 3, 8)
        mod = _positional(pos, 4, 3.0, float)
        use_grid = ns.variant.endswith("vlpgrid")
        if ns.profile_stages:
            film, _ = _staged_vlp_render(
                timer, key, scene, w, h, ns.spp, quirks, "mlt", device,
                n_seed=n_seed, rounds=rounds, use_grid=use_grid,
                grid_modifier=mod, dynamic_res=ns.dynamic_grid_res)
        else:
            from ..models.metropolis import render_metropolis
            film = run_maybe_resumable(
                "light pass + metropolis + rendering", render_metropolis,
                scene, n_seedpaths=n_seed, mutation_rounds=rounds,
                use_grid=use_grid, grid_modifier=mod,
                dynamic_grid_res=ns.dynamic_grid_res)
    return _write(ns, out_name, film, img, w, h, quirks, timer)


def _write(ns, out_name, film, img, w, h, quirks, timer) -> int:
    """Quantise ``film`` on its device (or take the nodof image ``img``),
    copy the pixels to the host and write the PAM file."""
    from ..ops.reduce import quantize_film, quantize_film16
    from .pam import ImgInfo, save_pam
    if img is not None:
        rgba = img.cpu().numpy()
        if ns.pam_maxval == 65535:
            # the nodof reduction emits RGBA8 (reduce4img_lmem,
            # ...NoDoF/pathtracer.ocl:268-271); widen exactly (255 -> 65535)
            rgba = rgba.astype(np.uint16) * np.uint16(257)
    elif ns.pam_maxval == 65535:
        rgba = quantize_film16(film).cpu().numpy().astype(np.uint16)
    elif ns.profile_stages:
        # reference stage: the blocking render map/read
        # (clEnqueueMapBuffer d_render, e.g. vlpgrid .c:662-668)
        rgba = timer.run(
            "read render data",
            lambda: quantize_film(film, wrap=quirks.wrap_uint8).cpu().numpy(),
            items=w * h * 4, item_label="uchar", data_size=w * h * 4)
    else:
        rgba = quantize_film(film, wrap=quirks.wrap_uint8).cpu().numpy()
    t0 = time.perf_counter()
    save_pam(out_name, ImgInfo(width=w, height=h, channels=4,
                               maxval=ns.pam_maxval,
                               depth=8 if ns.pam_maxval == 255 else 16,
                               data=rgba))
    timer.record("write render data", (time.perf_counter() - t0) * 1e3,
                 items=w * h * 4, item_label="uchar",
                 data_size=w * h * 4 * (1 if ns.pam_maxval == 255 else 2))
    print(f"\nSuccessfully created render image {out_name} in the current "
          "directory\n")
    timer.print_report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
