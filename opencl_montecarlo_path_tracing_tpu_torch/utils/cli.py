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
resolution, one host read of the VLP box), and --device (default
``cuda``; a CUDA device renders with the CUDA kernels and the command
fails when no GPU is present).  ``simple`` and ``simplecpu`` read no scene
files; the lws0 positional of the simple tracer is accepted and ignored;
``nodof`` renders an 8x8 sample grid per pixel (its --spp is not read);
``simplecpu`` is the reference's CPU tracer, rendered on the host
whatever --device says, at 256x256 by default.  The JAX CLI's
--checkpoint, --shard and --profile-stages options are not ported.

Output: a PAM (P7) RGBA file (default result.ppm, resultCPU.ppm for
simplecpu) plus a per-stage timing report in the reference's format (e.g.
CLSuperPathTracer.c:321-325).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _positional(args, i, default, cast=int):
    return cast(args[i]) if len(args) > i else default


class _Report:
    """Per-stage lines in the reference's format:
    ``name : N items in Xms: Y GB/s``."""

    def __init__(self):
        self.lines = []
        self.total = 0.0

    def record(self, name, ms, items, item_label, data_size):
        gbs = data_size / 1.0e6 / ms if ms > 0 else float("inf")
        self.lines.append(f"{name} : {items} {item_label} in {ms:g}ms: "
                          f"{gbs:g} GB/s")
        self.total += ms

    def print(self):
        print("\n".join(self.lines + ["", f"Total time: {self.total:g} ms."]))


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
    ap.add_argument("--pam-maxval", type=int, choices=[255, 65535],
                    default=255,
                    help="output sample depth: 255 = the reference's RGBA8; "
                         "65535 writes 16-bit PAM")
    ap.add_argument("--dynamic-grid-res", action="store_true",
                    help="metropolis_vlpgrid: derive the grid resolution "
                         "from the VLP box as the reference does (one "
                         "device->host read)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
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
    report = _Report()
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
        t0 = time.perf_counter()
        film = torch.from_numpy(render_oracle(w, h, spp=ns.spp, seed=seed,
                                              gpu_layout=False))
        report.record("rendering (host)", (time.perf_counter() - t0) * 1e3,
                      items=w * h, item_label="float", data_size=w * h * 4)
        return _write(ns, out_name, film, None, w, h, quirks, report)

    device = torch.device(ns.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print(f"error: device {device} requested but no CUDA device is "
                  "available", file=sys.stderr)
            return 1
        print(f"Using device: {device} ({torch.cuda.get_device_name(device)})")
    else:
        print(f"Using device: {device}")

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

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    img = None
    items, item_label, data_size = w * h, "pixels", w * h * 4
    if ns.variant == "simple":
        from ..models.simple import render_simple
        stage = "rendering"
        film = render_simple(key, w, h, spp=ns.spp, quirks=quirks,
                             device=device)
    elif ns.variant == "nodof":
        from ..models.sample_parallel import render_sample_parallel
        stage = "rendering+reduction"
        items, item_label, data_size = w * h * 64, "samples", w * h * 64 * 16
        film = None
        img = render_sample_parallel(key, scene, w, h, sample_grid=8,
                                     quirks=quirks, device=device)
    elif ns.variant in ("super", "superlmem"):
        from ..models.super import render_super
        stage = "rendering"
        film = render_super(key, scene, w, h, spp=ns.spp, quirks=quirks,
                            device=device)
    elif ns.variant == "trianglegrid":
        from ..models.trianglegrid import render_trianglegrid
        stage = "grid init + rendering"
        film = render_trianglegrid(
            key, scene, w, h, spp=ns.spp,
            cell_size_modifier=_positional(pos, 2, 3.0, float),
            quirks=quirks, device=device)
    elif ns.variant == "bidirectional":
        from ..models.bidirectional import render_bidirectional
        stage = "light pass + rendering"
        film = render_bidirectional(key, scene, w, h, spp=ns.spp,
                                    n_vlp=_positional(pos, 2, 512),
                                    quirks=quirks, device=device)
    else:
        from ..models.metropolis import render_metropolis
        stage = "light pass + metropolis + rendering"
        film = render_metropolis(
            key, scene, w, h, spp=ns.spp,
            n_seedpaths=_positional(pos, 2, 512),
            mutation_rounds=_positional(pos, 3, 8),
            grid_modifier=_positional(pos, 4, 3.0, float),
            use_grid=ns.variant.endswith("vlpgrid"),
            dynamic_grid_res=ns.dynamic_grid_res, quirks=quirks,
            device=device)
    sync()
    report.record(stage, (time.perf_counter() - t0) * 1e3,
                  items=items, item_label=item_label, data_size=data_size)
    return _write(ns, out_name, film, img, w, h, quirks, report)


def _write(ns, out_name, film, img, w, h, quirks, report) -> int:
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
    else:
        rgba = quantize_film(film, wrap=quirks.wrap_uint8).cpu().numpy()
    t0 = time.perf_counter()
    save_pam(out_name, ImgInfo(width=w, height=h, channels=4,
                               maxval=ns.pam_maxval,
                               depth=8 if ns.pam_maxval == 255 else 16,
                               data=rgba))
    report.record("write render data", (time.perf_counter() - t0) * 1e3,
                  items=w * h * 4, item_label="uchar",
                  data_size=w * h * 4 * (1 if ns.pam_maxval == 255 else 2))
    print(f"\nSuccessfully created render image {out_name} in the current "
          "directory\n")
    report.print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
