"""The simple-tracer megakernel (kernel B5): wrapper and plain version.

``film_simple_mega`` renders the pre-ambient (rows, W, 3) float32 film of
the ``simple`` variant - threefry draws, thin-lens camera, up to
``max_bounces`` chained rounds of closest hit over the floor and the
mirror spheres, a jittered implicit light with an uncapped shadow ray,
checkerboard / sky shading and the colorFact/divFact recursion
accumulators in both quirk modes, spp accumulation - in one launch of the
hand-written CUDA kernel ``csrc/mega_simple.cu``.  It replaces the TPU
kernel ``opencl_montecarlo_path_tracing_tpu/ops/pallas_simple.py::
film_simple_mega`` -> ``_simple_mega_kernel``.  The kernel tests the
spheres behind a per-warp cull over :func:`sphere_groups`.

``film_simple_mega_plain`` is the same function in plain PyTorch (the
wavefront of models/simple.py), on any device.  The wrapper takes it only
when the film's device is the CPU; on a CUDA device it launches the
kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.quirks import Quirks, DEFAULT
from ..models import common as C
from .intersect import SceneArrays, derived
from .mega_super import _check, _stream, _u32_arg, pack_scene

#: Launches of the B5 kernel since the last reset (the wrapper adds one per
#: launch and nowhere else).
LAUNCHES = 0


def _check_scene(scn: SceneArrays):
    """The simple tracer's scene is the floor and its spheres; the kernel
    (like the TPU kernel) reads nothing else, so anything else is refused
    rather than ignored."""
    extra = {"squares": scn.square_k.shape[0], "triangles": scn.tri_v0.shape[0],
             "lights": scn.lights.shape[0]}
    extra = {k: int(v) for k, v in extra.items() if int(v)}
    if extra:
        raise ValueError(f"the simple tracer renders the floor and spheres "
                         f"only; this scene also has {extra}")


#: Most spheres in one group of :func:`sphere_groups`.
MAX_GROUP = 16


def sphere_groups(centers: np.ndarray) -> np.ndarray:
    """(n_groups + 1, 8) float32 records of the kernel's sphere cull:
    lo.xyz, first sphere (int32 bits), hi.xyz, sphere count (int32 bits),
    the box of the group's unit spheres.  Record 0 is the whole card (every
    sphere); the groups are the runs of consecutive spheres (index order)
    that share a centre x - the columns of the business card, as
    ``bitmap_to_spheres`` lists them - at most ``MAX_GROUP`` each."""
    c = np.asarray(centers, np.float32).reshape(-1, 3)
    runs, start = [], 0
    for k in range(1, len(c) + 1):
        if (k == len(c) or c[k, 0] != c[start, 0]
                or k - start == MAX_GROUP):
            runs.append((start, k))
            start = k
    recs = np.zeros((len(runs) + 1, 8), np.float32)
    for r, (a, b) in enumerate([(0, len(c))] + runs):
        if b > a:
            recs[r, 0:3] = c[a:b].min(axis=0) - 1.0
            recs[r, 4:7] = c[a:b].max(axis=0) + 1.0
        recs[r, 3:4] = np.array([a], np.int32).view(np.float32)
        recs[r, 7:8] = np.array([b - a], np.int32).view(np.float32)
    return recs


def kernel_inputs(scn: SceneArrays, device) -> tuple:
    """(scene buffer, sphere groups) on ``device``, built once per prepared
    scene: the camera and the sphere centres (``pack_scene`` without
    triangles; the scene has no lights or squares) and
    :func:`sphere_groups`."""
    def make(s):
        buf, _ = pack_scene(s, triangles=False)
        return (torch.from_numpy(buf).to(device),
                torch.from_numpy(sphere_groups(s.sphere_centers)).to(device))
    return derived(scn, "mega_simple.kernel_inputs", device, make)


def film_simple_mega_plain(key, scn: SceneArrays, width: int, height: int,
                           spp: int, spp_offset: int = 0,
                           spp_total: int | None = None,
                           quirks: Quirks | None = None, row_offset: int = 0,
                           rows: int | None = None,
                           max_bounces: int = C.MAX_BOUNCES, device="cpu"):
    """Plain PyTorch version of :func:`film_simple_mega` (same signature and
    output), on any device."""
    from ..models.simple import sample_simple
    _check_scene(scn)
    sample_fn = functools.partial(sample_simple, key, scn,
                                  DEFAULT if quirks is None else quirks,
                                  int(max_bounces))
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset,
                            spp_total=spp if spp_total is None else spp_total,
                            row_offset=row_offset, rows=rows,
                            device=torch.device(device))


def film_simple_mega(key, scn: SceneArrays, width: int, height: int,
                     spp: int, spp_offset: int = 0,
                     spp_total: int | None = None,
                     quirks: Quirks | None = None, row_offset: int = 0,
                     rows: int | None = None,
                     max_bounces: int = C.MAX_BOUNCES, device="cuda"):
    """Pre-ambient (rows, W, 3) float32 film of the band
    [row_offset, row_offset+rows) with global samples
    [spp_offset, spp_offset+spp) of spp_total, on ``device``.

    On a CUDA device: one launch of B5.  On the CPU:
    :func:`film_simple_mega_plain`."""
    global LAUNCHES
    device = torch.device(device)
    if spp_total is None:
        spp_total = spp
    if rows is None:
        rows = height
    if quirks is None:
        quirks = DEFAULT
    if device.type == "cpu":
        return film_simple_mega_plain(key, scn, width, height, spp,
                                      spp_offset, spp_total, quirks,
                                      row_offset, rows, max_bounces, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check_scene(scn)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "false; the port never renders a CUDA request on the CPU")
    width, rows, spp = int(width), int(rows), int(spp)
    max_bounces = int(max_bounces)
    if width <= 0 or rows <= 0 or spp < 0 or max_bounces < 0:
        raise ValueError(f"bad film shape/spp/bounces: {rows}x{width}, "
                         f"spp={spp}, max_bounces={max_bounces}")
    if rows * width >= 1 << 31:
        raise ValueError(f"{rows}x{width} pixels exceed the int32 index")
    out = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
    device = out.device          # "cuda" names the current card: cuda:N
    buf, groups = kernel_inputs(scn, device)
    _check((("scene", buf), ("groups", groups), ("out", out)), device)
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(device):
        err = lib.mega_simple_launch(
            buf.data_ptr(), int(scn.sphere_centers.shape[0]),
            groups.data_ptr(), int(groups.shape[0]) - 1,
            _u32_arg("k0", key[0]), _u32_arg("k1", key[1]),
            _u32_arg("spp_offset", spp_offset),
            _u32_arg("spp_total", spp_total),
            _u32_arg("row_offset", row_offset), rows, width, spp,
            max_bounces, int(bool(quirks.specular_divfact_multiply)),
            out.data_ptr(), _stream(device))
    if err != 0:
        msg = lib.mega_simple_error_string(err).decode()
        raise RuntimeError(
            f"mega_simple launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return out
