"""The super megakernels (kernel B1; kernels B2/B3): wrappers, gate and
plain version.

``film_super_mega`` renders the pre-ambient (rows, W, 3) float32 film of
the mirror-free ``super`` family - threefry draws, thin-lens camera,
closest hit, one shadow ray per light (uncapped, or the _lmem carry-t
quirk), 4-material shading, spp accumulation - in one launch of a
hand-written CUDA kernel.  Both replace the TPU kernel
``opencl_montecarlo_path_tracing_tpu/ops/pallas_super.py::film_super_mega``
-> ``_mega_kernel``, chosen by mesh size as there:

* ``csrc/mega_super.cu`` (B1, the SMEM tier) for <= 512 triangles: the
  whole triangle table in shared memory, scanned by every ray;
* ``csrc/mega_blocked.cu`` (B2/B3, the blocked and stream tiers) for 513
  to 2^20 triangles: each camera and shadow ray, one lane a ray, walks
  the exact uniform grid of ``ops/exact_grid.py`` (built once per
  prepared scene and device).  ``force_blocked`` picks it on any mesh
  (tests).

The gate is the JAX ``supported()``: <= 8 lights and <= 2^20 triangles.

``film_super_mega_plain`` is the same function in plain PyTorch (the
tier-1 wavefront of models/super.py, whose meshes of >= 2048 triangles go
through kernel B7's plain version), on any device.  The wrapper takes it
only when the film's device is the CPU; on a CUDA device it launches a
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import make_camera
from ..core.quirks import Quirks, DEFAULT
from ..models import common as C
from ..utils.profiling import span
from .intersect import SceneArrays, _tri_table, derived

#: Launches of the B1 kernel since the last reset (the wrapper adds one
#: per launch and nowhere else).
LAUNCHES = 0
#: Launches of the B2/B3 kernel since the last reset (likewise).
BLOCKED_LAUNCHES = 0

MAX_SMEM_TRIANGLES = 512   # B1: the TPU kernel's SMEM tier
MAX_TRIANGLES = 1 << 20    # B2/B3: the stream tier's cap
MAX_LIGHTS = 8             # shadow-ray sites per bounce (SITE_STRIDE_BOUNCE)
_TRI_PAD = 8               # B1's triangle rows pad to a multiple of this


def unsupported_reason(scn: SceneArrays) -> str | None:
    """Why no kernel can render ``scn``, or None when one can (the port's
    form of the TPU kernel's ``supported()`` gate)."""
    nt = int(scn.tri_v0.shape[0])
    if nt > MAX_TRIANGLES:
        return (f"{nt} triangles: the CUDA super kernels cover <= "
                f"{MAX_TRIANGLES} (the stream tier's cap)")
    nl = int(scn.lights.shape[0])
    if nl > MAX_LIGHTS:
        return (f"{nl} lights: the super kernels cover <= {MAX_LIGHTS} "
                "lights (8 RNG sites per bounce)")
    return None


def uses_blocked(scn: SceneArrays, force_blocked: bool | None = None) -> bool:
    """Whether ``film_super_mega`` launches B2/B3 (else B1) for ``scn``."""
    nt = int(scn.tri_v0.shape[0])
    if force_blocked is not None:
        return bool(force_blocked) and nt > 0
    return nt > MAX_SMEM_TRIANGLES


def pack_scene(scn: SceneArrays, triangles: bool = True
               ) -> tuple[np.ndarray, int]:
    """The kernel's float32 scene buffer and its padded triangle count:
    [ntp*12 triangle table][camera up, right, eye_offset, pos]
    [nl*4 lights][ns*3 sphere centres][nq square k][nq square z].
    Padding rows are all zeros: det = 0 never hits.  ``triangles=False``
    leaves the table out (ntp = 0), as B2/B3 and B4's walk find theirs in
    a grid."""
    nt = int(scn.tri_v0.shape[0]) if triangles else 0
    ntp = -(-nt // _TRI_PAD) * _TRI_PAD
    tbl = np.zeros((ntp, 12), np.float32)
    if nt:
        tbl[:nt] = _tri_table(scn)
    cam = make_camera(z_sign=-1.0)
    parts = [tbl, cam.up, cam.right, cam.eye_offset, cam.pos, scn.lights,
             scn.sphere_centers, scn.square_k, scn.square_z]
    buf = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                          for a in parts])
    return buf, ntp


def scene_buffer(scn: SceneArrays, device, triangles: bool = True) -> tuple:
    """(``pack_scene`` buffer, padded triangle count) on ``device``, built
    once per prepared scene and device (B4's and the light pass's scene;
    with ``triangles=False`` the triangle-free one B2/B3, B4's walk and
    B11 read)."""
    def make(s):
        buf, ntp = pack_scene(s, triangles=triangles)
        return torch.from_numpy(buf).to(device), ntp
    name = "mega_super.scene_buffer" + ("" if triangles else "/bare")
    return derived(scn, name, device, make)


def film_super_mega_plain(key, scn: SceneArrays, width: int, height: int,
                          spp: int, spp_offset: int = 0,
                          spp_total: int | None = None,
                          quirks: Quirks = DEFAULT, row_offset: int = 0,
                          rows: int | None = None, device="cpu"):
    """Plain PyTorch version of :func:`film_super_mega` (same signature and
    output), on any device."""
    from ..models.super import film_super_plain
    if spp_total is None:
        spp_total = spp
    return film_super_plain(key, scn, width, height, spp, spp_offset,
                            spp_total, quirks, C.MAX_BOUNCES, row_offset,
                            rows, torch.device(device))


def _u32_arg(name: str, v) -> int:
    v = int(v)
    if not 0 <= v < 1 << 32:
        raise ValueError(f"{name}={v} is not a uint32")
    return v


def film_super_mega(key, scn: SceneArrays, width: int, height: int,
                    spp: int, spp_offset: int = 0,
                    spp_total: int | None = None, quirks: Quirks = DEFAULT,
                    row_offset: int = 0, rows: int | None = None,
                    device="cuda", force_blocked: bool | None = None):
    """Pre-ambient (rows, W, 3) float32 film of the band
    [row_offset, row_offset+rows) with global samples
    [spp_offset, spp_offset+spp) of spp_total, on ``device``.

    On a CUDA device: one launch of B1 (<= 512 triangles) or B2/B3 (larger
    meshes, or ``force_blocked``); raises ``NotImplementedError`` for a
    scene outside the gate.  On the CPU: :func:`film_super_mega_plain`."""
    device = torch.device(device)
    if spp_total is None:
        spp_total = spp
    if rows is None:
        rows = height
    if quirks is None:
        quirks = DEFAULT
    if device.type == "cpu":
        return film_super_mega_plain(key, scn, width, height, spp,
                                     spp_offset, spp_total, quirks,
                                     row_offset, rows, device)
    blocked = uses_blocked(scn, force_blocked)
    route = "mega_blocked" if blocked else "mega_super"
    with span("pt.kernel." + route):
        return _film_cuda(key, scn, width, rows, spp, spp_offset, spp_total,
                          quirks, row_offset, device, blocked)


def _film_cuda(key, scn, width, rows, spp, spp_offset, spp_total, quirks,
               row_offset, device, blocked):
    """``film_super_mega`` on a non-CPU ``device``: the checks, ``out``
    and one launch of B2/B3 (``blocked``) or B1."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    reason = unsupported_reason(scn)
    if reason is not None:
        raise NotImplementedError(reason)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "false; the port never renders a CUDA request on the CPU")
    width, rows, spp = int(width), int(rows), int(spp)
    if width <= 0 or rows <= 0 or spp < 0:
        raise ValueError(f"bad film shape/spp: {rows}x{width}, spp={spp}")
    if rows * width >= 1 << 31:
        raise ValueError(f"{rows}x{width} pixels exceed the int32 index")
    out = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
    args = (_u32_arg("k0", key[0]), _u32_arg("k1", key[1]),
            _u32_arg("spp_offset", spp_offset),
            _u32_arg("spp_total", spp_total),
            _u32_arg("row_offset", row_offset), rows, width, spp,
            int(bool(quirks.accept_negative_t)),
            int(bool(quirks.shadow_carry_t)))
    if blocked:
        _launch_blocked(scn, args, out, None)
    else:
        _launch_smem(scn, args, out)
    return out


def _check(tensors, device):
    for name, t in tensors:
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_smem(scn: SceneArrays, args, out):
    """One launch of B1 into ``out``."""
    global LAUNCHES
    with span("pt.pack"):
        buf_np, ntp = pack_scene(scn)
        buf = torch.from_numpy(buf_np).to(out.device)
    _check((("scene", buf), ("out", out)), out.device)
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(out.device):
        err = lib.mega_super_launch(
            buf.data_ptr(), ntp, int(scn.lights.shape[0]),
            int(scn.sphere_centers.shape[0]), int(scn.square_k.shape[0]),
            *args, out.data_ptr(), _stream(out.device))
    if err != 0:
        msg = lib.mega_super_error_string(err).decode()
        raise RuntimeError(
            f"mega_super launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1


def block_tables(scn: SceneArrays, device) -> tuple:
    """(scene, rows, boxes, subs, nodes) on ``device``, built once
    per prepared scene: ``pack_scene`` without triangles and the float32
    tables of ``tri_blocks.walk_tables`` (the light pass's culled walk,
    ``ops/light_pass.py``, reads them past 2,048 triangles)."""
    from .tri_blocks import walk_tables

    def make(scn):
        buf, _ = pack_scene(scn, triangles=False)
        return tuple(torch.from_numpy(t).to(device)
                     for t in (buf, *walk_tables(scn)))
    return derived(scn, "mega_super.block_tables", device, make)


def _launch_blocked(scn: SceneArrays, args, out, stats):
    """One launch of B2/B3 into ``out`` over the scene without triangles
    and the exact grid of its mesh; ``stats`` (a zeroed int64 tensor of
    ``len(STAT_NAMES)`` slots, or None) makes it the counting
    instantiation, which adds its work tally there
    (:func:`blocked_stats`)."""
    global BLOCKED_LAUNCHES
    from .exact_grid import check_tables, exact_grid
    buf, _ = scene_buffer(scn, out.device, triangles=False)
    xg = exact_grid(scn, out.device)
    _check((("scene", buf), ("out", out)), out.device)
    check_tables(xg, out.device)
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(out.device):
        err = lib.mega_blocked_launch(
            buf.data_ptr(), int(scn.lights.shape[0]),
            int(scn.sphere_centers.shape[0]), int(scn.square_k.shape[0]),
            xg.rows.data_ptr(), xg.span.data_ptr(), xg.occ.data_ptr(),
            xg.ids.data_ptr(), xg.frame.data_ptr(), *xg.res, *args,
            out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            _stream(out.device))
    if err != 0:
        msg = lib.mega_blocked_error_string(err).decode()
        raise RuntimeError(
            f"mega_blocked launch failed: CUDA error {err} ({msg})")
    BLOCKED_LAUNCHES += 1


#: B2/B3's work tally, in the order of its slots (csrc/mega_blocked.cu,
#: Slot).
STAT_NAMES = ("cam_rest", "cam_tri", "shadow_rest", "shadow_tri", "kernel",
              "casts", "casts_tri", "tested", "walks", "entered", "cells",
              "empty", "pairs", "clk_setup", "clk_empty", "clk_loads",
              "clk_pairs", "clk_step")


def blocked_stats(key, scn: SceneArrays, width: int, height: int, spp: int,
                  spp_offset: int = 0, spp_total: int | None = None,
                  quirks: Quirks = DEFAULT, device="cuda") -> dict:
    """B2/B3's work over one render of this configuration (one launch of
    the counting instantiation on ``device``, on a mesh of any size; the
    film is discarded):

    * ``casts``: shadow rays cast (a floor or diffuse hit facing a light);
      ``casts_tri``: those that walk the grid (the any-hit rays the floor,
      squares and spheres do not occlude; under ``shadow_carry_t`` every
      cast);
    * summed over lanes: ``walks`` (the camera rays of the film's pixels
      and ``casts_tri``), ``entered`` (walks that enter the grid),
      ``cells`` visited, ``empty`` cells among them, ``pairs`` the lanes
      test (the bound's work; pairs a walk against the mesh's triangles is
      the rate at which the grid culls), ``tested``: the pairs the warps
      pay (32 lanes x their pair iterations, at least ``pairs``);
    * clock64 cycles summed over warps: ``cam_rest`` / ``cam_tri``, the
      camera trace's floor, squares and spheres / its walk;
      ``shadow_rest`` / ``shadow_tri`` likewise for the shadow rays;
      ``kernel``, the whole kernel (the rest - threefry, camera, shading -
      is ``kernel`` less the others); and the walks' cycles split:
      ``clk_setup`` (the DDA set-up), ``clk_empty`` (iterations in which
      no lane tests a pair: empty cells and their steps), ``clk_loads``
      and ``clk_pairs`` (the occupied cells' row loads and pair
      arithmetic), ``clk_step`` (their end tests and steps).  The counting
      instantiation walks a warp's lanes in lockstep (each occupied step
      runs its lanes' largest cell); its film is the timed one's."""
    device = torch.device(device)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    stats = torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=device)
    args = (_u32_arg("k0", key[0]), _u32_arg("k1", key[1]),
            _u32_arg("spp_offset", spp_offset),
            _u32_arg("spp_total", spp if spp_total is None else spp_total),
            0, int(height), int(width), int(spp),
            int(bool(quirks.accept_negative_t)),
            int(bool(quirks.shadow_carry_t)))
    _launch_blocked(scn, args, out, stats)
    return dict(zip(STAT_NAMES, stats.tolist()))
