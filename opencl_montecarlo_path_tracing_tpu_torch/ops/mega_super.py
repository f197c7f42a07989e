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
  to 2^20 triangles: Morton blocks of 128 triangles
  (``ops/tri_blocks.py``) walked behind per-warp AABB votes.
  ``force_blocked`` picks it on any mesh (tests).

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
    leaves the table out (ntp = 0), as B2/B3 take theirs apart."""
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
    if uses_blocked(scn, force_blocked):
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
    tables of ``tri_blocks.walk_tables``."""
    from .tri_blocks import walk_tables

    def make(scn):
        buf, _ = pack_scene(scn, triangles=False)
        return tuple(torch.from_numpy(t).to(device)
                     for t in (buf, *walk_tables(scn)))
    return derived(scn, "mega_super.block_tables", device, make)


def _launch_blocked(scn: SceneArrays, args, out, stats):
    """One launch of B2/B3 into ``out``; ``stats`` (a zeroed
    (``STAT_SLOTS``,) int64 tensor, or None) makes it the counting
    instantiation, which adds its work tally there (:func:`blocked_stats`)."""
    global BLOCKED_LAUNCHES
    buf, rows_t, boxes, subs, nodes = block_tables(scn, out.device)
    _check((("scene", buf), ("rows", rows_t), ("boxes", boxes),
            ("subs", subs), ("nodes", nodes), ("out", out)), out.device)
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(out.device):
        err = lib.mega_blocked_launch(
            buf.data_ptr(), int(scn.lights.shape[0]),
            int(scn.sphere_centers.shape[0]), int(scn.square_k.shape[0]),
            rows_t.data_ptr(), boxes.data_ptr(), int(boxes.shape[0]),
            subs.data_ptr(), nodes.data_ptr(), int(nodes.shape[0]), *args,
            out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            _stream(out.device))
    if err != 0:
        msg = lib.mega_blocked_error_string(err).decode()
        raise RuntimeError(
            f"mega_blocked launch failed: CUDA error {err} ({msg})")
    BLOCKED_LAUNCHES += 1


#: Slots of B2/B3's work tally (csrc/mega_blocked.cu, Tally).
STAT_SLOTS = 9


def blocked_stats(key, scn: SceneArrays, width: int, height: int, spp: int,
                  spp_offset: int = 0, spp_total: int | None = None,
                  quirks: Quirks = DEFAULT, device="cuda") -> dict:
    """B2/B3's work over one render of this configuration (one launch of
    the counting instantiation on ``device``; the film is discarded):

    * ``needed``: (ray, triangle) pairs in the 128-row blocks whose box the
      ray's own test passes when the near-to-far block walk of the design
      the tree replaced (replayed by the counting launch) tests it - the
      bound's yardstick, unchanged;
    * ``sub_needed``: this design's own need, the rows of the 32-row
      sub-blocks whose box the ray's own test passes in the tree walk;
    * ``tested``: pairs the warps test (32 lanes x the rows a warp scans);
    * ``macro_tests``: box tests of tree nodes (the macro level and above),
      ``block_tests`` and ``sub_tests``: of blocks and 32-row sub-blocks;
    * ``walk_cycles``, ``scan_cycles``, ``kernel_cycles``: clock64 cycles
      summed over warps, in the walks' box tests and votes, in the row
      scans, and in the whole kernel."""
    device = torch.device(device)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    stats = torch.zeros(STAT_SLOTS, dtype=torch.int64, device=device)
    args = (_u32_arg("k0", key[0]), _u32_arg("k1", key[1]),
            _u32_arg("spp_offset", spp_offset),
            _u32_arg("spp_total", spp if spp_total is None else spp_total),
            0, int(height), int(width), int(spp),
            int(bool(quirks.accept_negative_t)),
            int(bool(quirks.shadow_carry_t)))
    _launch_blocked(scn, args, out, stats)
    v = stats.tolist()
    return {"needed": v[0], "tested": v[1], "macro_tests": v[2],
            "block_tests": v[3], "sub_tests": v[4],
            "walk_cycles": v[5] - v[6], "scan_cycles": v[6],
            "kernel_cycles": v[7], "sub_needed": v[8]}
