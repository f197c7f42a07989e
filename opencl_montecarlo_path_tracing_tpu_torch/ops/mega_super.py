"""The super megakernel (kernel B1): wrapper, gate and plain version.

``film_super_mega`` renders the pre-ambient (rows, W, 3) float32 film of
the mirror-free ``super`` family - threefry draws, thin-lens camera,
closest hit, one shadow ray per light (uncapped, or the _lmem carry-t
quirk), 4-material shading, spp accumulation - in one launch of the
hand-written CUDA kernel ``csrc/mega_super.cu``.  It replaces the TPU
kernel ``opencl_montecarlo_path_tracing_tpu/ops/pallas_super.py::
film_super_mega`` -> ``_mega_kernel`` in its SMEM tier (<= 512 triangles);
the blocked and stream tiers for larger meshes (ROADMAP B2/B3) are not
ported yet.

``film_super_mega_plain`` is the same function in plain PyTorch (the
tier-1 wavefront of models/super.py), on any device.  The wrapper takes it
only when the film's device is the CPU; on a CUDA device it launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import make_camera
from ..core.quirks import Quirks, DEFAULT
from ..models import common as C
from .intersect import SceneArrays, _tri_table

#: Launches of the CUDA kernel since the last reset (the wrapper adds one
#: per launch and nowhere else).
LAUNCHES = 0

MAX_TRIANGLES = 512   # the TPU kernel's SMEM tier (_MAX_SMEM_TRIANGLES)
MAX_LIGHTS = 8        # shadow-ray sites per bounce (SITE_STRIDE_BOUNCE)
_TRI_PAD = 8          # triangle table rows pad to a multiple of this


def unsupported_reason(scn: SceneArrays) -> str | None:
    """Why the kernel cannot render ``scn``, or None when it can (the
    port's form of the TPU kernel's ``supported()`` gate)."""
    nt = int(scn.tri_v0.shape[0])
    if nt > MAX_TRIANGLES:
        return (f"{nt} triangles: the CUDA super kernel covers <= "
                f"{MAX_TRIANGLES} (the SMEM tier); larger meshes need the "
                "blocked/stream tiers, ROADMAP queue B items B2/B3")
    nl = int(scn.lights.shape[0])
    if nl > MAX_LIGHTS:
        return (f"{nl} lights: the super kernel covers <= {MAX_LIGHTS} "
                "lights (8 RNG sites per bounce)")
    return None


def pack_scene(scn: SceneArrays) -> tuple[np.ndarray, int]:
    """The kernel's float32 scene buffer and its padded triangle count:
    [ntp*12 triangle table][camera up, right, eye_offset, pos]
    [nl*4 lights][ns*3 sphere centres][nq square k][nq square z].
    Padding rows are all zeros: det = 0 never hits."""
    nt = int(scn.tri_v0.shape[0])
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
                    device="cuda"):
    """Pre-ambient (rows, W, 3) float32 film of the band
    [row_offset, row_offset+rows) with global samples
    [spp_offset, spp_offset+spp) of spp_total, on ``device``.

    On a CUDA device: one launch of the CUDA kernel; raises
    ``NotImplementedError`` for a scene it does not cover.  On the CPU:
    :func:`film_super_mega_plain`."""
    global LAUNCHES
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

    buf_np, ntp = pack_scene(scn)
    buf = torch.from_numpy(buf_np).to(device)
    out = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
    for name, t in (("scene", buf), ("out", out)):
        if t.device != out.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {out.device}")

    from ..utils.build import load
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mega_super_launch(
            buf.data_ptr(), ntp, int(scn.lights.shape[0]),
            int(scn.sphere_centers.shape[0]), int(scn.square_k.shape[0]),
            _u32_arg("k0", key[0]), _u32_arg("k1", key[1]),
            _u32_arg("spp_offset", spp_offset),
            _u32_arg("spp_total", spp_total),
            _u32_arg("row_offset", row_offset), rows, width, spp,
            int(bool(quirks.accept_negative_t)),
            int(bool(quirks.shadow_carry_t)), out.data_ptr(), stream)
    if err != 0:
        msg = lib.mega_super_error_string(err).decode()
        raise RuntimeError(
            f"mega_super launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return out
