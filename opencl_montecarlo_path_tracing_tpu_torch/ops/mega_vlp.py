"""The VLP megakernel (kernel B4): wrapper, gate, table and plain version.

``film_vlp_mega`` renders the pre-ambient (rows, W, 3) float32 film of the
VLP render pass - the bidirectional / metropolis / metropolis_vlpgrid
family: B1's camera and closest hit, the dense (or grid-limited) VLP
gather, one occlusion per light capped at the light distance, clamp,
subtract, /4, shading, spp accumulation - in one launch of the
hand-written CUDA kernel ``csrc/mega_vlp.cu``.  It replaces the TPU kernel
``opencl_montecarlo_path_tracing_tpu/ops/pallas_bpt.py::film_vlp_mega`` ->
``_vlp_mega_kernel``.

The wrapper builds the VLP table on the device: live rows first (a stable
compaction), each row (px, py, pz, max(I, 0), |p|^2) padded to 8 floats,
and in grid mode six more floats - the VLP's clipped cell-index box, the
binning of ``ops/grid.py::build_grid_cellscan`` - padded to 12.  The live
count reaches the kernel as a device int32, so the host never waits.  The
kernel scans every live row, masked by cell membership in grid mode, so
it is uncapped where the tier-1 grid gather keeps at most 62 items a cell:
the two agree wherever no live VLP overflows a cell.

``film_vlp_mega_plain`` is the same function in plain PyTorch - the
tier-1 composition ``accumulate_spp(sample_super(illum_fn=illum_vlp))``
with its dense gather pinned to the scan - on any device.  The wrapper
takes it only when the film's device is the CPU; on a CUDA device it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quirks import Quirks, DEFAULT
from ..models import common as C
from .intersect import SceneArrays
from .mega_super import MAX_LIGHTS, MAX_SMEM_TRIANGLES, _u32_arg, pack_scene
from .vlp import vlp_aabbs

#: Launches of the CUDA kernel since the last reset (the wrapper adds one
#: per launch and nowhere else).
LAUNCHES = 0

DENSE_STRIDE = 8    # floats per table row: px py pz I |p|^2 + 3 pad
GRID_STRIDE = 12    # + clo.xyz chi.xyz + 1 pad
CHUNK_ROWS = 256    # VLP rows the kernel stages in shared memory at a time


def unsupported_reason(scn: SceneArrays, quirks: Quirks = DEFAULT,
                       max_bounces: int = C.MAX_BOUNCES) -> str | None:
    """Why the kernel cannot render this configuration, or None when it
    can (the port's form of ``pallas_bpt.supported()``)."""
    if quirks.shadow_carry_t:
        return ("the shadow_carry_t quirk (_lmem reference mode): the VLP "
                "megakernel does not cover it")
    nl = int(scn.lights.shape[0])
    if nl > MAX_LIGHTS:
        return (f"{nl} lights: the VLP megakernel covers <= {MAX_LIGHTS} "
                "lights (8 RNG sites per bounce)")
    if max_bounces < 1:
        return f"max_bounces={max_bounces}: the VLP megakernel runs one bounce"
    nt = int(scn.tri_v0.shape[0])
    if nt > MAX_SMEM_TRIANGLES:
        return (f"{nt} triangles: the VLP megakernel stages <= "
                f"{MAX_SMEM_TRIANGLES} triangles in shared memory")
    return None


def vlp_table(vlps, grid=None):
    """The kernel's (nvp, 8|12) float32 VLP table, live rows first (stable),
    and the live count as a (1,) int32 tensor, both on ``vlps``' device;
    in grid mode also the 9 grid floats (vmin, cell size, resolution)."""
    vlps = vlps.to(torch.float32)
    live = vlps[:, 3] > 0
    order = torch.argsort((~live).to(torch.int32), stable=True)
    v = vlps[order]
    n_live = live.sum().to(torch.int32).reshape(1)
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    cols = [p0, p1, p2, torch.clamp_min(v[:, 3], 0.0),
            p0 * p0 + p1 * p1 + p2 * p2]
    zero = torch.zeros_like(p0)
    gridp = None
    if grid is None:
        cols += [zero] * 3
    else:
        # clipped cell-index box, exactly as pallas_bpt.py:376-391: dead
        # VLPs' far boxes clip to the corner cell, beyond n_live anyway
        amin, amax = vlp_aabbs(v)
        res_f = torch.as_tensor(grid.res, dtype=torch.float32,
                                device=v.device)
        vmin = grid.vmin.to(v.device)
        cell = grid.cell_size.to(v.device)
        clo = torch.minimum(torch.clamp_min(
            torch.floor((amin - vmin) / cell), 0.0), res_f - 1.0)
        chi = torch.minimum(torch.clamp_min(
            torch.floor((amax - vmin) / cell), 0.0), res_f - 1.0)
        cols += list(clo.unbind(1)) + list(chi.unbind(1)) + [zero]
        gridp = torch.cat([vmin, cell, res_f]).contiguous()
    tab = torch.stack(cols, dim=1)
    if tab.shape[0] == 0:
        tab = torch.zeros((1, len(cols)), dtype=torch.float32,
                          device=v.device)
    return tab.contiguous(), n_live, gridp


def film_vlp_mega_plain(key, scn: SceneArrays, vlps, width: int,
                        height: int, spp: int, spp_offset: int = 0,
                        spp_total: int | None = None,
                        quirks: Quirks = DEFAULT, row_offset: int = 0,
                        rows: int | None = None, grid=None, device="cpu",
                        max_bounces: int = C.MAX_BOUNCES):
    """Plain PyTorch version of :func:`film_vlp_mega` (same signature and
    output), on any device; its dense gather is the plain scan."""
    from ..models.bidirectional import film_vlp_plain
    device = torch.device(device)
    if spp_total is None:
        spp_total = spp
    return film_vlp_plain(key, scn, torch.as_tensor(vlps, device=device),
                          grid, width, height, spp, spp_offset, spp_total,
                          quirks, max_bounces, row_offset, rows, device)


def film_vlp_mega(key, scn: SceneArrays, vlps, width: int, height: int,
                  spp: int, spp_offset: int = 0,
                  spp_total: int | None = None, quirks: Quirks = DEFAULT,
                  row_offset: int = 0, rows: int | None = None, grid=None,
                  device="cuda", chunk_rows: int = CHUNK_ROWS):
    """Pre-ambient (rows, W, 3) float32 film of the band
    [row_offset, row_offset+rows) with global samples
    [spp_offset, spp_offset+spp) of spp_total, gathering the (V, 4) VLP
    table ``vlps`` (grid-limited when ``grid`` is an ops/grid.py
    ``UniformGrid`` over it), on ``device``.

    On a CUDA device: one launch of the CUDA kernel; raises
    ``NotImplementedError`` for a configuration it does not cover.  On the
    CPU: :func:`film_vlp_mega_plain`.  ``chunk_rows`` sets how many table
    rows the kernel stages at a time; the film does not depend on it."""
    global LAUNCHES
    device = torch.device(device)
    if spp_total is None:
        spp_total = spp
    if rows is None:
        rows = height
    if quirks is None:
        quirks = DEFAULT
    if device.type == "cpu":
        return film_vlp_mega_plain(key, scn, vlps, width, height, spp,
                                   spp_offset, spp_total, quirks,
                                   row_offset, rows, grid, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    reason = unsupported_reason(scn, quirks)
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
    tab, n_live, gridp = vlp_table(torch.as_tensor(vlps, device=device),
                                   grid)
    stride = DENSE_STRIDE if gridp is None else GRID_STRIDE
    out = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
    for name, t, dt in (("scene", buf, torch.float32),
                        ("vlp table", tab, torch.float32),
                        ("n_live", n_live, torch.int32),
                        ("grid", gridp, torch.float32),
                        ("out", out, torch.float32)):
        if t is not None and (t.device != out.device or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{out.device}")
    if tab.shape[1] != stride or tab.shape[0] >= 1 << 27:
        raise ValueError(f"bad VLP table shape {tuple(tab.shape)}")
    if not 1 <= int(chunk_rows) <= 4096:
        raise ValueError(f"chunk_rows={chunk_rows} outside [1, 4096]")
    nl = int(scn.lights.shape[0])
    inv_nl = float(np.float32(1.0 / nl)) if nl else 0.0

    from ..utils.build import load
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mega_vlp_launch(
            buf.data_ptr(), ntp, nl, int(scn.sphere_centers.shape[0]),
            int(scn.square_k.shape[0]),
            _u32_arg("k0", key[0]), _u32_arg("k1", key[1]),
            _u32_arg("spp_offset", spp_offset),
            _u32_arg("spp_total", spp_total),
            _u32_arg("row_offset", row_offset), rows, width, spp,
            int(bool(quirks.accept_negative_t)), tab.data_ptr(),
            int(tab.shape[0]), stride, int(chunk_rows), n_live.data_ptr(),
            None if gridp is None else gridp.data_ptr(), inv_nl,
            out.data_ptr(), stream)
    if err != 0:
        msg = lib.mega_vlp_error_string(err).decode()
        raise RuntimeError(f"mega_vlp launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return out
