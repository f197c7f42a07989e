"""Virtual point light (VLP) ops: emission, dense gather, grid gather.

Port of ``opencl_montecarlo_path_tracing_tpu/ops/vlp.py`` on PyTorch
tensors.

Reference (SURVEY.md section 2 #10/#12):
 * ``lightTracer`` emits one VLP per (work item, light): a uniform-sphere
   direction from the light, one bounce, VLP = (hit position,
   material-scaled intensity / (total_vlp / 512))
   (bidirectionalpathtracer.ocl:230-326).
 * The render pass gathers ALL VLPs per shading point with no shadow rays
   (occlusion commented out, ocl:179-182).
 * The vlpgrid variant bins VLPs into a uniform grid (radius heuristic
   16*sqrt(intensity), metropolispathtracer.ocl:551-554) and gathers only
   the shading point's cell (ocl vlpgrid:326-349).

The emission runs on a CUDA device in kernel L1 (``ops/light_pass.py``);
``plain=True`` keeps it on the batched PyTorch below on any device.  The dense gather has two forms with
the same semantics: the plain scan below, and kernel B6
(``ops/gather_vlp.py``), which ``gather_vlps`` takes on a CUDA device for
large batches, exactly where the JAX package takes its MXU kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from .intersect import SceneArrays, trace_ray
from . import grid as gridmod

# RNG draw-site bases (see core/rng.py and models/common.py)
SITE_VLP_DIR = 64      # + light index (emission directions)

# material -> VLP base intensity (bidirectionalpathtracer.ocl:265-276)
_BPT_BASE = {1: 70.0, 2: 5.0, 3: 40.0}
# metropolis variant uses different constants and a /256 denominator
# (metropolispathtracer.ocl:416-426)
_MLT_BASE = {1: 400.0, 2: 10.0, 3: 40.0}

_TWO_PI = float(np.float32(2.0 * np.pi))


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def uniform_sphere(u1, u2):
    """Uniform direction on S^2 (same distribution as the reference's
    Marsaglia rejection loop, ocl:318-323, without data-dependent trips)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = _TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def vlp_from_light_sample(o, direction, light_intensity, scale_den,
                          scn: SceneArrays, quirks: Quirks, base=_BPT_BASE,
                          plain: bool = False):
    """SampleFromLightSource (ocl:230-278) batched: trace one ray from the
    light, return (V, 4) = (hit position, scaled intensity); zeros on miss
    or non-emissive material.  ``light_intensity`` is a float or a per-row
    tensor; ``plain`` as in ``trace_ray``."""
    tr = trace_ray(o, direction, scn, quirks=quirks, sphere_material=3,
                   plain=plain)
    x = o + direction * tr.t[..., None]
    lamb = _dot(direction, tr.normal)
    q = o - x
    dist2 = _dot(q, q)
    # a tensor numerator: torch evaluates float / tensor as a reciprocal
    # times the float, which rounds twice
    li = torch.as_tensor(light_intensity, dtype=torch.float32,
                         device=dist2.device)
    lamb = torch.where(lamb < 0, 0.0,
                       lamb * torch.clamp_max(li / dist2, 1.0))
    lamb = torch.clamp_max(lamb, 1.0)
    m = tr.material
    base_i = torch.zeros_like(lamb)
    for mat, val in base.items():
        base_i = torch.where(m == mat, float(np.float32(val)), base_i)
    intensity = base_i * lamb / float(np.float32(scale_den))
    hit = m != 0
    pos = torch.where(hit[..., None], x, 0.0)
    intensity = torch.where(hit, intensity, 0.0)
    return torch.cat([pos, intensity[..., None]], dim=-1)


def emit_vlps(key, scn: SceneArrays, n_vlp: int, quirks: Quirks = DEFAULT,
              gi0: int = 0, count: int | None = None, device="cuda",
              plain: bool = False):
    """lightTracer pass (ocl:280-326): (nlights * n_vlp, 4) VLPs, laid out
    vlp[gi + l * n_vlp] like the reference's strided write (ocl:324).

    total_vlp scaling: intensity /= (total_vlp / 512) with the reference's
    INTEGER division (ocl:267), guarded to >= 1.

    ``gi0``/``count`` restrict emission to the work-item window
    [gi0, gi0+count) of each light; every draw keys on the GLOBAL gi (and
    scale_den on the global n_vlp), so a window's rows are bit-identical
    to the same rows of the full emission.

    On a CUDA device: one launch of kernel L1 (``ops/light_pass.py::
    light_route``); on the CPU, or with ``plain=True``, the batched
    PyTorch below on ``device`` (``plain`` also keeps its traces of large
    meshes on kernel B7's plain version).  A CUDA request without a GPU
    raises."""
    from . import light_pass
    from ..models.common import check_device
    device = check_device(device)
    if count is None:
        count = n_vlp
    if not plain and light_pass.light_route(device) == "light_pass":
        return light_pass.emit(key, scn, n_vlp, quirks, gi0, count, device)
    nlights = int(scn.lights.shape[0])
    total_vlp = n_vlp * nlights
    scale_den = max(1, total_vlp // 512)
    gi = torch.arange(count, dtype=torch.int64, device=device) + int(gi0)

    dirs = []
    for l in range(nlights):
        site = SITE_VLP_DIR if quirks.reuse_light_direction else SITE_VLP_DIR + l
        u1, u2 = rngmod.rand2(key, gi, site)
        dirs.append(uniform_sphere(u1, u2))
    out = []
    for l in range(nlights):
        lp = torch.as_tensor(scn.lights[l, :3], dtype=torch.float32,
                             device=device)
        o = lp.expand(count, 3)
        d = dirs[0] if quirks.reuse_light_direction else dirs[l]
        out.append(vlp_from_light_sample(o, d, float(scn.lights[l, 3]),
                                         scale_den, scn, quirks,
                                         plain=plain))
    if not out:
        return torch.zeros((0, 4), dtype=torch.float32, device=device)
    return torch.cat(out, dim=0)


# ray-count and VLP-count thresholds above which kernel B6 replaces the
# scan on a CUDA device (the JAX package's MXU thresholds)
_MXU_GATHER_MIN_RAYS = 2048
_MXU_GATHER_MIN_VLPS = 64
_SCAN_CHUNK = 64     # VLPs per elementwise (rays x chunk) pass of the scan


class LiveTable(NamedTuple):
    """A VLP table as kernel B6 reads it (:func:`live_table`): ``vlps`` the
    (V, 4) table as given, ``tab`` its (V, 8) float32 rows (px, py, pz,
    max(I, 0), |p|^2, 0, 0, 0) live rows first (stable), ``n_live`` the
    live count, a (1,) int32 tensor on the same device."""
    vlps: torch.Tensor
    tab: torch.Tensor
    n_live: torch.Tensor


def live_first(vlps):
    """The float32 rows of the (V, 4) table ``vlps`` live rows (I > 0)
    first, each kind in table order, and the live count as a (1,) int32
    tensor, both on ``vlps``' device: a stable partition without a sort,
    so the host never waits.  Kernels B4 and B6 scan the first n_live rows
    only; a dead row adds exactly +0.0 to a finite sum."""
    vlps = vlps.to(torch.float32)
    live = vlps[:, 3] > 0
    # each row's place among its kind
    li = live.to(torch.int64)
    n_live = li.sum()
    place = torch.where(live, torch.cumsum(li, 0) - 1,
                        n_live + torch.cumsum(1 - li, 0) - 1)
    v = torch.empty_like(vlps)
    v[place] = vlps
    return v, n_live.to(torch.int32).reshape(1)


def live_table(vlps) -> LiveTable:
    """The (V, 4) table ``vlps`` as kernel B6 reads it (:class:`LiveTable`,
    the dense layout of B4's ``ops/mega_vlp.py::vlp_table``), built on its
    device without waiting for it.  A caller that gathers against one table
    many times builds it once and passes it to :func:`gather_vlps` in place
    of ``vlps``."""
    v, n_live = live_first(vlps)
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    zero = torch.zeros_like(p0)
    tab = torch.stack([p0, p1, p2, torch.clamp_min(v[:, 3], 0.0),
                       p0 * p0 + p1 * p1 + p2 * p2, zero, zero, zero], dim=1)
    return LiveTable(vlps, tab.contiguous(), n_live)


def gather_vlps(x, n, vlps, impl: str | None = None):
    """Dense VLP gather: sum over ALL VLPs of max(lamb, 0) * min(I/d^2, 1)
    with no shadow rays (Sample's VLP loop, ocl:166-187).

    ``vlps``: the (V, 4) table, or its :class:`LiveTable`, which kernel B6
    reads as it is.  ``impl``: ``"scan"`` (plain PyTorch), ``"mxu"``
    (kernel B6's wrapper, ops/gather_vlp.py), or None: B6 on a CUDA device
    when there are at least 2048 rays and 64 VLPs, the scan otherwise."""
    raw = vlps.vlps if isinstance(vlps, LiveTable) else vlps
    if impl is None:
        use_mxu = (x.device.type == "cuda"
                   and int(np.prod(x.shape[:-1])) >= _MXU_GATHER_MIN_RAYS
                   and raw.shape[0] >= _MXU_GATHER_MIN_VLPS)
    else:
        use_mxu = impl == "mxu"
    if use_mxu:
        from .gather_vlp import gather_vlps_mxu
        return gather_vlps_mxu(x, n, vlps)
    return _gather_scan(x, n, raw)


def _gather_scan(x, n, vlps):
    """The plain scan: per-pair terms as the JAX scan forms them (the
    expanded distance, clamped at 1e-12), summed over the VLPs in table
    order.  Pairs are evaluated elementwise ``_SCAN_CHUNK`` VLPs at a time,
    then added column by column, so the sum order is the sequential one."""
    xx, xy, xz = (x[..., i:i + 1] for i in range(3))
    nx, ny, nz = (n[..., i:i + 1] for i in range(3))
    n_dot_x = nx * xx + ny * xy + nz * xz
    x_sq = xx * xx + xy * xy + xz * xz
    illum = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for c0 in range(0, vlps.shape[0], _SCAN_CHUNK):
        v = vlps[c0:c0 + _SCAN_CHUNK]
        v0, v1, v2, vi = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
        # n.(p-x) and |p-x|^2 expanded as in the JAX scan
        lamb_num = (nx * v0 + ny * v1 + nz * v2) - n_dot_x
        dist2 = torch.clamp_min(
            (v0 * v0 + v1 * v1 + v2 * v2)
            - 2.0 * (xx * v0 + xy * v1 + xz * v2) + x_sq, 1e-12)
        lamb = lamb_num / torch.sqrt(dist2)
        contrib = torch.where((vi > 0) & (lamb >= 0),
                              lamb * torch.clamp_max(vi / dist2, 1.0), 0.0)
        for j in range(contrib.shape[-1]):
            illum = illum + contrib[..., j]
    return illum


def vlp_bounds(vlps):
    """Device-resident VLP bounding box (replaces the reference's two-stage
    lmem reduction + BLOCKING host read, vlpgrid .c:597-611): each VLP with
    intensity > 0 contributes pos +- 16*sqrt(I)
    (reduceMinAndMax_lmem, metropolispathtracer.ocl:538-578)."""
    big = float(np.float32(3.4e38))
    if vlps.shape[0] == 0:     # no lights: the empty box
        full = torch.full((3,), big, dtype=torch.float32, device=vlps.device)
        return full, -full
    vi = vlps[:, 3]
    pos = vlps[:, :3]
    radius = 16.0 * torch.sqrt(torch.clamp_min(vi, 0.0))
    ok = vi > 0
    lo = torch.where(ok[:, None], pos - radius[:, None], big)
    hi = torch.where(ok[:, None], pos + radius[:, None], -big)
    return lo.amin(dim=0), hi.amax(dim=0)


def vlp_grid_static_res(n_vlp_total: int, modifier: float = 3.0,
                        max_res: int = 24):
    """Static grid resolution for the VLP grid: a cube from the VLP count
    alone, so the pipeline never waits on the device (the reference reads
    the reduced box back to the host, vlpgrid .c:629-636)."""
    r = int(np.floor(np.cbrt(max(1.0, modifier * n_vlp_total))))
    r = max(1, min(r, max_res))
    return (r, r, r)


def vlp_grid_dynamic_res(vmin, vmax, n_vlp_total: int,
                         modifier: float = 3.0, max_res: int = 128):
    """The reference's box-derived grid resolution (vlpgrid .c:629-636),
    host math on a reduced bounding box:

        grid_size = vmax - vmin
        cubeRoot  = cbrt(CELL_SIZE_MODIFIER * N_VLP / prod(grid_size))
        res_i     = clamp(floor(grid_size_i * cubeRoot), 1, 128)

    Degenerate or empty boxes (no live VLPs) clamp to the 1x1x1 grid."""
    size = np.maximum(np.asarray(vmax, np.float64)
                      - np.asarray(vmin, np.float64), 0.0)
    denom = float(size[0] * size[1] * size[2])
    if not np.isfinite(denom) or denom <= 0.0:
        return (1, 1, 1)
    cube = np.cbrt(modifier * n_vlp_total / denom)
    return tuple(int(max(1, min(int(np.floor(size[i] * cube)), max_res)))
                 for i in range(3))


def vlp_aabbs(vlps):
    """Per-VLP AABBs pos +- 16*sqrt(I); dead VLPs get an empty box far
    outside the grid (initVLPsGrid, metropolispathtracer.ocl:626-647)."""
    vi = vlps[:, 3]
    radius = 16.0 * torch.sqrt(torch.clamp_min(vi, 0.0))
    ok = vi > 0
    far = float(np.float32(3.0e38))
    amin = torch.where(ok[:, None], vlps[:, :3] - radius[:, None], far)
    amax = torch.where(ok[:, None], vlps[:, :3] + radius[:, None], far)
    return amin, amax


class GridFrame(NamedTuple):
    """A VLP grid's frame without its item lists: all that kernel B4 reads
    of a grid (``ops/mega_vlp.py::vlp_table`` bins each VLP itself)."""
    res: tuple               # (rx, ry, rz) Python ints
    vmin: torch.Tensor       # (3,) float32
    cell_size: torch.Tensor  # (3,) float32


def vlp_grid_frame(vlps, res) -> GridFrame:
    """The frame of :func:`build_vlp_grid`'s grid, from the same float
    operations: the VLP box's corner and the cell size (vmax - vmin) / res
    clamped at 1e-6."""
    vmin, vmax = vlp_bounds(vlps)
    cell = (vmax - vmin) / torch.as_tensor(res, dtype=torch.float32,
                                           device=vlps.device)
    cell = torch.clamp_min(cell, 1e-6)
    return GridFrame(tuple(int(r) for r in res), vmin, cell)


def build_vlp_grid(vlps, res, cap: int = gridmod.MAX_NELS_PER_CELL):
    """initVLPsGrid (metropolispathtracer.ocl:626-647) without atomics:
    AABBs = pos +- 16*sqrt(I), per-cell scan build (deterministic)."""
    f = vlp_grid_frame(vlps, res)
    amin, amax = vlp_aabbs(vlps)
    return gridmod.build_grid_cellscan(amin, amax, f.vmin, f.cell_size, res,
                                       cap=cap)


def gather_vlps_grid(x, n, vlps, grid: gridmod.UniformGrid):
    """Grid-limited VLP gather (vlpgrid Sample, metropolispathtracer.ocl
    vlpgrid:326-349): only the shading point's cell contributes, capped at
    the cell's ``cap`` listed items; points outside the grid get nothing
    (each axis is bounds-checked, the intended math)."""
    rx, ry, rz = grid.res
    res_f = torch.as_tensor(grid.res, dtype=torch.float32, device=x.device)
    cf = torch.floor((x - grid.vmin) / grid.cell_size)
    in_box = ((cf >= 0) & (cf < res_f)).all(dim=-1)
    c = torch.minimum(torch.clamp_min(cf, 0.0), res_f - 1.0).to(torch.int64)
    cell = c[..., 2] * (rx * ry) + c[..., 1] * rx + c[..., 0]
    cnt = grid.counts[cell]
    cap = grid.items.shape[1]
    rows = grid.items[cell]                               # (R, cap)
    vrows = vlps[torch.clamp_min(rows, 0).to(torch.int64)]  # (R, cap, 4)
    illum = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for kk in range(cap):
        idx = rows[:, kk]
        v = vrows[:, kk, :]
        live = in_box & (kk < cnt) & (idx >= 0)
        diff = v[:, :3] - x
        dist2 = torch.clamp_min(_dot(diff, diff), 1e-12)
        lamb = _dot(diff, n) / torch.sqrt(dist2)
        contrib = torch.where(live & (v[:, 3] > 0) & (lamb >= 0),
                              lamb * torch.clamp_max(v[:, 3] / dist2, 1.0),
                              0.0)
        illum = illum + contrib
    return illum
