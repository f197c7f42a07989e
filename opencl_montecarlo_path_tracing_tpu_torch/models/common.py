"""Shared sample-loop machinery for the integrators, on PyTorch tensors.

Port of ``opencl_montecarlo_path_tracing_tpu/models/common.py``.  Every
integrator's plain path is a *wavefront*: one flat ray batch per sample
pass, a bounce loop with live-ray masks, and a film accumulator.
"""

from __future__ import annotations

import numpy as np
import torch

AMBIENT = np.float32(13.0)    # base radiance (pathtracer.ocl:224)
EXPOSURE = np.float32(3.5)    # per-sample scale (pathtracer.ocl:237)
MAX_BOUNCES = 5               # unrolled recursion depth (pathtracer.ocl:156)
SKY = np.array([0.7, 0.6, 1.0], np.float32)   # pathtracer.ocl:160
FLOOR_RED = np.array([3, 1, 1], np.float32)   # checkerboard (ocl:197)
FLOOR_WHITE = np.array([3, 3, 3], np.float32)
DIFFUSE = np.array([2, 3, 2], np.float32)     # material 3 (ocl:200)

# RNG draw-site map (see core/rng.py): sites must be unique per logical draw.
SITE_CAMERA = 0
SITE_LIGHT0 = 2          # + bounce * 8 + light_index   (light jitter draws)
SITE_STRIDE_BOUNCE = 8   # supports up to 8 lights/bounce (MAX_LIGHTS is 5)

_MASK = 0xFFFFFFFF


def check_device(device) -> torch.device:
    """The film's device; a CUDA request without a GPU raises (the port
    never renders a CUDA request on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "false; the port never renders a CUDA request on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def dot(a, b):
    """Sum over the last axis of length 3, in the order x + y + z."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def pow99(x):
    """x**99 for float32 via binary exponentiation (99 = 64+32+2+1); keeps
    the sign of a negative base, as OpenCL pow(x, 99) does (spt.ocl:110)."""
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    x32 = x16 * x16
    x64 = x32 * x32
    return x64 * x32 * x2 * x


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def sky_color(dz):
    """(0.7, 0.6, 1) * (1 - dz)^4 (pathtracer.ocl:160)."""
    f = 1.0 - dz
    f2 = f * f
    return _const(SKY, dz) * (f2 * f2)[..., None]


def floor_color(x):
    """Checkerboard: intersection*0.2, (int)(ceil+ceil)&1 (pathtracer.ocl:196-197)."""
    ip = x * float(np.float32(0.2))
    sel = (torch.ceil(ip[..., 0]) + torch.ceil(ip[..., 1])).to(torch.int32) & 1
    return torch.where((sel == 1)[..., None], _const(FLOOR_RED, x),
                       _const(FLOOR_WHITE, x))


def reflect(d, n):
    """half_vec = d - 2 (n.d) n (pathtracer.ocl:210)."""
    return d + n * (dot(n, d) * -2.0)[..., None]


def pixel_grid(width: int, height: int, row_offset: int = 0,
               rows: int | None = None, device="cpu"):
    """Flattened float32 pixel coordinate tensors (i = x/gid0, j = y/gid1),
    row-major so film.reshape(rows, W) matches img[j*W + i].
    ``row_offset``/``rows`` select a horizontal band."""
    if rows is None:
        rows = height
    jj, ii = torch.meshgrid(
        torch.arange(rows, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device), indexing="ij")
    jj = jj + float(row_offset)
    return ii.reshape(-1), jj.reshape(-1)


def accumulate_spp(sample_fn, width: int, height: int, spp: int,
                   spp_offset: int = 0, spp_total: int | None = None,
                   row_offset: int = 0, rows: int | None = None,
                   device="cpu"):
    """Run ``sample_fn(sample_index, i, j, ray_id) -> (R, 3)`` for ``spp``
    samples and return the pre-ambient film (rows, W, 3) float32 (sum of
    samples * EXPOSURE, matching pathtracer.ocl:237).

    ``spp_offset``/``spp_total`` define the global sample-index window and
    ``row_offset``/``rows`` the image band.  The RNG is keyed on
    ``ray_id = pixel * spp_total + sample``, which wraps modulo 2**32
    exactly as the JAX package's uint32 arithmetic does; ``ray_id`` is an
    int64 tensor holding the uint32 value.
    """
    if spp_total is None:
        spp_total = spp
    if rows is None:
        rows = height
    ii, jj = pixel_grid(width, height, row_offset, rows, device)
    # the pixel index is formed in float32 and then made an integer, as in
    # the JAX package (exact below 2**24 pixels)
    pixel_index = (jj * width + ii).to(torch.int64) & _MASK
    film = torch.zeros((width * rows, 3), dtype=torch.float32, device=device)
    for s in range(spp):
        s32 = (s + int(spp_offset)) & _MASK
        ray_id = (pixel_index * (int(spp_total) & _MASK) + s32) & _MASK
        film = film + sample_fn(s32, ii, jj, ray_id)
    return (film * float(EXPOSURE)).reshape(rows, width, 3)


def bounce_loop(step_fn, init_state, max_bounces: int = MAX_BOUNCES):
    """for b in range(max_bounces): state = step_fn(b, state) - a loop with
    a static trip count and live-ray masks."""
    state = init_state
    for b in range(max_bounces):
        state = step_fn(b, state)
    return state
