"""Sample-parallel tracer + on-device film reduction (the ``nodof`` variant).

Port of ``opencl_montecarlo_path_tracing_tpu/models/sample_parallel.py``.

Reference: CLSuperPathTracer_lmem_NoDoF (SURVEY.md section 2 #7) restructures
spp as a *spatial* decomposition: gws = (W*8, H*8), one work item computes
ONE sample (pixel = gid >> 3) into a float4 temp buffer, and a second kernel
``reduce4img_lmem`` tree-reduces the 8x8 = 64 samples per pixel, adds the
ambient term and converts to uchar4 (pathtracer.ocl:217-274).

Here the samples are a batch axis: :func:`sample_buffer` materialises the
whole (H*sg, W*sg) sample buffer in one wavefront pass (one camera-jitter
draw per sample) and ``ops/reduce.py::reduce_samples`` reduces it on the
buffer's device.  The reference's shipped directory opens a non-existent
planes.txt (CLSuperPathTracer.c:303, crashes); squares.txt is loaded as
intended.

RNG streams use the same (pixel*spp + sample) keying as render_super, so at
sample_grid=8 the summed buffer equals render_super(spp=64) up to float
summation order - a tested invariant.  That is also why a CUDA device can
route the image through the super megakernel (B1, or B2/B3 on large
meshes), as the JAX package does on the TPU.
"""

from __future__ import annotations

import torch

from ..core.quirks import Quirks, DEFAULT
from ..ops.intersect import SceneArrays, prep_scene
from ..ops.reduce import quantize_film, reduce_samples
from ..scene.scene import Scene
from . import common as C
from .super import cuda_route, sample_super

_MASK = 0xFFFFFFFF


def sample_buffer(key, scn: SceneArrays, width, height, sample_grid,
                  quirks, max_bounces=C.MAX_BOUNCES, row_offset=0,
                  rows: int | None = None, device="cpu"):
    """(rows*sg, W*sg, 3) float32 on ``device``: each slot =
    Sample(...) * 3.5 for one sample of its pixel (pathtracer.ocl:249).

    ``row_offset`` and ``rows`` select a horizontal band of *pixel* rows.
    Ray ids stay keyed on the global pixel index, so band content is
    identical to the corresponding slice of the full buffer.  On a CUDA
    device this is the tier-1 wavefront on the card (kernel B7 for its
    traces on meshes of >= 2048 triangles)."""
    device = C.check_device(device)
    sg = int(sample_grid)
    spp = sg * sg
    if rows is None:
        rows = height
    bigw, bigh = width * sg, rows * sg
    jj, ii = torch.meshgrid(
        torch.arange(bigh, dtype=torch.int32, device=device),
        torch.arange(bigw, dtype=torch.int32, device=device), indexing="ij")
    jj = jj + int(row_offset) * sg
    px = (ii // sg).to(torch.float32).reshape(-1)
    py = (jj // sg).to(torch.float32).reshape(-1)
    s = ((ii % sg) + (jj % sg) * sg).to(torch.int64).reshape(-1)
    # the pixel index is formed in float32 and then made an integer, as in
    # the JAX package
    pixel_index = (py * width + px).to(torch.int64) & _MASK
    ray_id = (pixel_index * spp + s) & _MASK
    colors = sample_super(key, scn, quirks, max_bounces, s, px, py, ray_id)
    return (colors * float(C.EXPOSURE)).reshape(bigh, bigw, 3)


def render_sample_parallel(key, scene: Scene | SceneArrays, width: int = 512,
                           height: int = 512, sample_grid: int = 8,
                           quirks: Quirks = DEFAULT,
                           max_bounces: int = C.MAX_BOUNCES,
                           return_samples: bool = False, row_offset: int = 0,
                           rows: int | None = None, device="cuda"):
    """The final (rows, W, 4) uint8 image on ``device`` (and the float
    sample buffer when ``return_samples``).

    On a CUDA device, when the buffer is not requested and
    ``models/super.py::cuda_route`` is not ``"tier1"``, the image is one
    launch of the super megakernel with spp = sg^2 (B1, or B2/B3 on meshes
    above 512 triangles) and its quantisation: ray ids are keyed
    (pixel*spp + sample) in both layouts, so the kernel's spp accumulation
    computes the same per-pixel sum as the reduction, to float summation
    order (a uint8 may move one step).  Otherwise the sample buffer is
    built by the tier-1 wavefront on ``device`` and reduced there."""
    device = C.check_device(device)
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if rows is None:
        rows = height
    if (not return_samples and device.type == "cuda"
            and cuda_route(scn, max_bounces) != "tier1"):
        from ..ops.mega_super import film_super_mega
        spp = sample_grid * sample_grid
        film = film_super_mega(key, scn, width, height, spp, quirks=quirks,
                               row_offset=row_offset, rows=rows,
                               device=device)
        return quantize_film(film, wrap=quirks.wrap_uint8)
    buf = sample_buffer(key, scn, width, height, sample_grid, quirks,
                        max_bounces, row_offset, rows, device)
    img = reduce_samples(buf, sample_grid, wrap=quirks.wrap_uint8)
    return (img, buf) if return_samples else img
