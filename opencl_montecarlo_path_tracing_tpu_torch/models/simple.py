"""Wavefront equivalent of CLSimplePathTracer, on PyTorch tensors.

Port of ``opencl_montecarlo_path_tracing_tpu/models/simple.py``.  On a
CUDA device the whole film is one launch of kernel B5
(``ops/mega_simple.py`` + ``csrc/mega_simple.cu``); on the CPU the plain
wavefront below runs, which is also the kernel's plain version.  There is
no switch between the two other than the device.

Reference: CLSimplePathTracer/spt.ocl - per-pixel megakernel, 64 spp, 5
unrolled bounces, bitmap spheres are mirrors (material 2, spt.ocl:68), floor
is a lambertian checkerboard, sky above.  Single implicit jittered light at
(9 + r1, 9 + r2, 16) (spt.ocl:99).

Here: one ray batch per sample and a bounce loop of ``max_bounces``
iterations with live masks.  It is the one integrator whose bounce loop
really recurses (a path makes up to 5 chained trace -> shadow -> shade ->
reflect rounds), unlike the super family's one-bounce cut.
"""

from __future__ import annotations

import torch

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..core.camera import make_camera, primary_rays
from ..ops.intersect import SceneArrays, prep_scene, trace_ray, any_hit
from ..scene.scene import simple_scene
from . import common as C

_SIMPLE_SCENE = simple_scene()


def simple_arrays() -> SceneArrays:
    """The business-card scene's arrays: floor + 49 mirror spheres."""
    return prep_scene(_SIMPLE_SCENE)


def sample_simple(key, scn: SceneArrays, quirks: Quirks, max_bounces: int,
                  s, ii, jj, ray_id):
    """One sample for every pixel; returns (R, 3) color (the JAX
    ``_sample``)."""
    r1, r2, r3, r4 = rngmod.randn_draws(key, ray_id, C.SITE_CAMERA, 4)
    cam = make_camera(z_sign=-1.0)
    o, d = primary_rays(cam, ii, jj, r1, r2, r3, r4)

    R = ray_id.shape
    dev = ray_id.device
    zero3 = torch.zeros(R + (3,), dtype=torch.float32, device=dev)
    state = (
        torch.ones(R, dtype=torch.bool, device=dev),        # alive
        o, d,
        zero3,                                              # colorFact
        torch.ones(R, dtype=torch.float32, device=dev),     # divFact
        zero3,                                              # result
    )

    def step(b, state):
        alive, o, d, color_fact, div, result = state
        tr = trace_ray(o, d, scn, quirks=quirks, sphere_material=2,
                       plain=True)
        m = torch.where(alive, tr.material, -1)

        # miss -> sky (spt.ocl:92-95)
        sky = color_fact + C.sky_color(d[..., 2]) / div[..., None]
        result = torch.where((m == 0)[..., None], sky, result)

        x = o + d * tr.t[..., None]
        u1, u2 = rngmod.rand2(key, ray_id,
                              C.SITE_LIGHT0 + b * C.SITE_STRIDE_BOUNCE)
        light_pos = torch.stack([9.0 + u1, 9.0 + u2,
                                 torch.full_like(u1, 16.0)], dim=-1)
        ldir = C.normalize(light_pos - x)
        half = C.reflect(d, tr.normal)
        lamb = C.dot(ldir, tr.normal)
        shadowed = any_hit(x, ldir, scn, quirks=quirks, plain=True)
        lamb = torch.where((lamb < 0) | shadowed, 0.0, lamb)
        spec = C.pow99(C.dot(ldir, half) * (lamb > 0))

        # floor -> checkerboard * (lamb*0.2 + 0.1) (spt.ocl:112-115)
        fl = (color_fact + C.floor_color(x) * (lamb * 0.2 + 0.1)[..., None]
              / div[..., None])
        result = torch.where((m == 1)[..., None], fl, result)

        # mirror sphere -> add specular highlight, bounce (spt.ocl:120-125);
        # the reference multiplies the highlight by divFact (spt.ocl:121,
        # quirks.specular_divfact_multiply), intended math divides
        bounce = m == 2
        hl = spec[..., None] * (div[..., None] if quirks.specular_divfact_multiply
                                else 1.0 / div[..., None])
        color_fact = torch.where(bounce[..., None], color_fact + hl, color_fact)
        o = torch.where(bounce[..., None], x, o)
        d = torch.where(bounce[..., None], half, d)
        div = torch.where(bounce, div * 2.0, div)
        alive = alive & bounce
        return alive, o, d, color_fact, div, result

    alive, _, _, color_fact, _, result = C.bounce_loop(step, state,
                                                       max_bounces)
    # recursion-cap exhaustion: reference falls off the end of Sample (UB,
    # spt.ocl:89-127); intended math returns the accumulated highlights.
    return torch.where(alive[..., None], color_fact, result)


def film_simple_plain(key, width, height, spp, spp_offset=0,
                      spp_total=None, quirks: Quirks = DEFAULT,
                      max_bounces: int = C.MAX_BOUNCES, row_offset=0,
                      rows=None, device="cpu"):
    """The plain wavefront film (pre-ambient (rows, W, 3) float32) on any
    device: kernel B5's plain version on the business-card scene."""
    from ..ops.mega_simple import film_simple_mega_plain
    return film_simple_mega_plain(key, simple_arrays(), width, height, spp,
                                  spp_offset, spp_total, quirks, row_offset,
                                  rows, max_bounces, device)


def film_simple(key, width, height, spp, spp_offset, spp_total,
                quirks: Quirks = DEFAULT, max_bounces: int = C.MAX_BOUNCES,
                device="cuda"):
    """Pre-ambient (H, W, 3) float32 film on ``device``: one launch of
    kernel B5 on a CUDA device (a launch failure raises; there is no
    fallback), the plain wavefront on the CPU."""
    device = C.check_device(device)
    if device.type == "cuda":
        from ..ops.mega_simple import film_simple_mega
        return film_simple_mega(key, simple_arrays(), width, height, spp,
                                spp_offset, spp_total, quirks,
                                max_bounces=max_bounces, device=device)
    return film_simple_plain(key, width, height, spp, spp_offset, spp_total,
                             quirks, max_bounces, device=device)


def render_simple(key, width: int = 512, height: int = 512, spp: int = 64,
                  spp_offset: int = 0, spp_total: int | None = None,
                  quirks: Quirks = DEFAULT, max_bounces: int = C.MAX_BOUNCES,
                  device="cuda"):
    """Render the business-card scene; returns the pre-ambient float film
    (H, W, 3) on ``device``.  Finalize with ops/reduce.py::quantize_film."""
    if spp_total is None:
        spp_total = spp
    return film_simple(key, width, height, spp, spp_offset, spp_total,
                       quirks, max_bounces, device=device)
