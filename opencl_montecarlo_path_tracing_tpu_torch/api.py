"""Unified rendering entry point.

Port of ``opencl_montecarlo_path_tracing_tpu/api.py``.  ``render(variant,
...)`` keeps the JAX package's call signature and adds ``device``.  All
nine variants are ported: ``simplecpu`` (the NumPy oracle, which renders
on the host by definition), ``simple``, ``super``, ``superlmem``,
``nodof``, ``trianglegrid``, ``bidirectional``, ``metropolis`` and
``metropolis_vlpgrid``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.rng import make_key
from .core.quirks import Quirks, DEFAULT
from .scene.scene import Scene
from .utils.profiling import span

VARIANTS = ("simplecpu", "simple", "super", "superlmem", "nodof",
            "trianglegrid", "bidirectional", "metropolis",
            "metropolis_vlpgrid")


def render(variant: str, scene: Scene | None = None, width: int = 512,
           height: int = 512, spp: int = 64, seed: int = 0,
           quirks: Quirks = DEFAULT, as_rgba8: bool = False,
           device="cuda", **kw):
    """Render with an integrator on ``device``.

    Extra options by variant: simplecpu: gpu_layout, max_depth, key,
    row_offset; simple: spp_offset, spp_total, max_bounces; trianglegrid:
    cell_size_modifier, device_build, accel ("auto" | "dda");
    bidirectional: n_vlp, use_grid, grid_modifier; metropolis*:
    n_seedpaths, mutation_rounds, grid_modifier, verify_eps,
    dynamic_grid_res.

    Returns the pre-ambient float film (H, W, 3) as a tensor on ``device``,
    or the final RGBA8 image as a numpy (H, W, 4) uint8 array when
    ``as_rgba8``; ``nodof`` always returns the image (its reduction
    quantises on the device).  A CUDA ``device`` renders with the CUDA
    kernels and raises when no GPU is present; it never renders on the CPU
    instead.  ``simplecpu`` is the reference's CPU tracer: it renders on
    the host whatever ``device`` says, and its film is then moved there.
    """
    with span("pt.render"):
        with span("pt.route"):
            film = _film(variant, scene, width, height, spp, seed, quirks,
                         device, kw)
        if variant == "nodof":
            with span("pt.readback"):
                return film.cpu().numpy()
        if as_rgba8:
            from .ops.reduce import quantize_film
            with span("pt.quantize"):
                img = quantize_film(film, wrap=quirks.wrap_uint8)
            with span("pt.readback"):
                return img.cpu().numpy()
        return film


def _film(variant, scene, width, height, spp, seed, quirks, device, kw):
    """:func:`render`'s film on ``device`` (``nodof``: its RGBA8 image,
    which its reduction quantises on the device)."""
    key = make_key(seed)
    if variant == "simplecpu":
        from .models.common import check_device
        from .models.oracle import render_oracle
        device = check_device(device)
        film = torch.from_numpy(render_oracle(width, height, spp=spp,
                                              seed=seed, **kw)).to(device)
    elif variant == "simple":
        from .models.simple import render_simple
        film = render_simple(key, width, height, spp=spp, quirks=quirks,
                             device=device, **kw)
    elif variant == "nodof":
        from .models.sample_parallel import render_sample_parallel
        sg = int(round(np.sqrt(spp)))
        if sg * sg != spp:
            raise ValueError("nodof needs a square spp (sample grid)")
        film = render_sample_parallel(key, scene, width, height,
                                      sample_grid=sg, quirks=quirks,
                                      device=device, **kw)
    elif variant in ("super", "superlmem"):
        from .models.super import render_super
        film = render_super(key, scene, width, height, spp=spp,
                            quirks=quirks, device=device, **kw)
    elif variant == "trianglegrid":
        from .models.trianglegrid import render_trianglegrid
        film = render_trianglegrid(key, scene, width, height, spp=spp,
                                   quirks=quirks, device=device, **kw)
    elif variant == "bidirectional":
        from .models.bidirectional import render_bidirectional
        film = render_bidirectional(key, scene, width, height, spp=spp,
                                    quirks=quirks, device=device, **kw)
    elif variant in ("metropolis", "metropolis_vlpgrid"):
        from .models.metropolis import render_metropolis
        if variant.endswith("vlpgrid"):
            kw.setdefault("use_grid", True)
        film = render_metropolis(key, scene, width, height, spp=spp,
                                 quirks=quirks, device=device, **kw)
    else:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return film
