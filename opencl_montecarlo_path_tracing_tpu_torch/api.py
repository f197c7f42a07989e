"""Unified rendering entry point.

Port of ``opencl_montecarlo_path_tracing_tpu/api.py``.  ``render(variant,
...)`` keeps the JAX package's call signature and adds ``device``.  The
``super``, ``superlmem``, ``trianglegrid``, ``bidirectional``,
``metropolis`` and ``metropolis_vlpgrid`` variants are ported; every other
variant raises ``NotImplementedError`` naming the ROADMAP item that ports
it.
"""

from __future__ import annotations

from .core.rng import make_key
from .core.quirks import Quirks, DEFAULT
from .scene.scene import Scene

VARIANTS = ("simplecpu", "simple", "super", "superlmem", "nodof",
            "trianglegrid", "bidirectional", "metropolis",
            "metropolis_vlpgrid")

# ROADMAP.md queue A (modules) and queue B (kernels) items of the variants
# not ported yet
NOT_PORTED = {
    "simplecpu": "ROADMAP A10 (utilities and CLI: the NumPy oracle)",
    "simple": "ROADMAP A7 (simple) with kernel B5",
    "nodof": "ROADMAP A6 (nodof)",
}


def render(variant: str, scene: Scene | None = None, width: int = 512,
           height: int = 512, spp: int = 64, seed: int = 0,
           quirks: Quirks = DEFAULT, as_rgba8: bool = False,
           device="cuda", **kw):
    """Render with an integrator on ``device``.

    Extra options by variant: trianglegrid: cell_size_modifier,
    device_build, accel ("auto" | "dda"); bidirectional: n_vlp, use_grid,
    grid_modifier; metropolis*: n_seedpaths, mutation_rounds,
    grid_modifier, verify_eps, dynamic_grid_res.

    Returns the pre-ambient float film (H, W, 3) as a tensor on ``device``,
    or the final RGBA8 image as a numpy (H, W, 4) uint8 array when
    ``as_rgba8``.  A CUDA ``device`` renders with the CUDA kernels and
    raises when no GPU is present; it never renders on the CPU instead.
    """
    if variant in NOT_PORTED:
        raise NotImplementedError(
            f"variant {variant!r} is not ported to PyTorch yet: "
            f"{NOT_PORTED[variant]}")
    key = make_key(seed)
    if variant in ("super", "superlmem"):
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
    if as_rgba8:
        from .ops.reduce import quantize_film
        return quantize_film(film, wrap=quirks.wrap_uint8).cpu().numpy()
    return film
