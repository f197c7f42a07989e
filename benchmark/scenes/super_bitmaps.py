"""The super family's scene, as the upstream renderer reads it from its
text files: sphere centres and 2x2 squares expanded from the 9x19 bitmaps
(``pathtracer.ocl:73-108``, k = 18..0 outer, j = 8..0 inner), a triangle
mesh of the kind that ``mesh`` names (``benchmark/meshes/``), and point
lights (x, y, z, intensity)."""

from __future__ import annotations

import numpy as np

from benchmark.harness import spec as _spec


def bitmap_points(bits, plane: bool) -> np.ndarray:
    """Set bits of the 9x19 bitmap in the reference's loop order: sphere
    centres (k, 0, j + 4), or square (k, j) pairs when ``plane``."""
    out = []
    for k in range(18, -1, -1):
        for j in range(8, -1, -1):
            if int(bits[j]) & (1 << k):
                out.append((float(k), float(j)) if plane
                           else (float(k), 0.0, float(j + 4)))
    return np.asarray(out, np.float32).reshape(-1, 2 if plane else 3)


def make(spec: dict) -> dict:
    mesh = dict(spec["mesh"])
    kind = mesh.pop("kind")
    return {"spheres": bitmap_points(spec["sphere_bits"], plane=False),
            "squares": bitmap_points(spec["square_bits"], plane=True),
            "triangles": _spec.plugin("meshes", kind).make(**mesh),
            "lights": np.asarray(spec["lights"], np.float32).reshape(-1, 4)}
