"""SoA scene container: bitmap -> dense primitive expansion + AABBs.

Port of ``opencl_montecarlo_path_tracing_tpu/scene/scene.py`` (numpy only,
the same host structure).

The reference kernels loop over the full 9x19 bitmap per ray
(pathtracer.ocl:73-108, 171 slots per class); here the set bits are
expanded once on the host into dense center arrays, so the per-ray work is
proportional to the *actual* primitive count (the main scene has 2 spheres
and 4 squares).  The expansion order matches the reference loops
(k = 18..0 outer, j = 8..0 inner) so any order-dependent tie behaviour is
preserved.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import formats


def bitmap_to_spheres(bits: np.ndarray) -> np.ndarray:
    """(n, 3) float32 unit-sphere centers (k, 0, j+4); pathtracer.ocl:88-108."""
    out = []
    for k in range(18, -1, -1):
        for j in range(8, -1, -1):
            if int(bits[j]) & (1 << k):
                out.append((float(k), 0.0, float(j + 4)))
    return np.asarray(out, np.float32).reshape(-1, 3)


def bitmap_to_squares(bits: np.ndarray) -> np.ndarray:
    """(n, 2) float32 (k, j): 2x2 square on plane z=j+4 centred at x=k,
    |y| < 1; pathtracer.ocl:73-86."""
    out = []
    for k in range(18, -1, -1):
        for j in range(8, -1, -1):
            if int(bits[j]) & (1 << k):
                out.append((float(k), float(j)))
    return np.asarray(out, np.float32).reshape(-1, 2)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static SoA scene. All arrays are numpy float32; shapes are static per
    scene so jitted renderers compile once per scene layout."""
    sphere_centers: np.ndarray  # (Ns, 3)
    square_kj: np.ndarray       # (Nq, 2) - (k, j); plane z = j+4
    triangles: np.ndarray       # (Nt, 3, 3)
    lights: np.ndarray          # (Nl, 4) - x, y, z, intensity

    @property
    def n_spheres(self) -> int:
        return int(self.sphere_centers.shape[0])

    @property
    def n_squares(self) -> int:
        return int(self.square_kj.shape[0])

    @property
    def n_triangles(self) -> int:
        return int(self.triangles.shape[0])

    @property
    def n_lights(self) -> int:
        return int(self.lights.shape[0])

    def triangle_aabb(self):
        """Global triangle AABB (parseTrianglesFromFile accumulates it,
        trianglegrid/CLSuperPathTracer.c:136-209). Returns (vmin, vmax)."""
        if self.n_triangles == 0:
            z = np.zeros(3, np.float32)
            return z, z
        v = self.triangles.reshape(-1, 3)
        return v.min(axis=0), v.max(axis=0)


# The business-card bitmap burned into SimpleCPUTracer/CLSimplePathTracer
# (simpleCPUtracer.cpp:27, CLSimplePathTracer.c:163).
SIMPLE_G = np.array([247570, 280596, 280600, 249748, 18578, 18577, 231184, 16, 16],
                    np.int64)


def simple_scene() -> Scene:
    """The bitmap-sphere scene of SimpleCPUTracer / CLSimplePathTracer."""
    return Scene(
        sphere_centers=bitmap_to_spheres(SIMPLE_G),
        square_kj=np.zeros((0, 2), np.float32),
        triangles=np.zeros((0, 3, 3), np.float32),
        lights=np.zeros((0, 4), np.float32),
    )


def load_scene(directory: str = ".",
               spheres: str = "spheres.txt",
               squares: str = "squares.txt",
               triangles: str = "triangles.txt",
               lights: str = "lights.txt",
               max_triangles: int = formats.MAX_TRIANGLES) -> Scene:
    """Load a scene from the reference's cwd-relative text files."""
    j = lambda name: os.path.join(directory, name)
    return Scene(
        sphere_centers=bitmap_to_spheres(formats.parse_array_file(j(spheres))),
        square_kj=bitmap_to_squares(formats.parse_array_file(j(squares))),
        triangles=formats.parse_triangles_file(j(triangles), max_triangles),
        lights=formats.parse_lights_file(j(lights)),
    )
