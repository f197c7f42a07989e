"""Built-in demo scenes (no external files needed).

Port of ``opencl_montecarlo_path_tracing_tpu/scene/builtin.py`` (numpy
only; the meshes are bit-identical to the JAX package's).

``demo_scene(reference_dir)`` loads the reference scene files from
``reference_dir`` when it is given and exists (so benches can run the exact
CLSuperPathTracer workload); otherwise it builds an equivalent-scale
procedural scene: the same sphere/square bitmaps and lights (tiny public
constants of the scene format) plus a procedurally generated torus mesh of
comparable triangle count to the reference's ~96-triangle mesh.  Unlike
the JAX package, the port looks in no fixed directory of its own.
"""

from __future__ import annotations

import os

import numpy as np

from .scene import Scene, bitmap_to_spheres, bitmap_to_squares

# super-scene bitmaps: spheres at (10,0,4) and (11,0,11); squares at
# (12, z=4), (0, z=10), (7, z=10), (13, z=12)
_SUPER_SPHERE_BITS = np.array([1024, 0, 0, 0, 0, 0, 0, 2048, 0], np.int64)
_SUPER_SQUARE_BITS = np.array([4096, 0, 0, 0, 0, 0, 129, 0, 8192], np.int64)
_SUPER_LIGHTS = np.array([[10, 4, 10, 200], [15, 2, 7, 150]], np.float32)


def torus_mesh(center=(7.8, 5.0, 10.7), major=0.6, minor=0.25,
               n_major: int = 8, n_minor: int = 6) -> np.ndarray:
    """Procedural torus triangle mesh, (2 * n_major * n_minor, 3, 3)."""
    cx, cy, cz = center
    us = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)

    # vectorized (the scalar per-vertex form cost ~4 s of Python at 65k
    # triangles, ~1 min at 1M); float64 math with a final float32 cast,
    # element-for-element the same ops as the old scalar loop, so the
    # mesh is bit-identical (the goldens pin it)
    def point(u, v):                       # u, v broadcastable grids
        r = major + minor * np.cos(v)
        return np.stack([cx + r * np.cos(u), cy + r * np.sin(u),
                         cz + minor * np.sin(v)],
                        axis=-1).astype(np.float32)

    u0 = us[:, None]
    u1 = np.roll(us, -1)[:, None]
    v0 = vs[None, :]
    v1 = np.roll(vs, -1)[None, :]
    a = point(np.broadcast_to(u0, (n_major, n_minor)),
              np.broadcast_to(v0, (n_major, n_minor)))
    b = point(np.broadcast_to(u1, (n_major, n_minor)),
              np.broadcast_to(v0, (n_major, n_minor)))
    c = point(np.broadcast_to(u1, (n_major, n_minor)),
              np.broadcast_to(v1, (n_major, n_minor)))
    d = point(np.broadcast_to(u0, (n_major, n_minor)),
              np.broadcast_to(v1, (n_major, n_minor)))
    # interleave [a, b, c] / [a, c, d] exactly as the scalar loop did
    tris = np.empty((n_major, n_minor, 2, 3, 3), np.float32)
    tris[:, :, 0, 0] = a
    tris[:, :, 0, 1] = b
    tris[:, :, 0, 2] = c
    tris[:, :, 1, 0] = a
    tris[:, :, 1, 1] = c
    tris[:, :, 1, 2] = d
    return tris.reshape(-1, 3, 3)


def ripple_sheet_mesh(n_major: int, n_minor: int, min_det: float = 0.02,
                      depth: float = 20.0, amp_frac: float = 0.075,
                      periods: float = 6.0) -> np.ndarray:
    """A dense VISIBLE mesh: a rippled sheet spanning the fixed camera's
    view frustum, (2 * n_major * n_minor, 3, 3).

    The reference estimator rejects any triangle whose UNNORMALIZED edge
    cross product falls under its det cutoff (`fabs(det) < 0.01f`,
    pathtracer.ocl:68 - faithfully reproduced as ops/intersect._EPS), so
    a mesh is only a real rendering workload if every triangle's
    |e0 x e2| clears it; the reference's own 96-triangle scene keeps a
    26x margin (min 0.026).  Dense tori shrink their triangles
    quadratically with resolution and fall under the cutoff by 20k
    triangles - invisible to ANY faithful implementation (round-4
    finding, docs/PERF.md).  This sheet instead grows its world size
    with density: vertices sit at ``depth + ripple`` along the pixel-grid
    ray directions (so it exactly covers the frame at every density) and
    ``depth`` is scaled until min |e0 x e2| >= ``min_det`` (det grows
    ~depth^2; the ripple amplitude tracks depth so the relief keeps its
    shape)."""
    from ..core.camera import make_camera
    cam = make_camera(z_sign=-1.0)
    up = np.asarray(cam.up, np.float64)
    right = np.asarray(cam.right, np.float64)
    eyo = np.asarray(cam.eye_offset, np.float64)
    pos = np.asarray(cam.pos, np.float64)
    ax = np.linspace(0.0, 512.0, n_major + 1)
    ay = np.linspace(0.0, 512.0, n_minor + 1)
    AX, AY = np.meshgrid(ax, ay, indexing="ij")
    d = 16.0 * (up[None, None] * AX[..., None]
                + right[None, None] * AY[..., None] + eyo[None, None])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ph = 2.0 * np.pi * periods / 512.0

    def build(dep):
        ripple = (amp_frac * dep * np.sin(ph * AX) * np.sin(ph * AY))
        P = pos[None, None] + (dep + ripple)[..., None] * d
        a = P[:-1, :-1]
        b = P[1:, :-1]
        c = P[1:, 1:]
        e = P[:-1, 1:]
        # winding (a, c, b) / (a, e, c): geometric normals face the
        # camera, so the lights (which sit between camera and sheet)
        # actually illuminate it - the reference shades with the
        # cross-product normal as-is, no two-sided flip
        tris = np.concatenate(
            [np.stack([a, c, b], axis=2), np.stack([a, e, c], axis=2)],
            axis=2).reshape(-1, 3, 3)
        e0 = tris[:, 1] - tris[:, 0]
        e2 = tris[:, 2] - tris[:, 0]
        det = np.linalg.norm(np.cross(e0, e2), axis=1)
        return tris, float(det.min())

    tris, dmin = build(depth)
    if dmin < min_det:
        depth *= np.sqrt(min_det / max(dmin, 1e-30)) * 1.05
        tris, dmin = build(depth)
    assert dmin >= min_det, (dmin, min_det)
    return tris.astype(np.float32)


def large_mesh_scene(n_major: int = 144, n_minor: int = 72) -> Scene:
    """The demo scene with its triangles replaced by a dense VISIBLE
    mesh (default 2*144*72 = 20736 triangles): the standard large-mesh
    acceleration benchmark (docs/PERF.md "Large meshes"; the reference's
    trianglegrid variant exists for exactly this regime,
    CLSuperPathTracer_trianglegrid/CLSuperPathTracer.c:15 MAX_TRIANGLES).

    Round 4 replaced the former dense torus with
    :func:`ripple_sheet_mesh`: the torus's triangles fell under the
    reference's det cutoff past ~5k triangles, so those benchmark rows
    exercised the culling machinery against a mesh that could never
    shade a pixel.  The sheet spans the view frustum at every density
    and every triangle clears the cutoff - the rows now measure a real
    render (film content pinned by tests/test_builtin_scene.py)."""
    base, _ = demo_scene()
    return Scene(
        sphere_centers=base.sphere_centers,
        square_kj=base.square_kj,
        triangles=ripple_sheet_mesh(n_major, n_minor),
        lights=base.lights,
    )


def dense_vlp_scene() -> Scene:
    """A scene whose light pass emits DENSELY (light below the floor:
    upward rays hit the floor from below with lamb = dz > 0, so nearly
    every VLP row is live).  This is the live-VLP-compaction worst case -
    the reference scene is ~1% live, this one is ~100% - used by the
    bidirectional_dense bench row so compaction regressions are visible."""
    return Scene(
        sphere_centers=np.array([[2, 0, -5], [-2, 1, -5]], np.float32),
        square_kj=np.zeros((0, 2), np.float32),
        triangles=np.zeros((0, 3, 3), np.float32),
        lights=np.array([[0, 0, -5, 100], [3, 1, -4, 80]], np.float32))


def procedural_super_scene() -> Scene:
    return Scene(
        sphere_centers=bitmap_to_spheres(_SUPER_SPHERE_BITS),
        square_kj=bitmap_to_squares(_SUPER_SQUARE_BITS),
        triangles=torus_mesh(),
        lights=_SUPER_LIGHTS.copy(),
    )


def write_scene_files(scene: Scene, directory: str) -> None:
    """Export a Scene to the reference text formats (SURVEY.md section 2.9)
    so any tool speaking those formats - including the reference binaries -
    can consume it."""
    os.makedirs(directory, exist_ok=True)

    def bitmap(pairs):
        bits = [0] * 9
        for k, j in pairs:
            bits[int(round(j))] |= 1 << int(round(k))
        return bits

    # spheres at (k, 0, j+4); squares stored as (k, j)
    sph = bitmap((c[0], c[2] - 4.0) for c in scene.sphere_centers)
    sq = bitmap((s[0], s[1]) for s in scene.square_kj)
    with open(os.path.join(directory, "spheres.txt"), "w") as fp:
        fp.write("\n".join(str(b) for b in sph))
    with open(os.path.join(directory, "squares.txt"), "w") as fp:
        fp.write("\n".join(str(b) for b in sq))
    with open(os.path.join(directory, "triangles.txt"), "w") as fp:
        frames = []
        for tri in scene.triangles:
            lines = []
            for v in tri:
                lines.extend(f"{float(c):.6f}" for c in v)
                lines.append("")
            lines.append("")
            frames.append("\n".join(lines))
        fp.write("\n".join(frames).rstrip("\n"))
    with open(os.path.join(directory, "lights.txt"), "w") as fp:
        vals = []
        for l in scene.lights:
            vals.extend(f"{float(c):g}" for c in l)
        fp.write("\n".join(vals))


def demo_scene(reference_dir: str | None = None) -> tuple[Scene, str]:
    """Returns (scene, source_tag): the reference CLSuperPathTracer scene
    files in ``reference_dir`` when that directory exists, else the
    procedural stand-in."""
    if reference_dir is not None and os.path.isdir(reference_dir):
        from .scene import load_scene
        return load_scene(reference_dir), "reference:CLSuperPathTracer"
    return procedural_super_scene(), "builtin:procedural"
