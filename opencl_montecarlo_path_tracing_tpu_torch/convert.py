"""Carrying state from the JAX package into the port.

A renderer has no weights; what crosses over is the scene, the RNG key and
the output of a light pass.  ``scene_arrays_from_numpy`` takes the JAX
package's ``SceneArrays`` (or its ``Scene``), whose fields are numpy
arrays, and returns the port's ``SceneArrays``; ``key_from_jax`` turns the
JAX ``(k0, k1)`` uint32 key pair into the port's key; ``vlps_from_numpy``
and ``grid_from_numpy`` carry a VLP table and a ``UniformGrid`` (the VLP
grid, or the triangle grid of ``trianglegrid``) across, so both packages
render from the same light pass and walk the same cells.  The JAX
``SceneArrays`` carries kernel B7's ``tri_w`` weights with it.  The
simple family needs nothing more: its scene is the built-in bitmap
(``scene_arrays_from_numpy`` carries it too), and ``simplecpu``'s key is
the same pair ``key_from_jax`` returns.  Both packages then
render the same scene from the same counter-based streams.  This module
imports no JAX: it reads plain attributes and arrays (anything
``numpy.asarray`` takes).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.grid import UniformGrid
from .ops.intersect import SceneArrays, prep_scene
from .scene.scene import Scene

_SCENE_FIELDS = ("sphere_centers", "square_kj", "triangles", "lights")


def scene_arrays_from_numpy(fields) -> SceneArrays:
    """The port's ``SceneArrays`` from a JAX ``SceneArrays`` or a JAX
    ``Scene`` (any object with either's fields as arrays)."""
    if all(hasattr(fields, n) for n in SceneArrays._fields):
        return SceneArrays(**{
            n: np.ascontiguousarray(getattr(fields, n), np.float32)
            for n in SceneArrays._fields})
    if all(hasattr(fields, n) for n in _SCENE_FIELDS):
        return prep_scene(Scene(**{
            n: np.asarray(getattr(fields, n), np.float32)
            for n in _SCENE_FIELDS}))
    raise TypeError(f"expected SceneArrays or Scene fields, got "
                    f"{type(fields).__name__}")


def key_from_jax(key) -> tuple[int, int]:
    """The JAX package's ``(k0, k1)`` uint32 key as the port's key."""
    k0, k1 = key
    return int(np.uint32(k0)), int(np.uint32(k1))


def vlps_from_numpy(vlps, device="cpu") -> torch.Tensor:
    """A (V, 4) VLP table (px, py, pz, intensity) as a float32 tensor."""
    a = np.ascontiguousarray(np.asarray(vlps), np.float32)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"expected a (V, 4) VLP table, got {a.shape}")
    return torch.from_numpy(a.copy()).to(device)


def grid_from_numpy(grid, device="cpu") -> UniformGrid:
    """The port's ``UniformGrid`` from the JAX package's (fields ``items``,
    ``counts``, ``res``, ``vmin``, ``cell_size``)."""
    def t(name, dtype):
        a = np.ascontiguousarray(np.asarray(getattr(grid, name)), dtype)
        return torch.from_numpy(a.copy()).to(device)
    return UniformGrid(items=t("items", np.int32), counts=t("counts", np.int32),
                       res=tuple(int(r) for r in np.asarray(grid.res)),
                       vmin=t("vmin", np.float32).reshape(3),
                       cell_size=t("cell_size", np.float32).reshape(3))
