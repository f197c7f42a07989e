"""Carrying state from the JAX package into the port.

A renderer has no weights; what crosses over is the scene and the RNG key.
``scene_arrays_from_numpy`` takes the JAX package's ``SceneArrays`` (or its
``Scene``), whose fields are numpy arrays, and returns the port's
``SceneArrays``; ``key_from_jax`` turns the JAX ``(k0, k1)`` uint32
key pair into the port's key.  Both packages then render the same scene
from the same counter-based streams.  This module imports no JAX: it reads
plain attributes and numpy arrays.
"""

from __future__ import annotations

import numpy as np

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
