"""The benchmark's scene inputs, made from a configuration's ``scene``.

A scene is raw data, as the upstream renderer reads it from its text
files; both the program and the reference receive these arrays, and each
derives what it needs from them.  The scene's ``kind`` names its maker in
``benchmark/scenes/``, which may name a mesh maker in ``benchmark/meshes/``.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import spec as _spec


def make_scene(spec: dict) -> dict:
    """Raw scene arrays (numpy float32) of a configuration's ``scene``."""
    return _spec.plugin("scenes", spec["kind"]).make(spec)


def scene_bytes(scene: dict) -> int:
    """Bytes of the raw scene: what any renderer reads at least once."""
    return int(sum(np.asarray(a, np.float32).nbytes for a in scene.values()))
