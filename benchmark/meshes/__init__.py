"""Procedural triangle meshes, one module a kind, found by the ``kind`` in
a scene's ``mesh`` (``harness/spec.py::plugin``).  Each module defines
``make(**params) -> (N, 3, 3) float32`` triangles."""
