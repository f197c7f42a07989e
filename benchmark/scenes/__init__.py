"""Makers of a scene's raw arrays, one module a kind, found by the
``kind`` in a configuration's ``scene`` (``harness/spec.py::plugin``).
Each module defines ``make(spec) -> dict`` of numpy float32 arrays, which
both the program and the reference receive."""
