"""Calls into the program under test, one module an entry, found by the
name in a configuration's ``entry`` (``harness/spec.py::plugin``).

Each module defines ``Entry(cfg, raw, device)`` with
``frame(seed, fresh=False)``, which renders one frame of the
configuration and returns its RGBA8 image on the host; ``fresh=True``
renders it from a new program object made from the same raw arrays,
which the program has never prepared.  The program is imported by these
modules only.
"""
