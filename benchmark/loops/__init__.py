"""Traffic generators, one module a loop, found by the ``loop`` in a
traffic mix (``harness/spec.py::plugin``).  Each module defines
``Stream(mix, seed)`` with ``warmup_frames``, ``warmup_seed(i)`` and
``request(k) -> (seed, fresh)``: what timed frame k asks for."""
