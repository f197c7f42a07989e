"""Debug visibility into the plain tracers - the reference's disabled
device printfs.

Port of ``opencl_montecarlo_path_tracing_tpu/utils/debug.py``.  The
reference ships commented-out in-kernel printfs (DDA traversal state,
CLSuperPathTracer_trianglegrid/pathtracer.ocl:192) and a disabled grid
dump kernel (printTrianglesGrid, ocl:332-346, neutered by an early return
at :333).  Set ``PT_KERNEL_DEBUG=1`` to print aggregate statistics once a
call from the plain PyTorch paths that carry a hook (the DDA walk,
ops/grid.py::traverse_triangles).  Aggregates, not per-lane dumps: a
wavefront batch has 10^5-10^6 lanes where the reference had one work item
under the debugger's eye.  The CUDA kernels print nothing: their counting
launches (``mega_super.blocked_stats``, ``mega_vlp.vlp_stats``) are the
tools for that.

A hook asks :func:`enabled` before it reduces anything, so with the flag
unset it adds no reduction and no host read.
"""

from __future__ import annotations

import os


def enabled() -> bool:
    return os.environ.get("PT_KERNEL_DEBUG", "") == "1"


def dprint(fmt: str, **kw) -> None:
    """``print(fmt.format(**kw))`` when PT_KERNEL_DEBUG=1, else nothing;
    tensor values are read to the host (a synchronising read)."""
    if enabled():
        print(fmt.format(**{k: v.item() if hasattr(v, "item") else v
                            for k, v in kw.items()}))
