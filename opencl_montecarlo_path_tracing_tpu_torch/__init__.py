"""PyTorch / CUDA port of the Monte-Carlo path-tracing framework.

The JAX package ``opencl_montecarlo_path_tracing_tpu`` is the reference;
this package mirrors its layout and module names so that each module's
counterpart is easy to find.  It imports ``torch`` and numpy, never
``jax``.  All nine variants are ported: the ``super`` / ``superlmem``
render path, whose whole sample step runs in one hand-written CUDA kernel
on the GPU (``ops/mega_super.py`` + ``csrc/mega_super.cu`` up to 512
triangles, ``csrc/mega_blocked.cu`` up to 2^20); ``nodof`` (the
sample-buffer pipeline, or the same kernels); ``trianglegrid`` (the
uniform-grid walk, or the same kernels); ``simple``, whose multi-bounce
mirror recursion runs in its own kernel (``ops/mega_simple.py`` +
``csrc/mega_simple.cu``); ``simplecpu``, the NumPy oracle that renders on
the host; and the VLP family - ``bidirectional``, ``metropolis``,
``metropolis_vlpgrid`` - whose render pass runs in a further one
(``ops/mega_vlp.py`` + ``csrc/mega_vlp.cu``), with a gather kernel
(``ops/gather_vlp.py`` + ``csrc/gather_vlp.cu``) and a closest triangle
kernel for large meshes (``ops/tri_closest.py`` + ``csrc/tri_closest.cu``)
on its tier-1 route; on the CPU everything is plain PyTorch.

Layout
------
core/      counter-based threefry RNG streams, camera, quirks policy
scene/     reference text scene formats, bitmap -> SoA expansion,
           built-in demo scenes
ops/       primitive intersection (plain PyTorch), VLP emission and
           gathers, the uniform grids and DDA walk, the large-mesh block
           tables, the kernel wrappers, film reduction and quantisation
models/    shared sample-loop machinery, the simple, super, nodof
           (sample_parallel), trianglegrid, bidirectional and metropolis
           integrators, the NumPy oracle (simplecpu)
utils/     PAM (P7) image IO, the CUDA kernel builder, CLI, the CRN
           film contract
csrc/      CUDA C++ kernel sources, built with nvcc at first use
"""

__version__ = "0.1.0"

from .api import render, VARIANTS  # noqa: E402,F401
