"""The import guard: nothing the benchmark runs may load JAX or the JAX
package that the port was made from.  Names are compared whole, by the
part before the first dot, so the port's own package, whose name begins
with the JAX package's, is not taken for it."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax",
                       "opencl_montecarlo_path_tracing_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    loaded ones), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)
