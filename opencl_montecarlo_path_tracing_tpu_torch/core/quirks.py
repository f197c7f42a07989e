"""Fidelity policy toward the reference's estimator deviations.

The reference codebase contains several places where the device code deviates
from the intended math (documented with file:line cites below).  Per the
rebuild policy (SURVEY.md section 7 step 4) the default is the *intended*
math; ``Quirks.reference()`` re-enables the reference behaviour where it is
cheap to reproduce, so renders can be compared quirk-for-quirk.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Quirks:
    #: Reference OpenCL kernels *multiply* the unrolled-recursion specular
    #: highlight by divFact instead of dividing
    #: (CLSimplePathTracer/spt.ocl:121, CLSuperPathTracer/pathtracer.ocl:212),
    #: which amplifies bounce-k highlights by 4^k relative to the recursive
    #: CPU tracer (simpleCPUtracer.cpp:118 attenuates 0.5/level).
    #: Intended math divides.
    specular_divfact_multiply: bool = False

    #: Reference triangle (pathtracer.ocl:129) and square (pathtracer.ocl:78)
    #: tests accept hits with negative ray parameter (no t > eps check), so
    #: geometry *behind* a ray origin can shadow it.  Intended math requires
    #: t > 0.01 like the floor/sphere tests.
    accept_negative_t: bool = False

    #: Framebuffer conversion: convert_uchar4 in the reference is
    #: non-saturating (values > 255 wrap; pathtracer.ocl:240).  Intended math
    #: clamps to [0, 255].
    wrap_uint8: bool = False

    #: The _lmem super tracer passes the *running primary-hit distance* into
    #: its shadow traces instead of a fresh 1e9
    #: (CLSuperPathTracer_lmem/pathtracer.ocl:178: ``TraceRay(intersection,
    #: light_dir, &t, &half_vec, ...)`` where ``t`` still holds the camera
    #: hit's distance): a shadow occluder only registers when closer than the
    #: carried t, and each *executed* shadow trace (the ``lamb_f < 0 ||``
    #: short-circuit skips it) overwrites t with its own closest hit, capping
    #: the next light's trace.  Intended math traces each shadow ray
    #: independently, uncapped (the plain super tracer's behaviour,
    #: CLSuperPathTracer/pathtracer.ocl:156,178 re-initialises t = 1e9).
    shadow_carry_t: bool = False

    #: The bidirectional lightTracer initialises the rejection-sampling
    #: accumulator once outside the per-light loop
    #: (bidirectionalpathtracer.ocl:295,319-323), so lights after the first
    #: reuse the first light's direction.  Intended math draws a fresh
    #: direction per light.
    reuse_light_direction: bool = False

    @staticmethod
    def reference() -> "Quirks":
        return Quirks(
            specular_divfact_multiply=True,
            accept_negative_t=True,
            wrap_uint8=True,
            reuse_light_direction=True,
        )

    @staticmethod
    def reference_lmem() -> "Quirks":
        """The _lmem binaries' behaviour: everything in ``reference()`` plus
        the accidental shadow-trace t aliasing (only the lmem kernels pass
        ``&t`` through, pathtracer.ocl:178)."""
        return dataclasses.replace(Quirks.reference(), shadow_carry_t=True)


DEFAULT = Quirks()
REFERENCE = Quirks.reference()
REFERENCE_LMEM = Quirks.reference_lmem()
