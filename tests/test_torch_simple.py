"""The `simple` variant and kernel B5's plain version against the JAX package.

``models/simple.py::film_simple_plain`` (plain PyTorch on the CPU) is held
against the JAX package's ``render_simple`` (jitted XLA on the CPU) and
against its ``ops/pallas_simple.py::film_simple_mega(..., interpret=True)``
on the cases of ``tests/test_megakernel.py:590-634``: a 40x12 sky window
at 2 and 5 spp, the reference quirks on an spp window and row band, and
the sphere-field band (rows 192-207), where the mirror chains run.  It is
also held against the port's own NumPy oracle (``models/oracle.py``) in
common-random-numbers mode on the band of ``tests/test_crn.py:103-115``.

Tolerances, each with its reason: the simple family's contract of
``tools/validate_crn_frame.py`` (utils/crn.py ``SIMPLE``: display-scale
p95 < 1e-5 and razor-edge ties (> 1e-4) on < 2% of pixels), because the
mirror chain amplifies rounding - XLA:CPU contracts multiply-adds, the
port does not, and a one-ulp difference at one bounce can flip a later
sphere hit - plus atol 2e-5 (the JAX megakernel test's own) where no pixel
ties.  Against the oracle, whose pow99 multiplies in another order, the
tie budget of ``tests/test_crn.py`` (0.05).

The CUDA kernel itself runs only on a GPU: ``tests/test_torch_gpu.py``
holds it against this plain version on the same cases (``gpu`` marker;
skipped without a GPU), as does ``python3 chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT as J_DEFAULT, REFERENCE as J_REFERENCE)
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models.simple import render_simple
from opencl_montecarlo_path_tracing_tpu.ops import pallas_simple as JS
from opencl_montecarlo_path_tracing_tpu.ops.intersect import (
    prep_scene as j_prep_scene)
from opencl_montecarlo_path_tracing_tpu.scene.scene import (
    simple_scene as j_simple_scene)
import opencl_montecarlo_path_tracing_tpu_torch as tpt
from opencl_montecarlo_path_tracing_tpu_torch.convert import key_from_jax
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
from opencl_montecarlo_path_tracing_tpu_torch.models import simple as TS
from opencl_montecarlo_path_tracing_tpu_torch.models.oracle import (
    render_oracle)
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_simple as M5
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    demo_scene)
from tests.test_torch_gpu import QUIRKS, SIMPLE_CASES, simple_close

J_QUIRKS = {"default": J_DEFAULT, "reference": J_REFERENCE}


def _jax_film(ref, key, w, h, spp, kw, qname):
    """The JAX package's film of a case: ``render_simple`` (the full frame,
    cut to the band) or the interpret-mode megakernel."""
    rows = kw.get("rows", h)
    r0 = kw.get("row_offset", 0)
    window = dict(spp_offset=kw.get("spp_offset", 0),
                  spp_total=kw.get("spp_total", spp))
    if ref == "xla":
        film = render_simple(key, w, h, spp=spp, quirks=J_QUIRKS[qname],
                             **window)
        return np.asarray(film)[r0:r0 + rows]
    return np.asarray(JS.film_simple_mega(
        key, j_prep_scene(j_simple_scene()), w, h, spp,
        quirks=J_QUIRKS[qname], row_offset=r0, rows=rows, interpret=True,
        **window))


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", SIMPLE_CASES,
                         ids=[c[0] for c in SIMPLE_CASES])
def test_plain_matches_jax(case, ref):
    name, seed, (w, h, spp), kw, qname = case
    key = make_key(seed)
    want = _jax_film(ref, key, w, h, spp, kw, qname)
    got = TS.film_simple_plain(key_from_jax(key), w, h, spp,
                               quirks=QUIRKS[qname], device="cpu",
                               **kw).numpy()
    assert got.shape == want.shape == (kw.get("rows", h), w, 3)
    if name == "sphere_field_band":
        assert want.var() > 1e-3     # the band has content, not only sky
    simple_close(got, want, spp)


def test_plain_matches_oracle_crn():
    """tests/test_crn.py::test_simple_matches_oracle_bitwise_crn with the
    port on both sides: the wavefront and the NumPy recursive tracer
    consume the same threefry streams."""
    key = make_key(9)
    spp, rows, r0, w = 4, 16, 192, 64
    got = TS.film_simple_plain(key_from_jax(key), w, r0 + rows, spp,
                               max_bounces=5, row_offset=r0, rows=rows,
                               device="cpu").numpy()
    orc = render_oracle(w, rows, spp=spp, key=key_from_jax(key),
                        max_depth=5, row_offset=r0)
    assert float(orc.var()) > 1e-2                # sphere-field content
    d = (np.abs(got - orc) / spp * 64.0 / 255.0).max(axis=-1)
    q = float(np.quantile(d, 1.0 - 0.05))
    assert q < 1e-5, (q, float(d.max()), int((d > 1e-5).sum()))


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU device film_simple_mega returns the plain version's film
    and launches nothing; render_simple is the same film."""
    scn = TS.simple_arrays()
    before = M5.LAUNCHES
    a = M5.film_simple_mega((5, 0), scn, 24, 208, 2, row_offset=196,
                            rows=4, device="cpu")
    b = M5.film_simple_mega_plain((5, 0), scn, 24, 208, 2, row_offset=196,
                                  rows=4)
    assert M5.LAUNCHES == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = TS.render_simple((5, 0), 24, 208, spp=2, device="cpu")[196:200]
    torch.testing.assert_close(c, a, rtol=0, atol=0)


def test_spp_window_composition():
    """Two spp windows sum to the full render, as in
    tests/test_render_simple.py."""
    full = TS.render_simple((7, 0), 16, 16, spp=8, device="cpu")
    a = TS.render_simple((7, 0), 16, 16, spp=4, spp_total=8, device="cpu")
    b = TS.render_simple((7, 0), 16, 16, spp=4, spp_offset=4, spp_total=8,
                         device="cpu")
    torch.testing.assert_close(a + b, full, rtol=0, atol=1e-4)


def test_kernel_refuses_other_primitives():
    """The simple tracer's scene is the floor and its spheres: a scene
    with squares, triangles or lights is refused, not partly rendered."""
    with pytest.raises(ValueError, match="floor and spheres only"):
        M5.film_simple_mega((1, 0), prep_scene(demo_scene()[0]), 8, 8, 1,
                            device="cpu")


def test_api_render_simple_matches_plain():
    film = tpt.render("simple", None, 16, 16, spp=2, seed=3, quirks=DEFAULT,
                      device="cpu")
    want = TS.film_simple_plain((3, 0), 16, 16, 2, device="cpu")
    torch.testing.assert_close(film, want, rtol=0, atol=0)
