"""The `nodof` variant (models/sample_parallel.py, ops/reduce.py) against the
JAX package.

The sample buffer, its reduction and the image are held against the JAX
package's on the small scene (every primitive class and material) at
24x8 with a 2x2 sample grid and on a row band of the content rows.
Tolerances, each with its reason:

* the sample buffer: the CRN contract of ``tools/validate_crn_frame.py``
  (utils/crn.py: display-scale p99.5 < 1e-5, ties > 1e-4 on < 0.6% of
  slots), one sample a slot - both packages consume the same threefry
  streams, so only float rounding and razor-edge ties differ;
* the reduction of one buffer: <= 1 uint8 step and >= 99.9% of pixels
  exact - torch and XLA sum a pixel's samples in different orders, and a
  sum within an ulp of an integer may truncate one step apart;
* the summed buffer against ``film_super_plain(spp = sg^2)`` (the
  invariant of the JAX docstring): the contract, for the same reason;
* the kernel route's image (``quantize_film`` of the super film, here
  through B1's plain version) against the sample-buffer route's: <= 1
  step and > 99% exact (``tests/test_megakernel.py:637-654``).
"""

import numpy as np
import pytest
import torch

import opencl_montecarlo_path_tracing_tpu as jpt
from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT as J_DEFAULT, REFERENCE as J_REFERENCE)
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models import sample_parallel as JSP
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.ops import reduce as JRD
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene as JScene
import opencl_montecarlo_path_tracing_tpu_torch as tpt
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    key_from_jax, scene_arrays_from_numpy)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE)
from opencl_montecarlo_path_tracing_tpu_torch.models import (
    sample_parallel as TSP)
from opencl_montecarlo_path_tracing_tpu_torch.models.super import (
    film_super_plain)
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
from opencl_montecarlo_path_tracing_tpu_torch.ops import reduce as TRD
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_torch_gpu import CONTENT_ROW, small_scene

SG = 2
# (name, width, height, window kwargs, quirks): the 24x8 window of
# tests/test_megakernel.py::test_nodof_megakernel_route, and a band of
# the content rows (floor, spheres, squares, triangles under two lights)
CASES = [("window_24x8", 24, 8, {}, "default"),
         ("content_band", 24, CONTENT_ROW + 4,
          dict(row_offset=CONTENT_ROW, rows=4), "default"),
         ("content_band_reference", 16, CONTENT_ROW + 4,
          dict(row_offset=CONTENT_ROW, rows=4), "reference")]
J_QUIRKS = {"default": J_DEFAULT, "reference": J_REFERENCE}
T_QUIRKS = {"default": DEFAULT, "reference": REFERENCE}


def _scenes():
    s = small_scene()
    jscn = JI.prep_scene(JScene(s.sphere_centers, s.square_kj, s.triangles,
                                s.lights))
    return jscn, scene_arrays_from_numpy(jscn)


def _step_diff(a, b):
    return np.abs(np.asarray(a).astype(np.int32)
                  - np.asarray(b).astype(np.int32))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sample_buffer_matches_jax(case):
    _, w, h, kw, qname = case
    jscn, tscn = _scenes()
    key = make_key(15)
    want = np.asarray(JSP.sample_buffer(key, jscn, w, h, SG, J_QUIRKS[qname],
                                        **kw))
    got = TSP.sample_buffer(key_from_jax(key), tscn, w, h, SG,
                            T_QUIRKS[qname], device="cpu", **kw).numpy()
    assert got.shape == want.shape == (kw.get("rows", h) * SG, w * SG, 3)
    if "rows" in kw:
        assert want.var() > 1e-5       # the band has content, not only sky
    ok, st = crn_ok(got, want, 1)
    assert ok, st


@pytest.mark.parametrize("sg", [2, 8])
@pytest.mark.parametrize("wrap", [False, True])
def test_reduce_samples_matches_jax(wrap, sg):
    """Both reductions of the same seeded buffer, whose pixel sums run
    from below 0 to past 255 (so that clamping and the wrap quirk act)."""
    g = np.random.default_rng(sg)
    buf = g.uniform(-30.0, 330.0 / sg**2,
                    (6 * sg, 10 * sg, 3)).astype(np.float32)
    want = np.asarray(JRD.reduce_samples(buf, sg, wrap=wrap))
    got = TRD.reduce_samples(torch.from_numpy(buf), sg, wrap=wrap).numpy()
    assert got.shape == want.shape == (6, 10, 4) and got.dtype == np.uint8
    d = _step_diff(got, want)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


@pytest.mark.parametrize("case", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_summed_buffer_is_the_super_film(case):
    """The JAX docstring's invariant: the per-pixel sum of the buffer is
    the super film at spp = sg^2 (the same streams, another summation
    order)."""
    _, w, h, kw, _ = case
    _, tscn = _scenes()
    buf = TSP.sample_buffer((15, 0), tscn, w, h, SG, DEFAULT, device="cpu",
                            **kw)
    rows = kw.get("rows", h)
    summed = buf.reshape(rows, SG, w, SG, 3).sum(dim=(1, 3))
    film = film_super_plain((15, 0), tscn, w, h, SG * SG, 0, SG * SG,
                            DEFAULT, row_offset=kw.get("row_offset", 0),
                            rows=rows)
    ok, st = crn_ok(summed, film, SG * SG)
    assert ok, st


@pytest.mark.parametrize("case", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_kernel_route_matches_sample_buffer_route(case):
    """The image a CUDA device renders (the super film at spp = sg^2,
    quantised: here through B1's plain version) against the sample-buffer
    route's image."""
    _, w, h, kw, _ = case
    _, tscn = _scenes()
    img = TSP.render_sample_parallel((15, 0), tscn, w, h, SG, device="cpu",
                                     **kw)
    film = M.film_super_mega_plain((15, 0), tscn, w, h, SG * SG, **kw)
    d = _step_diff(img, TRD.quantize_film(film))
    assert d.max() <= 1 and (d == 0).mean() > 0.99


def test_render_sample_parallel_returns_image_and_buffer():
    _, tscn = _scenes()
    img, buf = TSP.render_sample_parallel((3, 0), tscn, 12, 8, SG,
                                          return_samples=True, device="cpu")
    assert img.shape == (8, 12, 4) and img.dtype == torch.uint8
    assert buf.shape == (8 * SG, 12 * SG, 3)
    torch.testing.assert_close(img, TRD.reduce_samples(buf, SG))


def test_api_nodof_matches_jax_image():
    """api.render("nodof") in both packages (the port on the CPU): numpy
    RGBA8 images within one step on >= 99.5% of pixels."""
    s = small_scene()
    js = JScene(s.sphere_centers, s.square_kj, s.triangles, s.lights)
    want = np.asarray(jpt.render("nodof", js, 16, 8, spp=4, seed=2))
    got = tpt.render("nodof", s, 16, 8, spp=4, seed=2, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.shape == want.shape == (8, 16, 4)
    d = _step_diff(got, want)
    assert d.max() <= 1 and (d == 0).mean() >= 0.995
    with pytest.raises(ValueError, match="square spp"):
        tpt.render("nodof", s, 16, 8, spp=5, device="cpu")
