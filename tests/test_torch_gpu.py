"""Kernel B1 on the card: the CUDA kernel == its plain PyTorch version.

These tests need a CUDA GPU (the kernel has no CPU mode); without one they
skip with a reason.  The file imports neither JAX nor the JAX package, so
it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

The cases are those of ``tests/test_megakernel.py:37-135`` (shared with
``tests/test_torch_mega_super.py``, which holds the plain version against
the JAX megakernel on the CPU).  Tolerance: the per-family contract of
``tools/validate_crn_frame.py`` - display-scale p99.5 < 1e-5 and
razor-edge ties (> 1e-4) on < 0.6% of pixels, since any two float
implementations may flip a razor-edge tie.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE, REFERENCE_LMEM)
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import demo_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene

Q, Q_LIMIT, TIE_THRESH, TIE_LIMIT = 0.995, 1e-5, 1e-4, 0.006
CONTENT_ROW = 300


def small_scene() -> Scene:
    """Every primitive class and material (the same scene as
    tests/test_render_super.py::small_scene)."""
    return Scene(
        sphere_centers=np.array([[10, 0, 4], [11, 0, 11]], np.float32),
        square_kj=np.array([[12, 0], [7, 6]], np.float32),
        triangles=np.array([
            [[8, 5, 10], [7.5, 5.3, 10.6], [7.6, 5.1, 10.7]],
            [[6, 4, 10.5], [6.3, 4.1, 10.9], [6.2, 4.0, 11.0]],
        ], np.float32),
        lights=np.array([[10, 4, 10, 200], [15, 2, 7, 150]], np.float32))


def carry_scene() -> Scene:
    """tests/test_megakernel.py::test_megakernel_carry_t_quirk's scene: a
    sphere wall beyond the primary-hit distance on the shadow path, so the
    _lmem carried t changes occlusions."""
    return Scene(
        sphere_centers=np.array([[20 + i, -75.0, 150.0] for i in range(10)],
                                np.float32),
        square_kj=np.zeros((0, 2), np.float32),
        triangles=np.zeros((0, 3, 3), np.float32),
        lights=np.array([[25.0, -75.0, 300.0, 400.0]], np.float32))


QUIRKS = {"default": DEFAULT, "reference": REFERENCE,
          "reference_lmem": REFERENCE_LMEM}

# (name, scene, seed, (w, h, spp), window kwargs, quirks name)
CASES = [
    ("default_sky", small_scene, 3, (40, 12, 2), {}, "default"),
    ("default_content", small_scene, 3, (40, 308, 2),
     dict(row_offset=CONTENT_ROW, rows=8), "default"),
    ("reference_quirks", small_scene, 4, (16, 308, 2),
     dict(row_offset=CONTENT_ROW, rows=8), "reference"),
    ("odd_size", small_scene, 5, (33, 17, 2), {}, "default"),
    ("spp_window_rows", small_scene, 6, (16, 16, 2),
     dict(spp_offset=2, spp_total=6, row_offset=4, rows=4), "default"),
    ("carry_t", carry_scene, 18, (40, CONTENT_ROW + 12, 2),
     dict(row_offset=CONTENT_ROW, rows=12), "reference_lmem"),
]


def crn_stats(a, b, spp):
    """tools/validate_crn_frame.py::stats: (p99.5, tie fraction)."""
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        / spp * 64.0 / 255.0
    dm = np.abs(d).max(axis=-1)
    return float(np.quantile(dm, Q)), float((dm > TIE_THRESH).mean())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_gpu(case, cuda_device):
    _, make_scene, seed, (w, h, spp), kw, qname = case
    scn = prep_scene(make_scene())
    before = M.LAUNCHES
    got = M.film_super_mega((seed, 0), scn, w, h, spp, quirks=QUIRKS[qname],
                            device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert M.LAUNCHES == before + 1
    want = M.film_super_mega_plain((seed, 0), scn, w, h, spp,
                                   quirks=QUIRKS[qname], device=cuda_device,
                                   **kw)
    assert got.shape == want.shape == (kw.get("rows", h), w, 3)
    q, ties = crn_stats(got.cpu().numpy(), want.cpu().numpy(), spp)
    assert q < Q_LIMIT and ties < TIE_LIMIT, (q, ties)


@pytest.mark.gpu
def test_render_on_gpu_launches_the_kernel(cuda_device):
    """api.render on a CUDA device goes through the kernel, once."""
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    before = M.LAUNCHES
    film = pt.render("super", demo_scene()[0], 64, 64, spp=2, seed=1,
                     device=cuda_device)
    torch.cuda.synchronize()
    assert M.LAUNCHES == before + 1
    assert film.device.type == "cuda" and film.shape == (64, 64, 3)
    assert torch.isfinite(film).all()
