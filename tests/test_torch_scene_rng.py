"""Two contracts of the port against the JAX package that hold outside the
kernels: ``demo_scene()`` loads what the JAX one loads, and the sample
stream's counter wraps where the JAX one wraps.

* ``demo_scene``: both packages prefer the reference scene files in their
  ``REFERENCE_SUPER_DIR`` (the same path) and fall back to the procedural
  scene.  With both constants pointed at one directory of scene files that
  differ from the procedural scene, both return equal arrays and equal
  tags; with ``prefer_reference=False`` both return the procedural scene.
* The RNG counter: ``ray_id = pixel * spp_total + sample`` is uint32
  arithmetic in both packages, so past 2^32 it wraps.  A one-row band of
  the plain ``super`` film with ``pixel * spp_total >= 2^32`` renders the
  same film in both, under the common-random-number contract of
  ``tools/validate_crn_frame.py`` (utils/crn.py: display-scale p99.5 <
  1e-5, razor-edge ties on < 0.6% of pixels; XLA:CPU contracts
  multiply-adds, the port does not) - a stream keyed differently would
  give an unrelated film.
"""

import numpy as np
import pytest

from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT as J_DEFAULT
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models.super import (
    film_super as j_film_super)
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.scene import builtin as JB
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    key_from_jax, scene_arrays_from_numpy)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
from opencl_montecarlo_path_tracing_tpu_torch.models.super import (
    film_super_plain)
from opencl_montecarlo_path_tracing_tpu_torch.scene import builtin as PB
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok

FIELDS = ("sphere_centers", "square_kj", "triangles", "lights")


def other_scene() -> Scene:
    """A scene the procedural one is not: another torus, one more sphere
    and square, other lights."""
    base = PB.procedural_super_scene()
    return Scene(
        sphere_centers=np.concatenate(
            [base.sphere_centers, np.array([[3, 0, 6]], np.float32)]),
        square_kj=np.concatenate(
            [base.square_kj, np.array([[5, 2]], np.float32)]),
        triangles=PB.torus_mesh(center=(6.5, 4.0, 9.5), n_major=6,
                                n_minor=5),
        lights=np.array([[9, 3, 11, 180], [14, 1, 8, 120], [4, 5, 12, 90]],
                        np.float32))


def test_reference_dir_is_the_jax_one():
    assert PB.REFERENCE_SUPER_DIR == JB.REFERENCE_SUPER_DIR


def test_demo_scene_loads_what_jax_loads(tmp_path, monkeypatch):
    ref = tmp_path / "CLSuperPathTracer"
    PB.write_scene_files(other_scene(), str(ref))
    monkeypatch.setattr(PB, "REFERENCE_SUPER_DIR", str(ref))
    monkeypatch.setattr(JB, "REFERENCE_SUPER_DIR", str(ref))
    (mine, tag), (theirs, jtag) = PB.demo_scene(), JB.demo_scene()
    assert tag == jtag == "reference:CLSuperPathTracer"
    proc = PB.procedural_super_scene()
    assert mine.n_triangles != proc.n_triangles
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    # the large-mesh scene takes its spheres, squares and lights from it
    a, b = PB.large_mesh_scene(8, 4), JB.large_mesh_scene(8, 4)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.lights, mine.lights)
    # not preferred: the procedural scene on both sides
    (mine, tag), (theirs, jtag) = (PB.demo_scene(prefer_reference=False),
                                   JB.demo_scene(prefer_reference=False))
    assert tag == jtag == "builtin:procedural"
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), getattr(proc, f))
        np.testing.assert_array_equal(getattr(theirs, f), getattr(proc, f))


def test_demo_scene_falls_back_like_jax(tmp_path, monkeypatch):
    """A directory that does not load (no scene files) gives the
    procedural scene on both sides."""
    broken = tmp_path / "empty"
    broken.mkdir()
    monkeypatch.setattr(PB, "REFERENCE_SUPER_DIR", str(broken))
    monkeypatch.setattr(JB, "REFERENCE_SUPER_DIR", str(broken))
    (mine, tag), (theirs, jtag) = PB.demo_scene(), JB.demo_scene()
    assert tag == jtag == "builtin:procedural"
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))


@pytest.mark.parametrize("spp_total", [(1 << 18) + 1, (1 << 31) + 5])
def test_ray_id_wraps_like_jax(spp_total):
    """One row (row 300 of a 64-wide frame: floor and objects) at samples
    0-1: pixel * spp_total passes 2^32 on every pixel, and the port's
    plain film equals the JAX film under the CRN contract."""
    w, row, spp = 64, 300, 2
    assert row * w * spp_total >= 1 << 32
    jscn = JI.prep_scene(JB.procedural_super_scene())
    key = make_key(7)
    want = np.asarray(j_film_super(key, jscn, w, row + 1, spp, 0, spp_total,
                                   J_DEFAULT, row_offset=row, rows=1))
    got = film_super_plain(key_from_jax(key), scene_arrays_from_numpy(jscn),
                           w, row + 1, spp, 0, spp_total, DEFAULT,
                           row_offset=row, rows=1).numpy()
    assert got.shape == want.shape == (1, w, 3)
    assert want.var() > 1e-5               # the row has content, not sky
    ok, st = crn_ok(got, want, spp)
    assert ok, st
    # the wrapped stream is not the unwrapped one's first samples
    plain = film_super_plain(key_from_jax(key), scene_arrays_from_numpy(jscn),
                             w, row + 1, spp, 0, spp, DEFAULT,
                             row_offset=row, rows=1).numpy()
    assert not np.allclose(plain, got)
