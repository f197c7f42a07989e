"""The port's native runtime (utils/native.py, its own copy of
``native/pamscene.cpp``) against the port's NumPy paths and the JAX
package's ``utils.native``: PAM bytes and parsed arrays equal exactly
(the same formats, read and written the same way)."""

import os

import numpy as np
import pytest

from opencl_montecarlo_path_tracing_tpu.utils import native as jnative
from opencl_montecarlo_path_tracing_tpu_torch.scene import formats
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    large_mesh_scene, procedural_super_scene, write_scene_files)
from opencl_montecarlo_path_tracing_tpu_torch.utils import native, pam


def test_builds_with_gxx_into_the_build_dir():
    path = native.build()
    assert os.path.isfile(path)
    assert os.path.basename(path).startswith("libpamscene-")
    assert os.path.dirname(path).endswith(
        os.path.join("opencl_montecarlo_path_tracing_tpu_torch", "_build"))
    assert native.load() is not None


def _images():
    g = np.random.default_rng(4)
    return [pam.ImgInfo(width=13, height=7, channels=4,
                        data=g.integers(0, 256, (7, 13, 4), np.uint8)),
            pam.ImgInfo(width=5, height=3, channels=3,
                        data=g.integers(0, 256, (3, 5, 4), np.uint8)),
            pam.ImgInfo(width=6, height=4, channels=4, maxval=65535,
                        depth=16,
                        data=g.integers(0, 65536, (4, 6, 4), np.uint16))]


@pytest.mark.parametrize("i", range(3), ids=["rgba8", "rgb8", "rgba16"])
def test_pam_bytes_equal_numpy_and_jax(i, tmp_path, monkeypatch):
    img = _images()[i]
    pam.save_pam(str(tmp_path / "native.ppm"), img)
    assert native.pam_write(str(tmp_path / "direct.ppm"), img.width,
                            img.height, img.channels, img.maxval, img.depth,
                            img.data)
    assert jnative.pam_write(str(tmp_path / "jax.ppm"), img.width,
                             img.height, img.channels, img.maxval,
                             img.depth, img.data)
    monkeypatch.setenv("PT_NO_NATIVE", "1")
    pam.save_pam(str(tmp_path / "numpy.ppm"), img)
    back_numpy = pam.load_pam(str(tmp_path / "numpy.ppm"))
    monkeypatch.delenv("PT_NO_NATIVE")
    raw = {n: (tmp_path / f"{n}.ppm").read_bytes()
           for n in ("native", "direct", "jax", "numpy")}
    assert raw["native"] == raw["direct"] == raw["jax"] == raw["numpy"]
    back = pam.load_pam(str(tmp_path / "numpy.ppm"))
    np.testing.assert_array_equal(back.data, back_numpy.data)
    assert back.data.dtype == back_numpy.data.dtype
    assert (back.width, back.height, back.channels, back.maxval) == (
        img.width, img.height, img.channels, img.maxval)


@pytest.mark.parametrize("scene", ["demo", "sheet"])
def test_parsers_equal_numpy_and_jax(scene, tmp_path, monkeypatch):
    s = procedural_super_scene() if scene == "demo" else large_mesh_scene(
        24, 12)
    write_scene_files(s, str(tmp_path))
    paths = {n: str(tmp_path / f"{n}.txt")
             for n in ("spheres", "squares", "triangles", "lights")}
    got = {"spheres": native.parse_bitmap(paths["spheres"]),
           "squares": native.parse_bitmap(paths["squares"]),
           "triangles": native.parse_triangles(paths["triangles"], 65536),
           "lights": native.parse_lights(paths["lights"], 5)}
    via = {"spheres": formats.parse_array_file(paths["spheres"]),
           "squares": formats.parse_array_file(paths["squares"]),
           "triangles": formats.parse_triangles_file(paths["triangles"]),
           "lights": formats.parse_lights_file(paths["lights"])}
    want_jax = {"spheres": jnative.parse_bitmap(paths["spheres"]),
                "squares": jnative.parse_bitmap(paths["squares"]),
                "triangles": jnative.parse_triangles(paths["triangles"],
                                                     65536),
                "lights": jnative.parse_lights(paths["lights"], 5)}
    monkeypatch.setenv("PT_NO_NATIVE", "1")
    plain = {"spheres": formats.parse_array_file(paths["spheres"]),
             "squares": formats.parse_array_file(paths["squares"]),
             "triangles": formats.parse_triangles_file(paths["triangles"]),
             "lights": formats.parse_lights_file(paths["lights"])}
    for k in got:
        assert got[k].dtype == plain[k].dtype
        np.testing.assert_array_equal(got[k], plain[k])
        np.testing.assert_array_equal(got[k], via[k])
        np.testing.assert_array_equal(got[k], want_jax[k])
    assert len(plain["triangles"]) == s.n_triangles
