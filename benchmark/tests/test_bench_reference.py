"""The benchmark's own inputs and reference against the program's plain
CPU path (on the CPU only; the program is imported here, by the test, and
never by the reference)."""

import numpy as np
import pytest
import torch

from benchmark.harness import scenes, spec
from benchmark.reference import rng, super_film

PORT = pytest.importorskip("opencl_montecarlo_path_tracing_tpu_torch")
CONFIGS = ["super_reference", "trianglegrid_sheet20k"]


def _config(name):
    bench = spec.benchmark()
    cell = next(w["name"] for w in bench["workloads"] if w["config"] == name)
    return spec.cell(cell, bench).config


@pytest.mark.parametrize("name", CONFIGS)
def test_scene_is_the_programs_builtin(name):
    """The frozen scene generator makes the arrays of the program's
    built-in scenes, bit for bit."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene import builtin
    raw = scenes.make_scene(_config(name)["scene"])
    ref = (builtin.large_mesh_scene() if "sheet" in name
           else builtin.procedural_super_scene())
    for got, want in ((raw["spheres"], ref.sphere_centers),
                      (raw["squares"], ref.square_kj),
                      (raw["triangles"], ref.triangles),
                      (raw["lights"], ref.lights)):
        assert np.array_equal(got, want)


def test_threefry_is_the_programs():
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as prng
    key = rng.make_key(0x1234_5678_9ABC_DEF0)
    assert key == prng.make_key(0x1234_5678_9ABC_DEF0)
    ids = torch.arange(0, 1 << 20, 4099, dtype=torch.int64)
    got = rng.uniforms(key, ids, 3, 4)
    want = prng.randn_draws(key, ids, 3, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,rows", [
    ("super_reference", (300, 2)),
    ("trianglegrid_sheet20k", (200, 1)),
    ("super_reference", (511, 1)),
])
def test_reference_agrees_with_plain_path(name, rows):
    """The reference's film of a band of the frame equals the plain
    version of the kernels the cell's route launches (B1's or B2/B3's,
    ops/mega_super.py::film_super_mega_plain) to float rounding."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import Quirks
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.ops.mega_super import (
        film_super_mega_plain)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
    cfg = _config(name)
    raw = scenes.make_scene(cfg["scene"])
    w, spp, seed = cfg["width"], 4, 3_000_000_019
    row0, n = rows
    scn = prep_scene(Scene(raw["spheres"], raw["squares"], raw["triangles"],
                           raw["lights"]))
    plain = film_super_mega_plain(make_key(seed), scn, w, cfg["height"], spp,
                                  0, cfg["spp"], Quirks(**cfg["quirks"]),
                                  row_offset=row0, rows=n)
    pix = np.arange(row0 * w, (row0 + n) * w)
    ref = super_film.film_pixels(super_film.geometry(raw, "cpu"), seed, pix,
                                 w, spp, spp_total=cfg["spp"],
                                 quirks=cfg["quirks"])
    a, b = plain.reshape(-1, 3), ref
    rel = (a - b).abs() / b.abs().clamp_min(1.0)
    assert float(rel.max()) < 1e-5
    assert np.array_equal(super_film.rgba8(ref)[:, :3],
                          np.clip(np.trunc(a.numpy() + 13), 0, 255))
