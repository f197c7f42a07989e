"""The port's plain ``trace_ray`` / ``any_hit`` == the JAX package's.

Random rays (numpy, from a seed) aimed at the scene's primitives go
through both packages on ``small_scene()`` and ``demo_scene()``, under
default and reference quirks, with per-ray ``t_init`` / ``t_limit``.
Tolerances: material and occlusion agree on all but <= 0.5% of rays (a
razor-edge tie - a discriminant or an edge test within an ulp - may flip in
any two float implementations); where materials agree, ``t`` and the
normals agree to rtol 1e-6 (one or two float32 roundings: the JAX package
normalises sphere normals with XLA's rsqrt, the port with torch's; atol
1e-7 for normal components at zero).

The JAX functions run op by op (``jax.disable_jit``): compiled, XLA:CPU
contracts ``a*b + c`` into fused multiply-adds, which moves cancellation-
heavy sphere roots (``b*b - cc``) by up to ~1e-5 relative; op by op, both
packages evaluate the same IEEE float32 operations in the same order.
"""

import numpy as np
import pytest
import torch

import jax
from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT as J_DEFAULT, REFERENCE as J_REFERENCE)
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.scene import builtin as JB
from opencl_montecarlo_path_tracing_tpu_torch.convert import (
    scene_arrays_from_numpy)
from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
    DEFAULT, REFERENCE)
from opencl_montecarlo_path_tracing_tpu_torch.ops import intersect as TI
from opencl_montecarlo_path_tracing_tpu_torch.scene import builtin as TB
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import demo_scene
from tests.test_torch_gpu import small_scene

FLIP_BUDGET = 0.005
RTOL = 1e-6
N_RAYS = 2048


def _scenes():
    return {"small": small_scene(), "demo": demo_scene()[0]}


def _rays(scene, seed):
    """Origins in a box around the scene, each aimed at a jittered point of
    a random primitive (or the floor), so every class is hit often."""
    g = np.random.default_rng(seed)
    targets = [scene.sphere_centers.reshape(-1, 3),
               np.concatenate([scene.square_kj[:, :1],
                               np.zeros((scene.n_squares, 1)),
                               scene.square_kj[:, 1:] + 4.0], axis=1),
               scene.triangles.reshape(-1, 3, 3).mean(axis=1),
               np.array([[5.0, 3.0, 0.0]])]
    targets = np.concatenate([t for t in targets if len(t)]).astype(np.float32)
    o = g.uniform([0, -4, 1], [20, 12, 16], (N_RAYS, 3)).astype(np.float32)
    p = targets[g.integers(0, len(targets), N_RAYS)]
    p = p + g.normal(0, 0.6, (N_RAYS, 3)).astype(np.float32)
    d = p - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_init = g.uniform(1.0, 40.0, N_RAYS).astype(np.float32)
    return o, d, t_init


def _quirks(name):
    return {"default": (J_DEFAULT, DEFAULT),
            "reference": (J_REFERENCE, REFERENCE)}[name]


def test_builtin_scenes_match_jax():
    """The numpy scene builders are bit-identical to the JAX package's."""
    a, b = TB.demo_scene()[0], JB.demo_scene()[0]
    for f in ("sphere_centers", "square_kj", "triangles", "lights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(TB.ripple_sheet_mesh(6, 4),
                                  JB.ripple_sheet_mesh(6, 4))


def test_scene_arrays_carry_across():
    """convert.scene_arrays_from_numpy(JAX SceneArrays) == the port's own
    prep_scene, field for field (kernel B7's weights tri_w included)."""
    for scene in _scenes().values():
        mine = TI.prep_scene(scene)
        carried = scene_arrays_from_numpy(JI.prep_scene(scene))
        from_scene = scene_arrays_from_numpy(scene)
        for f in TI.SceneArrays._fields:
            np.testing.assert_array_equal(getattr(carried, f),
                                          getattr(mine, f), err_msg=f)
            np.testing.assert_array_equal(getattr(from_scene, f),
                                          getattr(mine, f), err_msg=f)


@pytest.mark.parametrize("quirks", ["default", "reference"])
@pytest.mark.parametrize("scene_name", ["small", "demo"])
@pytest.mark.parametrize("with_t_init", [False, True])
def test_trace_ray_matches_jax(scene_name, quirks, with_t_init):
    scene = _scenes()[scene_name]
    jq, tq = _quirks(quirks)
    o, d, t_init = _rays(scene, seed=7)
    jscn = JI.prep_scene(scene)
    tscn = TI.prep_scene(scene)
    ti = t_init if with_t_init else np.float32(1e9)
    with jax.disable_jit():
        want = JI.trace_ray(o, d, jscn, t_init=ti, quirks=jq,
                            sphere_material=3)
    got = TI.trace_ray(torch.from_numpy(o), torch.from_numpy(d), tscn,
                       t_init=torch.from_numpy(np.asarray(ti)), quirks=tq,
                       sphere_material=3)
    jm = np.asarray(want.material)
    tm = got.material.numpy()
    same = jm == tm
    assert (~same).mean() <= FLIP_BUDGET
    assert len(np.unique(tm)) >= 3          # several classes really hit
    np.testing.assert_allclose(got.t.numpy()[same],
                               np.asarray(want.t)[same], rtol=RTOL)
    np.testing.assert_allclose(got.normal.numpy()[same],
                               np.asarray(want.normal)[same], rtol=RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("quirks", ["default", "reference"])
@pytest.mark.parametrize("scene_name", ["small", "demo"])
@pytest.mark.parametrize("with_limit", [False, True])
def test_any_hit_matches_jax(scene_name, quirks, with_limit):
    scene = _scenes()[scene_name]
    jq, tq = _quirks(quirks)
    o, d, t_lim = _rays(scene, seed=8)
    jscn = JI.prep_scene(scene)
    tscn = TI.prep_scene(scene)
    tl = t_lim if with_limit else np.float32(1e9)
    with jax.disable_jit():
        want = np.asarray(JI.any_hit(o, d, jscn, t_limit=tl, quirks=jq))
    got = TI.any_hit(torch.from_numpy(o), torch.from_numpy(d), tscn,
                     t_limit=torch.from_numpy(np.asarray(tl)),
                     quirks=tq).numpy()
    assert 0.05 < want.mean() < 0.95      # both outcomes occur
    assert (got != want).mean() <= FLIP_BUDGET
