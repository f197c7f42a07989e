"""Independent NumPy oracle for the Metropolis chain + VLP emission.

Port of ``opencl_montecarlo_path_tracing_tpu/models/oracle_mlt.py``:
the same NumPy code.

A per-chain SCALAR transcription of CLSuperMetropolisPathTracer's kernels
(metropolispathtracer.ocl): GetRandomDirection/AddRandomVertex (ocl:146-168),
GetRandomPath (ocl:171-181), Perturbation (ocl:184-222), VerifyIntersection
(ocl:225-236), Mutate (ocl:239-283) and the MetropolisLightTracer emission
loop (ocl:431-530), carrying the same three deliberate repairs as
models/metropolis.py (correct buffer wiring, per-(chain, round, site) RNG,
eps-tolerant verification - see that module's docstring for the .c/.ocl
cites).  Where models/metropolis.py is fully batched/masked torch over all
chains, this oracle runs one chain at a time with plain Python control flow
and the NumPy tracer from models/oracle_super.py - no shared device code.

Draws come from the same threefry (key, chain, site) streams
(core/rng.py::rand2_np), so the emitted VLP set can be compared against
``models.metropolis.mlt_vlps`` ELEMENTWISE - the strongest possible test of
the chain implementation: every mutate decision, perturbation, verification
trace and emission must agree.
"""

from __future__ import annotations

import numpy as np

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..scene.scene import Scene
from . import oracle_super as OS
from .metropolis import (_SITE_SEED, _SITE_MLT, _P_DECIDE, _P_PERTURB,
                         _P_ADD, _P_REBUILD, _S1, _S2)
from ..ops.vlp import _MLT_BASE

_U32 = np.uint32


def _trace1(o, d, scene, quirks):
    """Single-ray closest hit via the independent NumPy tracer."""
    m, t, n = OS._trace(o.reshape(1, 3), d.reshape(1, 3), scene, quirks)
    return int(m[0]), np.float32(t[0]), n[0]


def _normalize(v):
    return (v / np.sqrt((v * v).sum())).astype(np.float32)


def _uniform_sphere(u1, u2):
    z = np.float32(1.0 - 2.0 * u1)
    r = np.sqrt(max(np.float32(0.0), np.float32(1.0) - z * z))
    phi = np.float32(2.0 * np.pi) * u2
    return np.array([r * np.cos(phi), r * np.sin(phi), z], np.float32)


def _draw2(key, chain, site):
    u1, u2 = rngmod.rand2_np(key, _U32(chain), _U32(site))
    return np.float32(u1), np.float32(u2)


def _add_vertex(key, chain, scene, quirks, origin, site):
    """AddRandomVertex (ocl:157-168): random direction, one trace."""
    u1, u2 = _draw2(key, chain, site)
    d = _uniform_sphere(u1, u2)
    m, t, _ = _trace1(origin, d, scene, quirks)
    if m == 0:
        return False, origin
    return True, (origin + d * t).astype(np.float32)


def _random_path(key, chain, scene, quirks, origin, site_base):
    """GetRandomPath (ocl:171-181): up to 4 chained random vertices."""
    v = np.zeros((4, 3), np.float32)
    length = 0
    cur = origin
    for i in range(4):
        hit, x = _add_vertex(key, chain, scene, quirks, cur, site_base + i)
        if not hit:
            break
        v[i] = x
        length += 1
        cur = x
    return v, length


def _perturbation(key, chain, vertex, site):
    """Szirmay-Kalos perturbation (ocl:184-222)."""
    r = np.array(rngmod.randn_draws_np(key, _U32(chain), _U32(site), 3),
                 np.float32)
    ratio = _S1 / _S2
    dx = _S1 / (ratio + np.abs(np.float32(2.0) * r - np.float32(1.0))) \
        - _S1 / (ratio + np.float32(1.0))
    plus = np.where(vertex < 1.0, vertex + dx, vertex + dx - np.float32(1.0))
    minus = np.where(vertex < 0.0, vertex - dx + np.float32(1.0), vertex - dx)
    return np.where(r < 0.5, plus, minus).astype(np.float32)


def _verify(scene, quirks, origin, dest, eps):
    """VerifyIntersection (ocl:225-236) with the eps repair."""
    d = _normalize(dest - origin)
    m, t, _ = _trace1(origin, d, scene, quirks)
    x = origin + d * t
    if eps == 0.0:
        close = bool((x == dest).all())
    else:
        close = float(((x - dest) ** 2).sum()) < eps * eps
    return m != 0 and close


def _mutate(key, chain, scene, quirks, verify_eps, light_origin, v, length,
            rnd):
    """One Mutate round (ocl:239-283) for one chain."""
    base = _SITE_MLT + int(rnd) * 16

    if length == 0:  # rebuild (ocl:242-245)
        v, length = _random_path(key, chain, scene, quirks, light_origin,
                                 base + _P_REBUILD)
    if length == 0:
        return v, length

    r1, r2 = _draw2(key, chain, base + _P_DECIDE)
    mut_prob = np.float32(1.0) / (np.float32(length) + np.float32(0.2))
    do_mutate = mut_prob >= r1  # ocl:247-248 returns if prob < r

    if do_mutate:
        # perturb + verify in chain order (ocl:250-258)
        temp_v = v.copy()
        temp_len = 0
        cur = light_origin
        for i in range(length):
            pv = _perturbation(key, chain, v[i], base + _P_PERTURB + i)
            if not _verify(scene, quirks, cur, pv, verify_eps):
                break
            temp_v[i] = pv
            temp_len += 1
            cur = pv
        if temp_len == length:  # ocl:259-261
            v = temp_v

        # probabilistic vertex additions (ocl:262-282)
        entry_len = length
        t0 = ((entry_len == 1 and r2 > 0.3) or (entry_len == 2 and r2 < 0.3)
              or (entry_len == 3 and r2 < 0.2))
        t1 = (entry_len == 1 and r2 > 0.7) or (entry_len == 2 and r2 < 0.2)
        t2 = entry_len == 1 and r2 > 0.9
        for j, want in enumerate((t0, t1, t2)):
            if not (want and length < 4):
                continue
            origin_j = v[min(max(length - 1, 0), 3)]
            hit, x = _add_vertex(key, chain, scene, quirks, origin_j,
                                 base + _P_ADD + j)
            if not hit:
                break
            v[length] = x
            length += 1
    return v, length


def _vlp_from_light_sample(scene, quirks, o, d, light_intensity, scale_den):
    """SampleFromLightSource (ocl:230-278) with the MLT base table
    (metropolispathtracer.ocl:416-426)."""
    m, t, n = _trace1(o, d, scene, quirks)
    if m == 0:
        return np.zeros(4, np.float32)
    x = o + d * t
    lamb = np.float32((d * n).sum())
    dist2 = np.float32(((o - x) ** 2).sum())
    if lamb < 0:
        lamb = np.float32(0.0)
    else:
        lamb = lamb * min(np.float32(light_intensity) / dist2,
                          np.float32(1.0))
    lamb = min(lamb, np.float32(1.0))
    base = np.float32(_MLT_BASE.get(m, 0.0))
    intensity = base * lamb / np.float32(scale_den)
    return np.array([x[0], x[1], x[2], intensity], np.float32)


def mlt_vlps_oracle(scene: Scene, key, n_seedpaths: int,
                    mutation_rounds: int, quirks: Quirks = DEFAULT,
                    verify_eps: float = 1e-3) -> np.ndarray:
    """(nlights * n_seedpaths * 4, 4) VLPs, same layout and same threefry
    streams as models.metropolis.mlt_vlps (out[l][depth i][chain])."""
    nlights = scene.n_lights
    total_paths = n_seedpaths * nlights
    scale_den = max(1, total_paths // 256)
    out = []
    for l in range(nlights):
        lp = scene.lights[l, :3].astype(np.float32)
        intensity = float(scene.lights[l, 3])
        vs = np.zeros((n_seedpaths, 4, 3), np.float32)
        lens = np.zeros(n_seedpaths, np.int64)
        for c in range(n_seedpaths):
            v, length = _random_path(key, c, scene, quirks, lp,
                                     _SITE_SEED + 4 * l)
            for r in range(mutation_rounds):
                rnd = r + l * max(1, mutation_rounds)
                v, length = _mutate(key, c, scene, quirks, verify_eps, lp,
                                    v, length, rnd)
            vs[c] = v
            lens[c] = length

        # emission (ocl:522-527): <= 4 VLPs per chain, halved per depth
        vlps_l = np.zeros((4, n_seedpaths, 4), np.float32)
        for c in range(n_seedpaths):
            origin = lp
            alive = lens[c] > 0
            for i in range(4):
                if not (alive and i < lens[c]):
                    break
                d = _normalize(vs[c, i] - origin)
                vlp = _vlp_from_light_sample(
                    scene, quirks, origin, d,
                    np.float32(intensity) / np.float32(1 << i), scale_den)
                if vlp[3] <= 0:  # reference breaks on w == 0 (ocl:525)
                    break
                vlps_l[i, c] = vlp
                origin = vs[c, i]
        out.append(vlps_l.reshape(4 * n_seedpaths, 4))
    return np.concatenate(out, axis=0)


def render_oracle_mlt(scene: Scene, width=32, height=32, spp=4,
                      n_seedpaths=16, mutation_rounds=2, key=None,
                      quirks: Quirks = DEFAULT, max_bounces=5,
                      verify_eps: float = 1e-3,
                      row_offset: int = 0) -> np.ndarray:
    """Pre-ambient float film (H, W, 3): oracle VLPs + the BPT oracle's
    gather pass (film_metropolis reuses the bidirectional gather,
    models/metropolis.py:241)."""
    from .oracle_bpt import render_with_vlps
    assert key is not None, "the MLT oracle is defined on threefry streams"
    vlps = mlt_vlps_oracle(scene, key, n_seedpaths, mutation_rounds, quirks,
                           verify_eps)
    return render_with_vlps(scene, vlps, width, height, spp, key, quirks,
                            max_bounces, row_offset=row_offset)
