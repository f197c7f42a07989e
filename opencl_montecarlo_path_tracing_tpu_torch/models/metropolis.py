"""Metropolis light transport - CLSuperMetropolisPathTracer (+_vlpgrid).

Port of ``opencl_montecarlo_path_tracing_tpu/models/metropolis.py``.
Reference pipeline (SURVEY.md section 3.5): (a) ``lightTracer`` builds one
random 4-vertex seed ``Path`` per (work item, light); (b)
``MetropolisLightTracer`` runs ``mutation_rounds`` of ``Mutate`` - vertex
perturbations (Szirmay-Kalos s1=1/512, s2=1/16, metropolispathtracer.ocl:
184-222) re-validated by a re-trace, plus probabilistic vertex add/drop -
then emits <= 4 VLPs per path with intensity halved per depth
(light_intensity / (1 << i), ocl:524); (c) ``pathTracer`` gathers the VLPs
like the bidirectional tracer.  The _vlpgrid variant additionally reduces
the VLP bounding box, builds a uniform grid over the VLPs and gathers only
the shading point's cell (on B4's route only the grid's frame is built:
B4 bins each VLP itself).

The JAX package's deliberate repairs of reference defects are kept (the
seed pass output feeds the mutation pass; counter-based draws per
(chain, round, site); ``VerifyIntersection`` accepts within ``verify_eps``,
0.0 reproducing the reference's always-reject exact equality; a
device-resident bounding-box reduction).  On a CUDA device
(``ops/light_pass.py::light_route``) the seed paths are one launch of
kernel L2a and the chain with its emission one of L2b, one warp a
chain.  The plain version, on the CPU or with ``plain=True``, is batched
PyTorch on the film's device: ~100
``trace_ray`` calls on nlights * n_seedpaths rays, every chain traced at
every stage and the results masked.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..ops.intersect import SceneArrays, prep_scene, trace_ray
from ..ops import light_pass
from ..ops import vlp as vlpmod
from ..scene.scene import Scene
from . import common as C
from .bidirectional import check_device, film_vlp, grid_frame_only, vlp_grid

# RNG site space: chains use ray_id = chain index and sites >= 256
_SITE_SEED = 192          # + vertex slot (seed-path directions)
_SITE_MLT = 256           # + round * 16 + purpose
_P_DECIDE = 0             # mutate/extend decision draws
_P_PERTURB = 2            # + vertex slot (3 uniforms each)
_P_ADD = 6                # + addition slot (direction draws)
_P_REBUILD = 10           # + vertex slot (rebuild directions)

_S1 = np.float32(1.0 / 512.0)   # perturbation scales (ocl:188-190)
_S2 = np.float32(1.0 / 16.0)
_RATIO = float(_S1 / _S2)
_DX_OFFSET = float(_S1 / (_S1 / _S2 + 1.0))
_MASK = 0xFFFFFFFF


def _slot_set(v, slot, new, mask):
    """v: (B, 4, 3); write ``new`` (B, 3) at per-chain ``slot`` where mask."""
    slots = torch.arange(4, device=v.device)
    one_hot = (slots[None, :] == slot[:, None]) & mask[:, None]
    return torch.where(one_hot[..., None], new[:, None, :], v)


def _slot_get(v, slot):
    """v: (B, 4, 3) -> (B, 3) at per-chain slot (clamped)."""
    s = torch.clamp(slot, 0, 3).to(torch.int64)
    idx = s[:, None, None].expand(v.shape[0], 1, 3)
    return torch.gather(v, 1, idx)[:, 0, :]


def _add_vertex(key, scn, quirks, origin, site, attempt, chain, plain):
    """AddRandomVertex (ocl:157-168) batched: random direction, one trace;
    returns (hit_mask, hit_point).  ``site`` may be a per-row tensor;
    ``plain`` as in ``trace_ray``."""
    u1, u2 = rngmod.rand2(key, chain, site)
    d = vlpmod.uniform_sphere(u1, u2)
    tr = trace_ray(origin, d, scn, quirks=quirks, sphere_material=3,
                   plain=plain)
    hit = attempt & (tr.material != 0)
    x = origin + d * tr.t[..., None]
    return hit, x


def _random_path(key, scn, quirks, origin, site_base, build, chain,
                 plain):
    """GetRandomPath (ocl:171-181) batched: up to 4 chained random vertices."""
    B = origin.shape[0]
    v = torch.zeros((B, 4, 3), dtype=torch.float32, device=origin.device)
    length = torch.zeros(B, dtype=torch.int32, device=origin.device)
    cur = origin
    building = build
    for i in range(4):
        hit, x = _add_vertex(key, scn, quirks, cur, site_base + i, building,
                             chain, plain)
        v[:, i, :] = torch.where(hit[:, None], x, v[:, i, :])
        length = length + hit.to(torch.int32)
        cur = torch.where(hit[:, None], x, cur)
        building = building & hit
    return v, length


def _perturbation(key, chain, vertex, site):
    """Szirmay-Kalos-style perturbation (ocl:184-222)."""
    u1, u2, u3 = rngmod.randn_draws(key, chain, site, 3)
    r = torch.stack([u1, u2, u3], dim=-1)
    s1 = torch.as_tensor(_S1, device=r.device)   # tensor / tensor: one rounding
    dx = s1 / (_RATIO + torch.abs(2.0 * r - 1.0)) - _DX_OFFSET
    plus = torch.where(vertex < 1.0, vertex + dx, vertex + dx - 1.0)
    minus = torch.where(vertex < 0.0, vertex - dx + 1.0, vertex - dx)
    return torch.where(r < 0.5, plus, minus)


def _verify(scn, quirks, origin, dest, eps, plain):
    """VerifyIntersection (ocl:225-236): re-trace toward ``dest`` and check
    the first hit is ``dest`` (within eps; eps=0 reproduces the reference's
    exact-equality rejection)."""
    d = C.normalize(dest - origin)
    tr = trace_ray(origin, d, scn, quirks=quirks, sphere_material=3,
                   plain=plain)
    x = origin + d * tr.t[..., None]
    if eps == 0.0:
        close = (x == dest).all(dim=-1)
    else:
        q = x - dest
        close = C.dot(q, q) < float(np.float32(eps * eps))
    return (tr.material != 0) & close


def _mutate(key, scn, quirks, verify_eps, light_origin, v, length, rnd,
            chain, plain):
    """One Mutate round (ocl:239-283), batched over all chains; ``rnd`` is
    the per-chain round index (r + light * rounds)."""
    B = v.shape[0]
    base = (_SITE_MLT + rnd * 16) & _MASK

    # empty paths: try to build a fresh one (ocl:242-245)
    empty = length == 0
    nv, nl = _random_path(key, scn, quirks, light_origin, base + _P_REBUILD,
                          empty, chain, plain)
    v = torch.where(empty[:, None, None], nv, v)
    length = torch.where(empty, nl, length)
    active = length > 0

    r1, r2 = rngmod.rand2(key, chain, base + _P_DECIDE)
    mut_prob = 1.0 / (length.to(torch.float32) + 0.2)
    do_mutate = active & (mut_prob >= r1)   # ocl:247-248 returns if prob < r

    # perturb + verify each vertex in chain order (ocl:250-258)
    temp_v = v.clone()
    temp_len = torch.zeros(B, dtype=torch.int32, device=v.device)
    cur = light_origin
    ok_chain = do_mutate
    for i in range(4):
        pv = _perturbation(key, chain, v[:, i, :], base + (_P_PERTURB + i))
        in_range = i < length
        ver = _verify(scn, quirks, cur, pv, verify_eps, plain)
        accept = ok_chain & in_range & ver
        temp_v[:, i, :] = torch.where(accept[:, None], pv, temp_v[:, i, :])
        temp_len = temp_len + accept.to(torch.int32)
        cur = torch.where(accept[:, None], pv, cur)
        ok_chain = ok_chain & (accept | ~in_range)

    replace = do_mutate & (temp_len == length)   # ocl:259-261
    v = torch.where(replace[:, None, None], temp_v, v)

    # probabilistic vertex additions (ocl:262-282); the branch is chosen by
    # the length at entry, additions chain and stop at the first failure,
    # and run only on mutating rounds (the reference returns early, ocl:248)
    entry_len = length
    t0 = ((entry_len == 1) & (r2 > 0.3)) | ((entry_len == 2) & (r2 < 0.3)) \
        | ((entry_len == 3) & (r2 < 0.2))
    t1 = ((entry_len == 1) & (r2 > 0.7)) | ((entry_len == 2) & (r2 < 0.2))
    t2 = (entry_len == 1) & (r2 > 0.9)
    ok = do_mutate
    for j, want in enumerate((t0, t1, t2)):
        attempt = ok & want & (length < 4)
        origin_j = _slot_get(v, length - 1)
        hit, x = _add_vertex(key, scn, quirks, origin_j, base + (_P_ADD + j),
                             attempt, chain, plain)
        v = _slot_set(v, length, x, hit)
        length = length + hit.to(torch.int32)
        ok = ok & (hit | ~attempt)
    return v, length


def _chain_layout(scn, n_seedpaths, chain0, chains, device):
    nlights = int(scn.lights.shape[0])
    B = chains if chains is not None else n_seedpaths
    lights = torch.as_tensor(scn.lights, dtype=torch.float32, device=device)
    lp = torch.repeat_interleave(lights[:, :3], B, dim=0)
    intensity = torch.repeat_interleave(lights[:, 3], B)
    light_idx = torch.repeat_interleave(
        torch.arange(nlights, dtype=torch.int64, device=device), B)
    chain = (torch.arange(B, dtype=torch.int64, device=device)
             + int(chain0)).repeat(nlights) & _MASK
    return nlights, B, lp, intensity, light_idx, chain


def mlt_seed(key, scn: SceneArrays, n_seedpaths: int,
             quirks: Quirks = DEFAULT, chain0: int = 0,
             chains: int | None = None, device="cuda", plain: bool = False):
    """The seed-path stage alone (the reference's ``lightTracer`` kernel,
    vlpgrid .c:182-221 dispatch): returns the (v, length) chain state the
    Metropolis stage mutates.  Kernel L2a on a CUDA device, else (or with
    ``plain=True``) batched PyTorch."""
    device = C.check_device(device)
    if not plain and light_pass.light_route(device) == "light_pass":
        return light_pass.mlt_seed(key, scn, n_seedpaths, quirks, chain0,
                                   chains, device)
    nlights, B, lp, _, light_idx, chain = _chain_layout(
        scn, n_seedpaths, chain0, chains, device)
    build = torch.ones(nlights * B, dtype=torch.bool, device=lp.device)
    return _random_path(key, scn, quirks, lp, _SITE_SEED + 4 * light_idx,
                        build, chain, plain)


def mlt_mutate_emit(key, scn: SceneArrays, n_seedpaths: int,
                    mutation_rounds: int, quirks: Quirks = DEFAULT,
                    verify_eps: float = 1e-3, seed_state=None,
                    chain0: int = 0, chains: int | None = None,
                    device="cuda", plain: bool = False):
    """Mutation rounds + VLP emission (the reference's
    ``MetropolisLightTracer`` kernel, vlpgrid .c:223-264 dispatch) on the
    seed state from :func:`mlt_seed`.  Kernel L2b on a CUDA device, else
    (or with ``plain=True``) batched PyTorch."""
    device = C.check_device(device)
    if not plain and light_pass.light_route(device) == "light_pass":
        return light_pass.mlt_mutate_emit(
            key, scn, n_seedpaths, mutation_rounds, quirks, verify_eps,
            seed_state, chain0, chains, device)
    nlights, B, lp, intensity, light_idx, chain = _chain_layout(
        scn, n_seedpaths, chain0, chains, device)
    total_paths = n_seedpaths * nlights
    scale_den = max(1, total_paths // 256)
    v, length = seed_state

    rounds = max(1, mutation_rounds)
    for r in range(mutation_rounds):
        v, length = _mutate(key, scn, quirks, verify_eps, lp, v, length,
                            r + light_idx * rounds, chain, plain)

    # emit <= 4 VLPs per chain, intensity halved per depth (ocl:522-527)
    origin = lp
    alive = length > 0
    slots = []
    for i in range(4):
        d = C.normalize(v[:, i, :] - origin)
        vlp = vlpmod.vlp_from_light_sample(
            origin, d, intensity / float(1 << i), scale_den, scn, quirks,
            base=vlpmod._MLT_BASE, plain=plain)
        emit = alive & (i < length) & (vlp[:, 3] > 0)
        vlp = torch.where(emit[:, None], vlp, 0.0)
        slots.append(vlp)
        alive = emit   # reference breaks when curr_vlp.w == 0 (ocl:525)
        origin = torch.where(emit[:, None], v[:, i, :], origin)
    # original (per-light) ordering: light-major, slot-minor
    out = [slots[i][l * B:(l + 1) * B]
           for l in range(nlights) for i in range(4)]
    return torch.cat(out, dim=0)


def mlt_vlps(key, scn: SceneArrays, n_seedpaths: int, mutation_rounds: int,
             quirks: Quirks = DEFAULT, verify_eps: float = 1e-3,
             chain0: int = 0, chains: int | None = None, device="cuda",
             plain: bool = False):
    """Seed + mutate + emit: (nlights * n_seedpaths * 4, 4) VLPs.

    total_paths scaling: base intensity / (total_paths / 256) with the
    reference's integer division (ocl:418), guarded to >= 1.  All lights'
    chains run in one batch; every draw keys on the per-light chain index
    and site.  ``chain0``/``chains`` restrict to the chain window
    [chain0, chain0+chains) of each light (result (nlights * 4 * chains,
    4), layout [light][slot][chain]); draws key on the GLOBAL chain index
    (and scale_den on the global n_seedpaths), so window rows are
    bit-identical to the same rows of the full run.  On a CUDA device:
    kernels L2a and L2b, one launch each;
    ``plain=True`` keeps both stages on batched PyTorch."""
    device = C.check_device(device)
    if int(scn.lights.shape[0]) == 0:
        return torch.zeros((0, 4), dtype=torch.float32, device=device)
    seed = mlt_seed(key, scn, n_seedpaths, quirks, chain0, chains, device,
                    plain)
    return mlt_mutate_emit(key, scn, n_seedpaths, mutation_rounds, quirks,
                           verify_eps, seed, chain0, chains, device, plain)


def film_metropolis(key, scn: SceneArrays, width, height, spp, spp_offset,
                    spp_total, n_seedpaths, mutation_rounds, quirks,
                    max_bounces=C.MAX_BOUNCES, use_grid: bool = False,
                    grid_modifier: float = 3.0, verify_eps: float = 1e-3,
                    precomputed_vlps=None, precomputed_grid=None,
                    grid_res=None, row_offset=0, rows=None, device="cuda"):
    device = check_device(device)
    frame_only = grid_frame_only(scn, quirks, max_bounces, device)
    if precomputed_vlps is not None:
        vlps = torch.as_tensor(precomputed_vlps, dtype=torch.float32,
                               device=device)
    else:
        vlps = mlt_vlps(key, scn, n_seedpaths, mutation_rounds, quirks,
                        verify_eps, device=device)
    grid = precomputed_grid
    if use_grid and grid is None:
        res = (grid_res if grid_res is not None else
               vlpmod.vlp_grid_static_res(int(vlps.shape[0]),
                                          grid_modifier))
        grid = vlp_grid(vlps, res, frame_only)
    return film_vlp(key, scn, vlps, grid, width, height, spp, spp_offset,
                    spp_total, quirks, max_bounces, row_offset, rows, device)


def render_metropolis(key, scene: Scene | SceneArrays, width: int = 512,
                      height: int = 512, spp: int = 64,
                      n_seedpaths: int = 512, mutation_rounds: int = 8,
                      spp_offset: int = 0, spp_total: int | None = None,
                      quirks: Quirks = DEFAULT,
                      max_bounces: int = C.MAX_BOUNCES,
                      use_grid: bool = False, grid_modifier: float = 3.0,
                      verify_eps: float = 1e-3,
                      dynamic_grid_res: bool = False, device="cuda"):
    """Render with Metropolis light transport; returns the pre-ambient film
    (H, W, 3) on ``device``.  The CLI mirrors the reference's
    [nseedpaths] [mutation_rounds] (+ [CELL_SIZE_MODIFIER] for the grid
    variant; .c:297-315, vlpgrid .c:429-451).

    ``dynamic_grid_res=True`` is the reference-parity grid mode: the VLP
    box is reduced on the device and read back to the host (the
    reference's one mid-pipeline blocking sync, vlpgrid .c:609), and the
    grid resolution is derived from the box per .c:629-636
    (ops/vlp.py::vlp_grid_dynamic_res)."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if spp_total is None:
        spp_total = spp
    device = check_device(device)
    grid_res = None
    vlps = None
    if use_grid and dynamic_grid_res:
        vlps = mlt_vlps(key, scn, n_seedpaths, mutation_rounds, quirks,
                        verify_eps, device=device)
        # THE host sync: the reference's blocking box read (.c:609)
        vmin, vmax = (b.cpu().numpy() for b in vlpmod.vlp_bounds(vlps))
        grid_res = vlpmod.vlp_grid_dynamic_res(vmin, vmax,
                                               int(vlps.shape[0]),
                                               grid_modifier)
    return film_metropolis(key, scn, width, height, spp, spp_offset,
                           spp_total, n_seedpaths, mutation_rounds, quirks,
                           max_bounces, use_grid, grid_modifier, verify_eps,
                           precomputed_vlps=vlps, grid_res=grid_res,
                           device=device)
