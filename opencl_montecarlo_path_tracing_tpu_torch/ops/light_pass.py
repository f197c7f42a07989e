"""The light pass's kernels (L1; L2a and L2b): wrappers, route and the
CPU twins of their triangle stage.

The VLP family's light pass - the bidirectional emission
(``ops/vlp.py::emit_vlps``), and the Metropolis seed paths and chain
(``models/metropolis.py::mlt_seed`` and ``mlt_mutate_emit``) - runs on a
CUDA device in the hand-written kernels of ``csrc/light_pass.cu``, one
warp a (light, work item) or a (light, chain):

* L1, ``emit``: the emission, one launch;
* L2a, ``mlt_seed``: the seed paths, one launch;
* L2b, ``mlt_mutate_emit``: every mutation round and the emission, one
  launch.  L2a and L2b stay apart so that the staged CLI keeps its two
  Metropolis stages.

There is no TPU kernel to replace: the JAX package runs the same code as
XLA under one ``jax.jit``.  The plain version is the routed functions
with ``plain=True`` (today's batched PyTorch, on any device).

Design and bound (``csrc/light_pass.cu``'s header).  The work is FP32
issue in the traces' triangle stage, ~48 operations a (ray, triangle)
pair.  A trace gets a whole warp, so that the main paths' 1,024 chains or
work items fill the card's 132 SMs and a chain's branches are
warp-uniform; the lanes split the triangle stage:

* below 2,048 triangles (``ops/intersect.py::_MXU_MIN_TRIANGLES``) the
  full scan, 32 rows a step, a ballot of the candidates and their
  running-minimum update in row order: the sequential scan's result and
  rounding exactly, so the tables are bit-equal to the plain light pass;
* from 2,048 triangles the culled walk over the Morton block tables
  (``mega_super.block_tables``: the node tree, 32 sub-block boxes one a
  lane, a taken sub-block's rows one a lane), where the plain light
  pass's traces take kernel B7's matmul form: the two agree to rounding,
  exact ties going to the lowest triangle index in both.

The bound this repo states for them is the yardstick (every triangle of
each trace) and, beside it, the one restated over the design's own work:
the rows scanned and the box tests, from the counting launch (``stats``).
:func:`light_route` decides, before any launch, whether a light pass
takes the kernels (a CUDA device) and :func:`triangle_route` how they
trace the scene's triangles (its size).  A kernel that fails to build or
launch raises.

:func:`scan_twin` and :func:`walk_twin` are NumPy twins of the two
triangle stages, float32 operation for operation, which the CPU tests
hold to the sequential scan and to each other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.quirks import Quirks
from ..models.common import check_device
from .intersect import _MXU_MIN_TRIANGLES, SceneArrays
from .mega_super import _stream, _u32_arg, block_tables, scene_buffer

#: Launches of L1 (the emission), L2a (the seed paths) and L2b (the chain
#: and its emission) since the last reset (each wrapper adds one per
#: launch and nowhere else).
EMIT_LAUNCHES = 0
SEED_LAUNCHES = 0
CHAIN_LAUNCHES = 0

_MASK = 0xFFFFFFFF


def light_route(device) -> str:
    """How ``device`` runs a light pass: ``"light_pass"`` (kernels L1 /
    L2a / L2b) on a CUDA device, else ``"plain"`` (the batched PyTorch
    light pass on ``device``)."""
    return "light_pass" if torch.device(device).type == "cuda" else "plain"


class Consts(NamedTuple):
    """The plain modules' float32 constants the kernels compute with:
    2 pi (ops/vlp.py ``_TWO_PI``) and the perturbation's S1, S1 / S2 and
    offset (models/metropolis.py ``_S1``, ``_RATIO``, ``_DX_OFFSET``)."""
    two_pi: float
    s1: float
    ratio: float
    dx_offset: float


def consts() -> Consts:
    from ..models import metropolis as MT
    from . import vlp
    return Consts(vlp._TWO_PI, float(MT._S1), MT._RATIO, MT._DX_OFFSET)


class EmitArgs(NamedTuple):
    """L1's scalar arguments."""
    k0: int
    k1: int
    gi0: int          # the window's first work item, modulo 2^32
    count: int        # work items a light
    nl: int
    reuse_dir: int    # quirks.reuse_light_direction
    neg_t: int        # quirks.accept_negative_t
    inv_scale: float  # float32 1 / max(1, nl * n_vlp // 512)


class ChainArgs(NamedTuple):
    """L2a's and L2b's scalar arguments."""
    k0: int
    k1: int
    chain0: int       # the window's first chain, modulo 2^32
    chains: int       # chains a light
    nl: int
    rounds: int       # mutation rounds: round r of light l is r + l * it
    neg_t: int
    exact: int        # verify_eps == 0: VerifyIntersection's exact test
    eps2: float       # float32 verify_eps * verify_eps
    inv_scale: float  # float32 1 / max(1, nl * n_seedpaths // 256)


def _inv(den: int) -> float:
    """The float32 reciprocal torch's CUDA division by the float ``den``
    multiplies with."""
    return float(np.float32(1.0) / np.float32(den))


def emit_args(key, scn: SceneArrays, n_vlp: int, quirks: Quirks,
              gi0: int = 0, count: int | None = None) -> EmitArgs:
    nl = int(scn.lights.shape[0])
    return EmitArgs(
        _u32_arg("k0", key[0]), _u32_arg("k1", key[1]), int(gi0) & _MASK,
        int(n_vlp if count is None else count), nl,
        int(bool(quirks.reuse_light_direction)),
        int(bool(quirks.accept_negative_t)),
        _inv(max(1, n_vlp * nl // 512)))


def chain_args(key, scn: SceneArrays, n_seedpaths: int, quirks: Quirks,
               mutation_rounds: int = 0, verify_eps: float = 1e-3,
               chain0: int = 0, chains: int | None = None) -> ChainArgs:
    nl = int(scn.lights.shape[0])
    return ChainArgs(
        _u32_arg("k0", key[0]), _u32_arg("k1", key[1]), int(chain0) & _MASK,
        int(n_seedpaths if chains is None else chains), nl,
        int(mutation_rounds),
        int(bool(quirks.accept_negative_t)), int(verify_eps == 0.0),
        float(np.float32(verify_eps * verify_eps)),
        _inv(max(1, n_seedpaths * nl // 256)))


def triangle_route(scn: SceneArrays) -> str:
    """How the kernels trace this scene's triangles: ``"walk"`` (the
    culled walk over the block tables) from 2,048 triangles, else
    ``"scan"`` (every row, 32 a step)."""
    nt = int(scn.tri_v0.shape[0])
    return "walk" if nt >= _MXU_MIN_TRIANGLES else "scan"


#: Slots of the counting launch's tally (csrc/light_pass.cu, Tally):
#: traces, triangle rows tested, tree-node and sub-block box tests,
#: candidates through the ordered update, clock64 cycles in the floor /
#: square / sphere stages, in the triangle stage and in the whole kernel.
STAT_NAMES = ("traces", "rows", "node_tests", "sub_tests", "candidates",
              "pre_cycles", "tri_cycles", "kernel_cycles")


def new_stats(device) -> torch.Tensor:
    """A zeroed stats buffer for the counting launch."""
    return torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=device)


def read_stats(stats: torch.Tensor) -> dict:
    return dict(zip(STAT_NAMES, stats.tolist()))


def _counting_args(device, stats, log) -> tuple:
    """The launchers' trailing arguments for the counting instantiation:
    the stats buffer (made when only a log is given) and the log."""
    if stats is None:
        stats = new_stats(device)
    for name, t, dtype in (("stats", stats, torch.int64),
                           ("log times", None if log is None else log[0],
                            torch.float32),
                           ("log indices", None if log is None else log[1],
                            torch.int32)):
        if t is not None and (t.device != device or t.dtype != dtype
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"on {device}")
    if stats.numel() != len(STAT_NAMES):
        raise ValueError(f"stats must hold {len(STAT_NAMES)} counters")
    if log is None:
        return stats.data_ptr(), None, None, 0
    return (stats.data_ptr(), log[0].data_ptr(), log[1].data_ptr(),
            int(log[0].shape[1]))


def _prologue(scn: SceneArrays, device, stats, log, culled):
    """The device checks and the route; (library, indexed device, the
    launchers' leading arguments: scene and block tables, their trailing
    ones: stats and log)."""
    device = check_device(device)
    if device.type != "cuda":
        raise ValueError(f"the light-pass kernels run on a CUDA device, "
                         f"not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    tail = ((None, None, None, 0) if stats is None and log is None
            else _counting_args(device, stats, log))
    walk = (triangle_route(scn) == "walk" if culled is None
            else bool(culled))
    if walk and int(scn.tri_v0.shape[0]) == 0:
        raise ValueError("the culled walk needs triangles")
    nl, ns = int(scn.lights.shape[0]), int(scn.sphere_centers.shape[0])
    nq = int(scn.square_k.shape[0])
    if walk:
        buf, rows, _, subs, nodes = block_tables(scn, device)
        lead = (buf.data_ptr(), 0, nl, ns, nq, rows.data_ptr(),
                subs.data_ptr(), nodes.data_ptr(), int(nodes.shape[0]))
    else:
        buf, ntp = scene_buffer(scn, device)
        lead = (buf.data_ptr(), ntp, nl, ns, nq, None, None, None, 0)
    from ..utils.build import load
    return load(), device, lead, tail


def _check_log(log, units: int):
    if log is not None and (log[0].shape != log[1].shape
                            or log[0].dim() != 2
                            or log[0].shape[0] != units):
        raise ValueError(f"the log holds (t, index) tensors of shape "
                         f"({units}, cap)")


def _raise(lib, err: int, name: str):
    if err != 0:
        msg = lib.light_pass_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def emit(key, scn: SceneArrays, n_vlp: int, quirks: Quirks, gi0: int = 0,
         count: int | None = None, device="cuda", stats=None, log=None,
         culled: bool | None = None):
    """L1: ``ops/vlp.py::emit_vlps`` (same arguments and output) in one
    launch on a CUDA ``device``.  ``stats``: an optional zeroed
    (len(STAT_NAMES),) int64 tensor on the device, which makes the launch
    the counting instantiation and receives its tally; ``log``: optional
    (t float32, index int32) tensors of shape (rows, cap) that receive the
    first ``cap`` traces of each row (the counting instantiation);
    ``culled``: force the culled walk (True) or the full scan (False)
    instead of :func:`triangle_route`."""
    global EMIT_LAUNCHES
    lib, device, lead, tail = _prologue(scn, device, stats, log, culled)
    a = emit_args(key, scn, n_vlp, quirks, gi0, count)
    _check_log(log, a.nl * a.count)
    out = torch.empty((a.nl * a.count, 4), dtype=torch.float32,
                      device=device)
    if out.shape[0] == 0:
        return out
    k = consts()
    with torch.cuda.device(device):
        err = lib.light_emit_launch(
            *lead, a.k0, a.k1, a.gi0, a.count, a.reuse_dir, a.neg_t, *k,
            a.inv_scale, out.data_ptr(), *tail, _stream(device))
    _raise(lib, err, "light_emit")
    EMIT_LAUNCHES += 1
    return out


def mlt_seed(key, scn: SceneArrays, n_seedpaths: int, quirks: Quirks,
             chain0: int = 0, chains: int | None = None, device="cuda",
             stats=None, log=None, culled: bool | None = None):
    """L2a: ``models/metropolis.py::mlt_seed`` (same arguments and
    output: the seed state v (B, 4, 3) float32 and length (B,) int32) in
    one launch on a CUDA ``device``; the rest as :func:`emit`."""
    global SEED_LAUNCHES
    lib, device, lead, tail = _prologue(scn, device, stats, log, culled)
    a = chain_args(key, scn, n_seedpaths, quirks, chain0=chain0,
                   chains=chains)
    rows = a.nl * a.chains
    _check_log(log, rows)
    v = torch.empty((rows, 4, 3), dtype=torch.float32, device=device)
    length = torch.empty(rows, dtype=torch.int32, device=device)
    if rows == 0:
        return v, length
    k = consts()
    with torch.cuda.device(device):
        err = lib.light_mlt_seed_launch(
            *lead, a.k0, a.k1, a.chain0, a.chains, a.neg_t, *k,
            v.data_ptr(), length.data_ptr(), *tail, _stream(device))
    _raise(lib, err, "light_mlt_seed")
    SEED_LAUNCHES += 1
    return v, length


def mlt_mutate_emit(key, scn: SceneArrays, n_seedpaths: int,
                    mutation_rounds: int, quirks: Quirks,
                    verify_eps: float = 1e-3, seed_state=None,
                    chain0: int = 0, chains: int | None = None,
                    device="cuda", stats=None, log=None,
                    culled: bool | None = None):
    """L2b: ``models/metropolis.py::mlt_mutate_emit`` (same arguments and
    output: the (nl * 4 * B, 4) table, [light][slot][chain]) in one launch
    on a CUDA ``device``, from the seed state ``(v, length)``; the rest as
    :func:`emit`."""
    global CHAIN_LAUNCHES
    lib, device, lead, tail = _prologue(scn, device, stats, log, culled)
    a = chain_args(key, scn, n_seedpaths, quirks, mutation_rounds,
                   verify_eps, chain0, chains)
    rows = a.nl * a.chains
    _check_log(log, rows)
    v, length = seed_state
    v = torch.as_tensor(v, dtype=torch.float32, device=device).contiguous()
    length = torch.as_tensor(length, device=device).to(
        torch.int32).contiguous()
    if tuple(v.shape) != (rows, 4, 3) or tuple(length.shape) != (rows,):
        raise ValueError(f"seed state shapes {tuple(v.shape)}, "
                         f"{tuple(length.shape)}; want ({rows}, 4, 3), "
                         f"({rows},)")
    out = torch.empty((4 * rows, 4), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    k = consts()
    with torch.cuda.device(device):
        err = lib.light_mlt_chain_launch(
            *lead, a.k0, a.k1, a.chain0, a.chains, a.rounds,
            a.neg_t, *k, a.exact, a.eps2, a.inv_scale,
            v.data_ptr(), length.data_ptr(), out.data_ptr(), *tail,
            _stream(device))
    _raise(lib, err, "light_mlt_chain")
    CHAIN_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# NumPy twins of the kernels' triangle stage (csrc/pt_device.cuh::
# warp_scan_closest, warp_walk_closest; trace_open's sequential scan),
# float32
# operation for operation, for the CPU tests.  Rays are (R, 3) float32; t0
# (R,) is the running distance the floor, squares and spheres leave; each
# returns (t (R,) float32, triangle index (R,) int, -1 where none wins).

_F = np.float32
_EPS_F = _F(0.01)
_SLACK_F = _F(1.001)
_CHUNK = 32


def _quads(rows, o, d):
    """row_quads: (dd, un_s, vn_s, tn_s), each (R, N), of rows (N, >= 12)
    float32 (v0, e0, e2, ...) against the rays, in the device's order."""
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z, e0x, e0y, e0z, e2x, e2y, e2z = (rows[None, :, i]
                                                    for i in range(9))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e0x * pvx + e0y * pvy + e0z * pvz
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    un = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * e0z - tvz * e0y
    qvy = tvz * e0x - tvx * e0z
    qvz = tvx * e0y - tvy * e0x
    vn = dx * qvx + dy * qvy + dz * qvz
    tn = e2x * qvx + e2y * qvy + e2z * qvz
    sg = np.where(det >= 0, _F(1), _F(-1))
    return det * sg, un * sg, vn * sg, tn * sg


def _valid(q, neg_t: bool):
    """quads_valid: inside the triangle, and in front unless neg_t."""
    dd, un_s, vn_s, tn_s = q
    ok = ((dd >= _EPS_F) & (un_s >= 0) & (un_s <= dd) & (vn_s >= 0)
          & (un_s + vn_s <= dd))
    return ok if neg_t else ok & (tn_s > _EPS_F * dd)


def _f32(o, d, t0):
    return (np.asarray(o, _F), np.asarray(d, _F),
            np.asarray(t0, _F).reshape(-1).copy())


def sequential_scan(tri, o, d, t0, neg_t: bool = False):
    """trace_open's scan: every row of ``tri`` (N, 12) in file order,
    strict <."""
    o, d, bn = _f32(o, d, t0)
    bd = np.ones_like(bn)
    best = np.full(bn.shape, -1, np.int64)
    for i in range(tri.shape[0]):
        q = _quads(tri[i:i + 1], o, d)
        dd, tn = q[0][:, 0], q[3][:, 0]
        up = _valid(q, neg_t)[:, 0] & (tn * bd < bn * dd)
        bn, bd = np.where(up, tn, bn), np.where(up, dd, bd)
        best[up] = i
    return bn / bd, best


def scan_twin(tri, o, d, t0, neg_t: bool = False):
    """warp_scan_closest: each 32-row chunk tested at once (lane j row j),
    the candidates' ballot, then the ordered update over its set bits in
    ascending order, each candidate's (tn_s, dd) broadcast."""
    o, d, bn = _f32(o, d, t0)
    bd = np.ones_like(bn)
    best = np.full(bn.shape, -1, np.int64)
    for base in range(0, tri.shape[0], _CHUNK):
        q = _quads(tri[base:base + _CHUNK], o, d)
        ballot = _valid(q, neg_t)                       # (R, lanes)
        for k in range(ballot.shape[1]):                # set bits, in order
            dd, tn = q[0][:, k], q[3][:, k]
            up = ballot[:, k] & (tn * bd < bn * dd)
            bn, bd = np.where(up, tn, bn), np.where(up, dd, bd)
            best[up] = base + k
    return bn / bd, best


def _box_closest(lo, hi, o, inv, bn, bd, neg_t: bool):
    """box_closest for boxes (B, >= 3) and one ray (the slab with NaN
    axes unconstrained, the eps / forward check, the prune with slack)."""
    t0 = (lo[:, :3] - o) * inv
    t1 = (hi[:, :3] - o) * inv
    nan = np.isnan(t0) | np.isnan(t1)
    tn = np.where(nan, -np.inf, np.minimum(t0, t1)).astype(_F)
    tf = np.where(nan, np.inf, np.maximum(t0, t1)).astype(_F)
    tmin, tmax = tn.max(axis=1), tf.min(axis=1)
    hit = tmax >= tmin
    if not neg_t:
        hit &= (tmax >= _EPS_F) & (np.maximum(tmin, _F(0)) * bd
                                   <= bn * _SLACK_F)
    return hit


def _int_bits(x) -> np.ndarray:
    return np.asarray(x, _F).view(np.int32)


def walk_twin(tables, o, d, t0, neg_t: bool = False, tally=None):
    """warp_walk_closest over ``tri_blocks.walk_tables``' (rows, boxes,
    subs, nodes), one ray at a time: the stackless node walk, a taken
    macro's sub-block boxes at once, the taken sub-blocks' rows in order
    with the ordered update, exact ties to the lowest original index, and
    the macro's later sub-blocks tested again after an update.  ``tally``
    (a dict) receives rows, node_tests, sub_tests and candidates."""
    rows, _, subs, nodes = tables
    o, d, t0 = _f32(o, d, t0)
    idx_of = _int_bits(rows[:, 12])
    tl = {"rows": 0, "node_tests": 0, "sub_tests": 0, "candidates": 0}
    t_out = np.empty_like(t0)
    i_out = np.full(t0.shape, -1, np.int64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for r in range(t0.shape[0]):
            oo, dd_ = o[r], d[r]
            inv = (_F(1) / dd_).astype(_F)
            bn, bd, bi = t0[r], _F(1), -1
            ni = 0
            while ni < nodes.shape[0]:
                lo, hi = nodes[ni, :4], nodes[ni, 4:]
                first = int(_int_bits(hi[3]))
                tl["node_tests"] += 1
                if not _box_closest(lo[None], hi[None], oo, inv, bn, bd,
                                    neg_t)[0]:
                    ni = int(_int_bits(lo[3])) if first < 0 else ni + 1
                    continue
                ni += 1
                if first < 0:
                    continue
                s0 = 4 * first
                srec = subs[s0:s0 + 4 * int(_int_bits(lo[3]))]
                live = _int_bits(srec[:, 3]) != 0
                tl["sub_tests"] += int(live.sum())
                need = live & _box_closest(srec[:, :4], srec[:, 4:], oo, inv,
                                           bn, bd, neg_t)
                k = 0
                while k < need.shape[0]:
                    if not need[k]:
                        k += 1
                        continue
                    blk = rows[_CHUNK * (s0 + k):_CHUNK * (s0 + k + 1)]
                    q = _quads(blk, oo[None], dd_[None])
                    cand = _valid(q, neg_t)[0]
                    tl["rows"] += int(_int_bits(srec[k, 3]))
                    moved = False
                    for j in np.flatnonzero(cand):
                        tl["candidates"] += 1
                        tn, dj = q[3][0, j], q[0][0, j]
                        num, den = tn * bd, bn * dj
                        ij = int(idx_of[_CHUNK * (s0 + k) + j])
                        if num < den or (num == den and ij < bi):
                            bn, bd, bi, moved = tn, dj, ij, True
                    if moved:
                        need[k + 1:] &= _box_closest(
                            srec[k + 1:, :4], srec[k + 1:, 4:], oo, inv, bn,
                            bd, neg_t)
                    k += 1
            t_out[r], i_out[r] = bn / bd, bi
    if tally is not None:
        for key_, v in tl.items():
            tally[key_] = tally.get(key_, 0) + v
    return t_out, i_out
