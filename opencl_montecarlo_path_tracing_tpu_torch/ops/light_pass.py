"""The light pass's kernels (L1; L2a and L2b): wrappers and route.

The VLP family's light pass - the bidirectional emission
(``ops/vlp.py::emit_vlps``), and the Metropolis seed paths and chain
(``models/metropolis.py::mlt_seed`` and ``mlt_mutate_emit``) - runs on a
CUDA device in the hand-written kernels of ``csrc/light_pass.cu``, one
thread a (light, work item) or a (light, chain):

* L1, ``emit``: the emission, one launch;
* L2a, ``mlt_seed``: the seed paths, one launch;
* L2b, ``mlt_mutate_emit``: every mutation round and the emission, one
  launch.  L2a and L2b stay apart so that the staged CLI keeps its two
  Metropolis stages.

There is no TPU kernel to replace: the JAX package runs the same code as
XLA under one ``jax.jit``.  The plain version is the routed functions
with ``plain=True`` (today's batched PyTorch, on any device), and the
kernels keep its float operations in its order, so the tables are
bit-equal to it on the card.

:func:`light_route` decides, before any launch, whether a light pass
takes the kernels: on a CUDA device, at every scene size (the kernels
stage a scene of <= 512 triangles in shared memory and read a larger one
in place from global memory); on the CPU the plain light pass.  A kernel
that fails to build or launch raises.  Past 2,048 triangles the plain
version's traces take kernel B7's matmul form (``ops/intersect.py::
trace_ray``), while the kernels keep the det-scaled scan of every size,
so there the two agree to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.quirks import Quirks
from ..models.common import check_device
from .intersect import SceneArrays
from .mega_super import _stream, _u32_arg, scene_buffer

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


def _prologue(scn: SceneArrays, device, traces):
    """The device checks; (library, indexed device, scene args, traces
    pointer)."""
    device = check_device(device)
    if device.type != "cuda":
        raise ValueError(f"the light-pass kernels run on a CUDA device, "
                         f"not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if traces is not None and (traces.device != device
                               or traces.dtype != torch.int64
                               or traces.numel() != 1):
        raise ValueError(f"traces must be a (1,) int64 tensor on {device}")
    buf, ntp = scene_buffer(scn, device)
    from ..utils.build import load
    scene = (buf.data_ptr(), ntp, int(scn.lights.shape[0]),
             int(scn.sphere_centers.shape[0]), int(scn.square_k.shape[0]))
    return (load(), device, scene,
            None if traces is None else traces.data_ptr())


def _raise(lib, err: int, name: str):
    if err != 0:
        msg = lib.light_pass_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def emit(key, scn: SceneArrays, n_vlp: int, quirks: Quirks, gi0: int = 0,
         count: int | None = None, device="cuda", traces=None):
    """L1: ``ops/vlp.py::emit_vlps`` (same arguments and output) in one
    launch on a CUDA ``device``.  ``traces``: an optional (1,) int64
    tensor on the device to which the launch adds its traces."""
    global EMIT_LAUNCHES
    lib, device, scene, tr = _prologue(scn, device, traces)
    a = emit_args(key, scn, n_vlp, quirks, gi0, count)
    out = torch.empty((a.nl * a.count, 4), dtype=torch.float32,
                      device=device)
    if out.shape[0] == 0:
        return out
    k = consts()
    with torch.cuda.device(device):
        err = lib.light_emit_launch(
            *scene, a.k0, a.k1, a.gi0, a.count, a.reuse_dir, a.neg_t, *k,
            a.inv_scale, out.data_ptr(), tr, _stream(device))
    _raise(lib, err, "light_emit")
    EMIT_LAUNCHES += 1
    return out


def mlt_seed(key, scn: SceneArrays, n_seedpaths: int, quirks: Quirks,
             chain0: int = 0, chains: int | None = None, device="cuda",
             traces=None):
    """L2a: ``models/metropolis.py::mlt_seed`` (same arguments and
    output: the seed state v (B, 4, 3) float32 and length (B,) int32) in
    one launch on a CUDA ``device``."""
    global SEED_LAUNCHES
    lib, device, scene, tr = _prologue(scn, device, traces)
    a = chain_args(key, scn, n_seedpaths, quirks, chain0=chain0,
                   chains=chains)
    rows = a.nl * a.chains
    v = torch.empty((rows, 4, 3), dtype=torch.float32, device=device)
    length = torch.empty(rows, dtype=torch.int32, device=device)
    if rows == 0:
        return v, length
    k = consts()
    with torch.cuda.device(device):
        err = lib.light_mlt_seed_launch(
            *scene, a.k0, a.k1, a.chain0, a.chains, a.neg_t, *k,
            v.data_ptr(), length.data_ptr(), tr, _stream(device))
    _raise(lib, err, "light_mlt_seed")
    SEED_LAUNCHES += 1
    return v, length


def mlt_mutate_emit(key, scn: SceneArrays, n_seedpaths: int,
                    mutation_rounds: int, quirks: Quirks,
                    verify_eps: float = 1e-3, seed_state=None,
                    chain0: int = 0, chains: int | None = None,
                    device="cuda", traces=None):
    """L2b: ``models/metropolis.py::mlt_mutate_emit`` (same arguments and
    output: the (nl * 4 * B, 4) table, [light][slot][chain]) in one launch
    on a CUDA ``device``, from the seed state ``(v, length)``."""
    global CHAIN_LAUNCHES
    lib, device, scene, tr = _prologue(scn, device, traces)
    a = chain_args(key, scn, n_seedpaths, quirks, mutation_rounds,
                   verify_eps, chain0, chains)
    rows = a.nl * a.chains
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
            *scene, a.k0, a.k1, a.chain0, a.chains, a.rounds,
            a.neg_t, *k, a.exact, a.eps2, a.inv_scale,
            v.data_ptr(), length.data_ptr(), out.data_ptr(), tr,
            _stream(device))
    _raise(lib, err, "light_mlt_chain")
    CHAIN_LAUNCHES += 1
    return out
