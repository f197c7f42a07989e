"""Take-list primitives on fake blocks (kernel B8-prim): wrapper and plain
version.

``run(arm, x, nb, reps, flags)`` runs one of four arms on the (8, 128)
float32 tile ``x`` and returns (out (8, 128) float32, count (1,) int32).
Starting from a = 0, every repetition walks ``nb`` fake blocks:

  ``noop``         a += 1e-6 for every block;
  ``anycond``      a += 1e-6 for block b where any x > b / nb;
  ``scalarcond``   a += 1e-6 for block b where flags[b] != 0;
  ``takelist``     the flags of all blocks (any x > b / nb), the list of
                   flagged blocks, then a += 1e-6 * b for each listed b.

The take-list returns its count - the number of flagged blocks - as the
kernel writes it, on its only path; the other arms return 0, as the TPU
kernels write.  ``reps`` = 0 builds no list and leaves the take-list's
count at -1.

On a CUDA tensor ``run`` launches the hand-written kernel of
``csrc/diag_takelist.cu``, which replaces the TPU kernels of the JAX
package's ``tools/diag_primitives.py`` (``pl.pallas_call`` at :145):
``kernel_noop``, ``kernel_anycond``, ``kernel_scalarcond`` and
``kernel_takelist``.  The kernel holds the tile in one warp, 32 elements
a lane, and makes each block's decision with one warp vote; a lane's
predicate is one compare of its elements' max against the block's
threshold, from a table of b / nb made once a launch.  Each arm is one
chain of adds on a, which bounds it (the votes, flag reads and list
builds do not depend on a).  ``run_plain`` is the same function in plain
PyTorch, on any device, with the same float operations in the same order
(an add a block, the take-list's 1e-6 * b rounded before its add), so the
two agree bit for bit; the wrapper takes it only for a CPU tensor.
"""

from __future__ import annotations

import torch

#: Launches of the CUDA kernel since the last reset (the wrapper adds one
#: per launch and nowhere else).
LAUNCHES = 0

ARMS = ("noop", "anycond", "scalarcond", "takelist")
NB = 128           # fake blocks (tools/diag_primitives.py)
REPS = 200         # repetitions
_MAX_NB = 4096     # the kernel's list slots
_STEP = 1e-6


def _thresholds(nb: int, device) -> torch.Tensor:
    """(nb,) float32 b / nb, each an IEEE division of two floats."""
    b = torch.arange(nb, dtype=torch.float32, device=device)
    return b / torch.full_like(b, float(nb))


def flagged(x: torch.Tensor, nb: int) -> torch.Tensor:
    """(nb,) bool: the blocks b where any element of x is > b / nb."""
    return (x.reshape(1, -1) > _thresholds(nb, x.device)[:, None]).any(dim=1)


def run_plain(arm: str, x: torch.Tensor, nb: int = NB, reps: int = REPS,
              flags: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`run`, on any device."""
    _check(arm, x, nb, reps, flags)
    a = torch.zeros_like(x)
    cnt = torch.zeros(1, dtype=torch.int32, device=x.device)
    if arm == "takelist":
        cnt -= 1
        for _ in range(reps):
            listed = torch.nonzero(flagged(x, nb)).flatten()
            step = torch.full((int(listed.numel()),), _STEP,
                              dtype=torch.float32, device=x.device)
            terms = (step * listed.to(torch.float32)).tolist()
            for term in terms:
                a = a + term
            cnt = torch.full_like(cnt, len(terms))
        return a, cnt
    if arm == "noop":
        take = [True] * nb
    else:
        f = flagged(x, nb) if arm == "anycond" else flags != 0
        take = f.tolist()
    for _ in range(reps):
        for t in take:
            if t:
                a = a + _STEP
    return a, cnt


def _check(arm, x, nb, reps, flags):
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}: one of {ARMS}")
    if tuple(x.shape) != (8, 128) or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("x must be a contiguous (8, 128) float32 tensor")
    if not 0 <= nb <= _MAX_NB or reps < 0:
        raise ValueError(f"nb must lie in [0, {_MAX_NB}] and reps be >= 0")
    if arm == "scalarcond" and (
            flags is None or tuple(flags.shape) != (nb,)
            or flags.dtype != torch.int32 or flags.device != x.device
            or not flags.is_contiguous()):
        raise ValueError("scalarcond takes (nb,) int32 flags on x's device")


def run(arm: str, x: torch.Tensor, nb: int = NB, reps: int = REPS,
        flags: torch.Tensor | None = None):
    """(out, count) of one arm; a CUDA tensor launches the kernel (or
    raises), a CPU tensor takes :func:`run_plain`."""
    global LAUNCHES
    if x.device.type == "cpu":
        return run_plain(arm, x, nb, reps, flags)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(arm, x, nb, reps, flags)
    out = torch.empty_like(x)
    cnt = torch.full((1,), -1, dtype=torch.int32, device=x.device)
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.diag_takelist_launch(
            ARMS.index(arm), x.data_ptr(),
            flags.data_ptr() if flags is not None else None, nb, reps,
            out.data_ptr(), cnt.data_ptr(), stream)
    if err != 0:
        msg = lib.diag_takelist_error_string(err).decode()
        raise RuntimeError(f"diag_takelist launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    return out, cnt
