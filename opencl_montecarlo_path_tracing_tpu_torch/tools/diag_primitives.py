"""What a per-block "does any lane need this block?" decision costs on the
card: a loop with no decision, a per-block any-lane vote and branch, a
branch on a flag in fast memory, and a take-list (flag votes, a
branch-free list build, a loop of run-time trip count).

The port of the JAX package's ``tools/diag_primitives.py::main``: the four
arms of ``ops/diag_takelist.py`` on the same tile (uniforms from
``RandomState(0)`` halved, so blocks 0-63 of 128 are flagged), each timed
as the best of 5 warm calls, printed as ms, ns a block, the count and
``out[0, 0]``.  The take-list's count must equal the number of flagged
blocks; a mismatch raises.

    python -m opencl_montecarlo_path_tracing_tpu_torch.tools.diag_primitives \\
        [--device cuda|cpu]

``--device cpu`` runs the plain version (the counterpart of interpret
mode).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import diag_takelist as P
from .timing import best_ms

REPEATS = 5
NAMES = {"noop": "noop-loop   ", "anycond": "any+cond    ",
         "scalarcond": "scalar-cond ", "takelist": "take-list   "}


def inputs(device, nb: int = P.NB):
    """(x, flags): the JAX tool's tile and its every-other-block flags."""
    x = np.random.RandomState(0).rand(8, 128).astype(np.float32)
    x = torch.from_numpy(x).to(device) * 0.5     # half the blocks hit
    flags = torch.from_numpy((np.arange(nb) % 2 == 0).astype(np.int32))
    return x, flags.to(device)


def run_arms(device, nb: int = P.NB, reps: int = P.REPS) -> dict:
    """{arm: (out, count, best ms)} of the four arms."""
    x, flags = inputs(device, nb)
    print(f"NB={nb} blocks, REPS={reps}", flush=True)
    res = {}
    for arm in P.ARMS:
        (out, cnt), ms, _ = best_ms(
            lambda: P.run(arm, x, nb, reps, flags), device, REPEATS)
        per_block = ms * 1e6 / max(1, reps * nb)
        print(f"{NAMES[arm]}: best {ms:.3f} ms -> {per_block:.2f} ns/block "
              f"(cnt={int(cnt[0])}, out[0,0]={float(out[0, 0]):.4g})",
              flush=True)
        res[arm] = (out, int(cnt[0]), ms)
    want = int(P.flagged(x, nb).sum()) if reps else -1
    if res["takelist"][1] != want:
        raise RuntimeError(f"take-list count {res['takelist'][1]}, but "
                           f"{want} blocks are flagged")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "false")
    run_arms(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
