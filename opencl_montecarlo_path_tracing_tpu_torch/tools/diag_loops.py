"""Loop overhead on the card: the cost of one loop iteration against its
body size, unrolling, nesting, a scalar-to-vector broadcast, a reduction
across the tile and one small copy into fast memory.

The port of the JAX package's ``tools/diag_loops.py::main``: the same 13
arms (``ops/diag_loops.py``) at the same trip counts (``COUNTS``), each
timed as the best of 5 warm calls, printed as ms and ns an iteration under
the JAX tool's labels.

    python -m opencl_montecarlo_path_tracing_tpu_torch.tools.diag_loops \\
        [--device cuda|cpu]

``--device cpu`` runs the plain version (the counterpart of interpret
mode; the 25,600 x 64 chain takes a while).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import diag_loops as L
from .timing import best_ms

REPEATS = 5
#: the JAX tool's trip counts (n1, n2) and its label of each arm:
#: 25,600 steps of each chain, 6,400 reduce and copy iterations
COUNTS = {"flat1": (25600, 0), "flat4": (25600, 0), "flat16": (25600, 0),
          "flat64": (25600, 0), "chunk32": (800, 0), "chunk128": (200, 0),
          "nested": (200, 128), "bcast": (25600, 0),
          "reduce_full": (6400, 0), "reduce_lane": (6400, 0),
          "reduce_sub": (6400, 0), "copy": (6400, 0), "scalar": (25600, 0)}
LABELS = {"flat1": "flat fori adds=  1", "flat4": "flat fori adds=  4",
          "flat16": "flat fori adds= 16", "flat64": "flat fori adds= 64",
          "chunk32": "chunk-unroll 32 (same 25600 flat ops)",
          "chunk128": "chunk-unroll 128 (same 25600 flat ops)",
          "nested": "nested 200x128 adds=1",
          "bcast": "flat fori + scalar->vec broadcast",
          "reduce_full": "fori + full-reduce",
          "reduce_lane": "fori + lane-reduce",
          "reduce_sub": "fori + sub-reduce",
          "copy": "fori + 8KB HBM->SMEM DMA",
          "scalar": "scalar fori (SMEM store)"}


def iterations(arm: str, n1: int, n2: int) -> int:
    """Loop iterations of one call (the JAX tool's ns/iter divisor: the
    chain's steps for the multiply-add arms, n1 for the others)."""
    if arm.startswith("chunk"):
        return n1 * L.STEPS[arm]
    return n1 * n2 if arm == "nested" else n1


#: reduce_probe's shifts: the tile's max at column 127 - shift, in warp 3,
#: 2, 1 and 0 of the full reduce's block; the rows' maxima in slot 3, 2, 1
#: and 0 of the lane reduce's lanes
PROBE_SHIFTS = (0, 37, 74, 111)
#: the reduce axes of each reduce arm (None: the whole tile)
REDUCE_AXIS = {"reduce_full": None, "reduce_lane": 1, "reduce_sub": 0}


def reduce_probe(shift: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(x, acc0), float32 (8, 128), on which every output of the three
    reduce arms shows the max that its group read.

    x and acc0's background are uniform in [0, 1e-6), where an increment
    max * 1e-9 is thousands of ulps.  Column c holds one planted value,
    1 + (c + shift) % 128, at row c % 8: the columns' maxima are 1-128,
    the rows' 121-128 and the tile's 128, so two groups' maxima differ by
    at least 1/128 of the larger, and so does a group's max from the max
    of the group short of any one element (``probe_decodes``)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.0, 1e-6, (8, 128)).astype(np.float32)
    acc0 = rng.uniform(0.0, 1e-6, (8, 128)).astype(np.float32)
    c = np.arange(128)
    acc0[c % 8, c] = 1 + (c + shift) % 128
    return x, acc0


def probe_decodes(arm: str, out, x, acc0, n1: int) -> bool:
    """Whether every background element of ``out`` - ``arm`` run n1 >= 1
    iterations on ``reduce_probe``'s x and acc0 - rose by n1 times its own
    group's max * 1e-9, to 0.1%: an element that read another group's max,
    or a max short of one element, is off by 0.78% or more."""
    out, x, acc0 = (np.asarray(a, np.float64) for a in (out, x, acc0))
    want = np.max(acc0, axis=REDUCE_AXIS[arm], keepdims=True)
    got = (out - x - acc0) / (n1 * 1e-9)
    return bool(np.all(np.abs(got / want - 1.0)[acc0 < 0.5] < 1e-3))


def run_arms(device, counts=None) -> dict:
    """{arm: (out, best ms, ns an iteration)} of every arm on a zero tile
    and a zero table, as the JAX tool runs them, at ``counts`` (default:
    the JAX tool's)."""
    counts = COUNTS if counts is None else counts
    x = torch.zeros((8, 128), dtype=torch.float32, device=device)
    table = torch.zeros(L.TABLE_SHAPE, dtype=torch.float32, device=device)
    res = {}
    for arm in L.ARMS:
        n1, n2 = counts[arm]
        out, ms, _ = best_ms(lambda: L.run(arm, x, n1, n2, table=table),
                             device, REPEATS)
        ns = ms * 1e6 / max(1, iterations(arm, n1, n2))
        print(f"{LABELS[arm]}: {ms:.3f} ms -> {ns:.2f} ns/iter",
              flush=True)
        res[arm] = (out, ms, ns)
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
