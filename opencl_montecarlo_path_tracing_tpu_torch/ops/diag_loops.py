"""Loop-overhead microbenchmarks (kernel B8-loops): wrapper and plain
version.

``run(arm, x, n1, n2, acc0, table)`` runs one of 13 arms on the (8, 128)
float32 tile ``x``: a dependent chain on the accumulator a, which starts
at ``acc0`` (zeros by default, as in the JAX tool), and returns a + x:

  ``flat1/4/16/64``  n1 iterations of 1/4/16/64 steps a = a * 0.999 + 1e-6;
  ``chunk32/128``    n1 iterations of 32/128 such steps (the inner loop
                     unrolled);
  ``nested``         n1 x n2 iterations of one step;
  ``bcast``          n1 iterations of a = a + float(i);
  ``reduce_full``, ``reduce_lane``, ``reduce_sub``
                     n1 iterations of a = a + r * 1e-9, r the max of a over
                     the tile, its row of 128, or its column of 8;
  ``copy``           n1 iterations copying the (16, 128) slice at column
                     (i % 16) * 128 of the (16, 2048) ``table`` into fast
                     memory, c = c + slice[0, 0]; returns x + c;
  ``scalar``         n1 iterations of one thread's s[c & 7] = i, c += 1;
                     returns x + float(c).

On a CUDA tensor ``run`` launches the hand-written kernel of
``csrc/diag_loops.cu``, which replaces the TPU kernels of the JAX
package's ``tools/diag_loops.py`` (``pl.pallas_call`` at :47, :70, :85,
:103, :119, :136).  Its layout gives each chain a thread and each warp
a scheduler: the element-wise arms run 8 blocks of 128 threads, a thread
an element; the full reduce one block of 4 warps, the lane reduce a warp
a row, the sub reduce a thread a column; the copy one warp's 16-byte
cp.async, a 512-byte row a step, waited on and then a warp barrier; the
scalar arm one thread.  Each arm is bound by its chain's latency (and,
for the full reduce and the copy, the exchange across warps and the
round trip to L2 that lie on it).
``run_plain`` is the same chain in plain PyTorch, on any device; each
multiply and add rounds on its own on both sides (the kernel builds with
--fmad=false, and a max is exact), so the two agree bit for bit.  The
wrapper takes it only for a CPU tensor.
"""

from __future__ import annotations

import torch

#: Launches of the CUDA kernel since the last reset (the wrapper adds one
#: per launch and nowhere else).
LAUNCHES = 0

ARMS = ("flat1", "flat4", "flat16", "flat64", "chunk32", "chunk128",
        "nested", "bcast", "reduce_full", "reduce_lane", "reduce_sub",
        "copy", "scalar")
#: steps a * 0.999 + 1e-6 an iteration of the multiply-add arms
STEPS = {"flat1": 1, "flat4": 4, "flat16": 16, "flat64": 64, "chunk32": 32,
         "chunk128": 128, "nested": 1}
TABLE_SHAPE = (16, 2048)


def run_plain(arm: str, x: torch.Tensor, n1: int, n2: int = 0,
              acc0: torch.Tensor | None = None,
              table: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`run`, on any device."""
    acc0 = _check(arm, x, n1, n2, acc0, table)
    a = acc0.clone()
    if arm in STEPS:
        steps = n1 * STEPS[arm] * (n2 if arm == "nested" else 1)
        for _ in range(steps):
            a = a * 0.999 + 1e-6
        return a + x
    if arm == "bcast":
        for i in range(n1):
            a = a + float(i)
        return a + x
    if arm.startswith("reduce"):
        dims = {"reduce_full": (0, 1), "reduce_lane": (1,),
                "reduce_sub": (0,)}[arm]
        for _ in range(n1):
            a = a + a.amax(dim=dims, keepdim=True) * 1e-9
        return a + x
    if arm == "copy":
        c = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n1):
            col = (i % 16) * 128
            c = c + table[:, col:col + 128].clone()[0, 0]
        return x + c
    s = [0] * 8
    c = 0
    for i in range(n1):
        s[c & 7] = i
        c += 1
    return x + float(c)


def _check(arm, x, n1, n2, acc0, table) -> torch.Tensor:
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}: one of {ARMS}")
    if n1 < 0 or n2 < 0 or n1 >= 2 ** 31 or n2 >= 2 ** 31:
        raise ValueError("trip counts must lie in [0, 2^31)")
    for name, a, shape in (("x", x, (8, 128)), ("acc0", acc0, (8, 128)),
                           ("table", table, TABLE_SHAPE)):
        if a is None:
            continue
        if tuple(a.shape) != shape or a.dtype != torch.float32 \
                or a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on x's device")
    if arm == "copy" and table is None:
        raise ValueError("the copy arm takes a (16, 2048) table")
    return torch.zeros_like(x) if acc0 is None else acc0


def run(arm: str, x: torch.Tensor, n1: int, n2: int = 0,
        acc0: torch.Tensor | None = None,
        table: torch.Tensor | None = None) -> torch.Tensor:
    """One arm's (8, 128) output; a CUDA tensor launches the kernel (or
    raises), a CPU tensor takes :func:`run_plain`."""
    global LAUNCHES
    if x.device.type == "cpu":
        return run_plain(arm, x, n1, n2, acc0, table)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    acc0 = _check(arm, x, n1, n2, acc0, table)
    if table is not None and table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (cp.async)")
    out = torch.empty_like(x)
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.diag_loops_launch(
            ARMS.index(arm), x.data_ptr(), acc0.data_ptr(),
            table.data_ptr() if table is not None else None, n1, n2,
            out.data_ptr(), stream)
    if err != 0:
        msg = lib.diag_loops_error_string(err).decode()
        raise RuntimeError(f"diag_loops launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    return out
