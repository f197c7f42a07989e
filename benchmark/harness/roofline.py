"""The least time the card could take for a counted amount of work.

Work is the cell's frozen count (``benchmark/work/<cell>.json``): the
traces that the reference's path rules make on the cell's frames, each at
one ray-triangle test of ``OPS_PER_TEST`` FP32 operations, and the bytes
that every implementation moves at least once (the raw scene read, the
float film written).  It is counted by the reference and never by the
program, so it is the same whatever implements a kernel, and no correct
kernel can take less time than it gives.
"""

from __future__ import annotations

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None."""
    with open(_PEAKS) as fp:
        return json.load(fp)["devices"].get(kind)


def least_seconds(ops: float, nbytes: float, peak: dict) -> float:
    """max(operations / peak FP32 rate, bytes / peak bandwidth)."""
    return max(ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])


def frame_work(work: dict) -> tuple[float, float]:
    """(FP32 operations, bytes) of one frame of the cell."""
    return float(work["frame_ops"]), float(work["frame_bytes"])


def kernel_share(ctx, kernel: str) -> float | None:
    """A kernel's share of its roofline, in %: the least time of the
    frame's work on one chip over the kernel's device time a frame.  None when the trace, the work or the card's peaks
    are missing, or the kernel did not run."""
    s, peak = ctx.summary, ctx.peak
    if s is None or peak is None or ctx.work is None or not ctx.frames:
        return None
    t = s.kernel_time(lambda name: kernel in name) / ctx.frames
    if t <= 0:
        return None
    ops, nbytes = frame_work(ctx.work)
    return 100.0 * least_seconds(ops, nbytes, peak) / t
