"""Timing of the diagnostics' calls: CUDA events on the card, the host
clock on the CPU."""

from __future__ import annotations

import time

import torch


def call_ms(fn, device) -> tuple[object, float]:
    """(fn(), its ms): CUDA events around the call on a CUDA device (the
    device work, synchronised), else the host clock."""
    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end)


def best_ms(fn, device, repeats: int) -> tuple[object, float, float]:
    """(last output, best ms of ``repeats`` calls, ms of the first call,
    which the others follow warm)."""
    out, first = call_ms(fn, device)
    best = float("inf")
    for _ in range(repeats):
        out, ms = call_ms(fn, device)
        best = min(best, ms)
    return out, best, first
