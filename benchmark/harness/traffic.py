"""Traffic: a mix's parameters (``benchmark/traffic/<name>.json``), read by
the generator that its ``loop`` names (``benchmark/loops/<loop>.py``)."""

from __future__ import annotations

from benchmark.harness import spec as _spec

MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def stream(mix: dict, seed: int):
    """The request stream of a run of ``mix`` from ``--seed``."""
    return _spec.plugin("loops", mix["loop"]).Stream(mix, seed)
