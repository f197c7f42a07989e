"""The common-random-number (CRN) contract between two films.

Two renders that consume the same threefry streams differ only by float
rounding, except on razor-edge pixels (horizon floor hits, silhouette
ties) where any two float implementations may flip a whole occlusion
unit.  ``tools/validate_crn_frame.py`` of the JAX package states the
contract per integrator family, on the display scale
``(film / spp * 64) / 255`` of the per-pixel max-channel difference:

* super and VLP families (the defaults here): the p99.5 quantile < 1e-5
  and razor-edge ties (difference > 1e-4) on < 0.6% of pixels;
* the simple family: p95 < 1e-5 and ties on < 2% (``SIMPLE``);
* a film against a NumPy oracle (models/oracle_*.py), the contract of the
  JAX package's ``tests/test_crn.py``: p98 < 1e-5, so that ties stay
  under a budget of 2% (``ORACLE``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Contract:
    quantile: float = 0.995
    q_limit: float = 1e-5
    tie_thresh: float = 1e-4
    tie_limit: float = 0.006


SUPER = Contract()                                  # super and VLP families
SIMPLE = Contract(quantile=0.95, tie_limit=0.02)
ORACLE = Contract(quantile=0.98, tie_limit=0.02)


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def crn_stats(a, b, spp: int, contract: Contract = SUPER) -> dict:
    """Display-scale statistics of two (..., 3) films of ``spp`` samples:
    ``q`` (the contract's quantile), ``max``, ``tie_frac`` and the raw
    film ``max_abs`` difference."""
    a, b = _numpy(a), _numpy(b)
    if a.shape != b.shape:
        raise ValueError(f"film shapes differ: {a.shape} vs {b.shape}")
    d = (a - b) / spp * 64.0 / 255.0
    dm = np.abs(d).max(axis=-1)
    return {"q": float(np.quantile(dm, contract.quantile)),
            "max": float(dm.max()),
            "tie_frac": float((dm > contract.tie_thresh).mean()),
            "max_abs": float(np.abs(a - b).max())}


def crn_ok(a, b, spp: int, contract: Contract = SUPER):
    """(passes, stats) of :func:`crn_stats` under ``contract``."""
    st = crn_stats(a, b, spp, contract)
    return (st["q"] < contract.q_limit
            and st["tie_frac"] < contract.tie_limit), st
