"""Image-quality metrics for golden-render validation (SURVEY.md section 4,
BASELINE.json metric: RMSE vs SimpleCPUTracer; spp to fixed RMSE).

Port of ``opencl_montecarlo_path_tracing_tpu/utils/metrics.py``: the same
NumPy functions.  ``render_at_spp`` may return a tensor on any device."""

from __future__ import annotations

import numpy as np


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else a


def rmse(a, b) -> float:
    a = np.asarray(_host(a), np.float64)
    b = np.asarray(_host(b), np.float64)
    return float(np.sqrt(((a - b) ** 2).mean()))


def rmse_u8(a, b) -> float:
    """RMSE in 8-bit units (0..255 scale)."""
    return rmse(a, b)


def correlation(a, b) -> float:
    a = np.asarray(_host(a), np.float64).reshape(-1)
    b = np.asarray(_host(b), np.float64).reshape(-1)
    return float(np.corrcoef(a, b)[0, 1])


def psnr(a, b, peak: float = 255.0) -> float:
    r = rmse(a, b)
    return float("inf") if r == 0 else 20.0 * np.log10(peak / r)


def spp_to_rmse(render_at_spp, reference_img, target: float,
                spp_schedule=(16, 32, 64, 128, 256, 512, 1024, 2048)):
    """Smallest spp from the schedule whose render reaches RMSE <= target
    against ``reference_img``; returns (spp or None, history)."""
    history = []
    for spp in spp_schedule:
        r = rmse(render_at_spp(spp), reference_img)
        history.append((spp, r))
        if r <= target:
            return spp, history
    return None, history
