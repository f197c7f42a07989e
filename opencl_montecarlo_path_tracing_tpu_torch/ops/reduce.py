"""Film reduction: sample buffer or pre-ambient float film -> final RGBA
image, on the film's device.

Port of ``opencl_montecarlo_path_tracing_tpu/ops/reduce.py``
(``quantize_film``, ``quantize_film16`` and the nodof variant's
``reduce_samples``).  Reference: ``reduce4img_lmem``
(CLSuperPathTracer_lmem_NoDoF/pathtracer.ocl:253-274) tree-reduces each
8x8 work-group tile of the sample buffer, and its epilogue (ocl:268-271)
adds the ambient term (13,13,13), sets alpha=255 and converts to uchar4.
Here the reduction is a reshape and a sum over the sample-grid axes, on
whatever device holds the buffer.
"""

from __future__ import annotations

import numpy as np
import torch

AMBIENT = np.float32(13.0)


def quantize_film(film: torch.Tensor, wrap: bool = False) -> torch.Tensor:
    """Pre-ambient (H, W, 3) float film -> (H, W, 4) uint8: + ambient,
    trunc, alpha=255.  ``wrap`` reproduces the non-saturating
    convert_uchar4 (ocl:271): values wrap modulo 256."""
    film = film + float(AMBIENT)
    if wrap:
        rgb = (torch.trunc(film).to(torch.int64) & 0xFF).to(torch.uint8)
    else:
        rgb = torch.clamp(torch.trunc(film), 0.0, 255.0).to(torch.uint8)
    alpha = torch.full(film.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=film.device)
    return torch.cat([rgb, alpha], dim=-1)


def quantize_film16(film: torch.Tensor) -> torch.Tensor:
    """Pre-ambient (H, W, 3) float film -> (H, W, 4) uint16 (maxval
    65535): the display scale [0, 255] mapped linearly onto [0, 65535],
    saturating, round-half-even.  Returned as int32 (torch's uint16 has
    thin operator coverage), values in [0, 65535]."""
    film = film + float(AMBIENT)
    scale = float(np.float32(65535.0 / 255.0))
    rgb = torch.clamp(torch.round(film * scale), 0.0, 65535.0).to(torch.int32)
    alpha = torch.full(film.shape[:-1] + (1,), 65535, dtype=torch.int32,
                       device=film.device)
    return torch.cat([rgb, alpha], dim=-1)


def reduce_samples(samples: torch.Tensor, sample_grid: int,
                   wrap: bool = False) -> torch.Tensor:
    """(H*sg, W*sg, 3) float32 sample buffer -> (H, W, 4) uint8 image.

    Slot (i, j) of the buffer belongs to pixel (i // sg, j // sg), like
    the reference's gid>>3 mapping (ocl:223-224).  The per-pixel sum runs
    in torch's order, not the JAX package's: a sum that lands within an
    ulp of an integer may truncate one step apart (tests hold <= 1 step).
    """
    sg = int(sample_grid)
    hh, ww, _ = samples.shape
    h, w = hh // sg, ww // sg
    return quantize_film(samples.reshape(h, sg, w, sg, 3).sum(dim=(1, 3)),
                         wrap=wrap)
