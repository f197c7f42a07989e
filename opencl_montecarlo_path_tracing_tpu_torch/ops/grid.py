"""Uniform-grid build for the VLP grid, on PyTorch tensors.

Port of the part of ``opencl_montecarlo_path_tracing_tpu/ops/grid.py``
that the VLP family runs: the cell record (``UniformGrid``), the cell
coordinates of a position and the per-cell scan build
(``build_grid_cellscan``), whose ``items``/``counts`` equal the JAX
package's exactly.  The reference's ``initVLPsGrid`` scatters VLP ids into
``Cell{nels, elem_index[62]}`` with ``atomic_inc`` and drops overflow
(metropolispathtracer.ocl:620-646); the build here keeps, for every cell,
the first ``cap`` items in ascending index whose AABB overlaps it - the
deterministic analogue.  The triangle grid, the pair and host builds and
the DDA walk belong to the large-mesh slice (ROADMAP A8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_NELS_PER_CELL = 62  # reference cap (.ocl:1)


class UniformGrid(NamedTuple):
    items: torch.Tensor      # (ncells, cap) int32, -1 padded
    counts: torch.Tensor     # (ncells,) int32 (clamped to cap)
    res: tuple               # (rx, ry, rz) Python ints
    vmin: torch.Tensor       # (3,) float32, on the grid's device
    cell_size: torch.Tensor  # (3,) float32


def _cell_coords(pos, vmin, cell_size, res):
    """Float positions -> clamped integer cell coords (ocl:320-321).  The
    clamp happens in float before the cast, so out-of-range values (up to
    +-inf) saturate as the JAX package's conversion does."""
    hi = torch.as_tensor(res, dtype=torch.float32, device=pos.device) - 1.0
    c = torch.floor((pos - vmin) / cell_size)
    c = torch.minimum(torch.clamp_min(c, 0.0), hi)
    return c.to(torch.int32)


def build_grid_cellscan(aabb_min, aabb_max, vmin, cell_size, res,
                        cap: int = MAX_NELS_PER_CELL,
                        cell_chunk: int = 1024) -> UniformGrid:
    """Device build scanning items per cell (handles unbounded spans):
    for each cell the first ``cap`` items (ascending index) whose AABB
    overlaps it, and the overlap count clamped to ``cap``.  Cells are
    processed ``cell_chunk`` at a time to bound the (cells, items) mask."""
    dev = aabb_min.device
    n = aabb_min.shape[0]
    rx, ry, rz = (int(r) for r in res)
    ncells = rx * ry * rz
    vmin = torch.as_tensor(vmin, dtype=torch.float32, device=dev)
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    lo = _cell_coords(aabb_min, vmin, cell_size, (rx, ry, rz))
    hi = _cell_coords(aabb_max, vmin, cell_size, (rx, ry, rz))

    # cell id = cz * rx * ry + cy * rx + cx (x fastest)
    cid = torch.arange(ncells, dtype=torch.int64, device=dev)
    coords = torch.stack([cid % rx, (cid // rx) % ry, cid // (rx * ry)],
                         dim=-1).to(torch.int32)
    item_ids = torch.arange(n, dtype=torch.int32, device=dev)
    items, counts = [], []
    for c0 in range(0, ncells, cell_chunk):
        cc = coords[c0:c0 + cell_chunk]
        m = ((cc[:, None, :] >= lo[None, :, :]).all(dim=-1)
             & (cc[:, None, :] <= hi[None, :, :]).all(dim=-1))   # (C, N)
        rank = torch.cumsum(m.to(torch.int32), dim=1, dtype=torch.int32) - 1
        ok = m & (rank < cap)
        # cap+1 columns: non-members land in the scratch column, dropped
        it = torch.full((cc.shape[0], cap + 1), -1, dtype=torch.int32,
                        device=dev)
        if n:
            src = torch.where(ok, item_ids[None, :], -1)
            it.scatter_(1, torch.where(ok, rank, cap).to(torch.int64), src)
        items.append(it[:, :cap])
        counts.append(torch.clamp_max(m.sum(dim=1), cap).to(torch.int32))
    return UniformGrid(items=torch.cat(items), counts=torch.cat(counts),
                       res=(rx, ry, rz), vmin=vmin, cell_size=cell_size)
