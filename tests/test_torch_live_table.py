"""Kernel B6's live-first table (ops/vlp.py::live_table) on the CPU.

The CUDA kernel reads the VLP table live rows first, with the live count
on the device, and sums only the first n_live rows.  These tests hold the
table's layout and that the plain gather over its live rows equals, bit
for bit, the plain gather over the full table on every finite lane (a dead
row, I <= 0, adds exactly +0.0 to a finite sum), that the tier-1 gather
takes the table in place of the raw one, and that it is B4's dense table.
``tests/test_torch_gpu.py`` holds the kernel itself against the plain
version on the card.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G
from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as TV
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import demo_scene


def table_and_points(seed: int, live_share: float, V: int = 300,
                     R: int = 500):
    g = np.random.default_rng(seed)
    vlps = g.normal(5, 3, (V, 4)).astype(np.float32)
    vlps[:, 3] = np.where(g.random(V) < live_share, np.abs(vlps[:, 3]),
                          -np.abs(vlps[:, 3]) * (g.random(V) < 0.5))
    x = g.normal(5, 3, (R, 3)).astype(np.float32)
    n = g.normal(0, 1, (R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    x[::37] = np.nan                          # non-finite lanes
    return (torch.from_numpy(a) for a in (vlps, x, n))


def live_rows(table: G.LiveTable) -> torch.Tensor:
    """The (n_live, 4) table the kernel sums, read back from its layout."""
    k = int(table.n_live)
    return table.tab[:k][:, [0, 1, 2, 3]]


@pytest.mark.parametrize("live_share", [0.0, 0.05, 0.5, 1.0])
def test_live_table_layout(live_share):
    vlps, _, _ = table_and_points(1, live_share)
    t = G.live_table(vlps)
    live = vlps[:, 3] > 0
    k = int(live.sum())
    assert t.vlps is vlps
    assert t.tab.shape == (vlps.shape[0], 8) and t.tab.dtype == torch.float32
    assert t.tab.is_contiguous()
    assert t.n_live.dtype == torch.int32 and t.n_live.shape == (1,)
    assert int(t.n_live) == k
    # live rows first, each group in table order (a stable compaction)
    order = torch.cat([torch.nonzero(live).flatten(),
                       torch.nonzero(~live).flatten()])
    v = vlps[order]
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    assert torch.equal(t.tab[:, 0:3], v[:, 0:3])
    assert torch.equal(t.tab[:, 3], torch.clamp_min(v[:, 3], 0.0))
    assert torch.equal(t.tab[:, 4], p0 * p0 + p1 * p1 + p2 * p2)
    assert not t.tab[:, 5:].any()
    assert (t.tab[:k, 3] > 0).all() and not t.tab[k:, 3].any()


@pytest.mark.parametrize("seed,live_share", [(2, 0.01), (3, 0.3), (4, 0.9)])
def test_plain_gather_over_live_rows_is_bit_equal(seed, live_share):
    vlps, x, n = table_and_points(seed, live_share)
    t = G.live_table(vlps)
    full = G.gather_vlps_mxu_plain(x, n, vlps)
    live = G.gather_vlps_mxu_plain(x, n, live_rows(t))
    finite = torch.isfinite(x).all(dim=-1)
    assert (~finite).any() and finite.sum() > 400
    assert torch.equal(full[finite], live[finite])
    assert full[finite].abs().max() > 0       # not vacuous


def test_demo_table_is_mostly_dead():
    """The tier-1 render's table on the demo scene: ~1% live rows, so the
    kernel sums about a hundredth of the pairs it summed over the full
    table; the gather over its live rows is the full table's."""
    scn = prep_scene(demo_scene(prefer_reference=False)[0])
    vlps = TV.emit_vlps((0, 0), scn, 512, device="cpu")
    t = G.live_table(vlps)
    assert 0 < int(t.n_live) < 0.05 * vlps.shape[0]
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.uniform([0, -10, 0], [20, 10, 12],
                                   (300, 3)).astype(np.float32))
    n = torch.zeros_like(x)
    n[:, 2] = 1.0
    full = G.gather_vlps_mxu_plain(x, n, vlps)
    assert torch.equal(full, G.gather_vlps_mxu_plain(x, n, live_rows(t)))


def test_wrapper_on_cpu_takes_the_plain_version_of_a_live_table():
    vlps, x, n = table_and_points(6, 0.2)
    got = G.gather_vlps_mxu(x, n, G.live_table(vlps))
    want = G.gather_vlps_mxu_plain(x, n, vlps)
    assert torch.equal(torch.nan_to_num(got, nan=-1.0),
                       torch.nan_to_num(want, nan=-1.0))


@pytest.mark.parametrize("impl", ["scan", None, "mxu"])
def test_tier1_gather_takes_a_live_table(impl):
    """ops/vlp.py::gather_vlps over the live-first table (as a render
    passes it) equals its gather over the raw table, bit for bit, on every
    route the CPU takes."""
    vlps, x, n = table_and_points(7, 0.3)
    got = TV.gather_vlps(x, n, TV.live_table(vlps), impl=impl)
    want = TV.gather_vlps(x, n, vlps, impl=impl)
    assert torch.equal(torch.nan_to_num(got, nan=-1.0),
                       torch.nan_to_num(want, nan=-1.0))


@pytest.mark.parametrize("live_share", [0.0, 0.3])
def test_b4_dense_table_is_the_live_table(live_share):
    """B4's dense table (ops/mega_vlp.py::vlp_table) and B6's are one
    layout over one partition (ops/vlp.py::live_first)."""
    vlps, _, _ = table_and_points(8, live_share)
    t = TV.live_table(vlps)
    tab, n_live, gridp = M.vlp_table(vlps)
    assert gridp is None
    assert torch.equal(tab, t.tab) and torch.equal(n_live, t.n_live)
