"""The order in which the grid diagnostic's kernels take the tiles
(``ops/diag_dda.py::ranked``, ``Lists.order``): a permutation of the tiles
by descending listed rows, ties by index, and checked by the wrappers.

The cases: the cell and Morton lists and light 0's shadow lists of the
578-triangle shadowed sheet of ``tests/test_torch_diag_dda.py`` at
128x128 (8 tiles), and a synthetic set of lists with equal row counts and
empty lists.  The order moves only the kernels' time: the plain versions
do not read it, and ``tests/test_torch_gpu.py`` holds the kernels, with
and without it, against them on a GPU.
"""

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.tools import diag_host as H
from tests.test_torch_diag_dda import shadowed_sheet

SIZE = 128


@pytest.fixture(scope="module")
def sheet():
    """(name -> (Lists, Table)) of the sheet at 128x128, and the shadow
    rays of light 0 over the cells."""
    scn = prep_scene(shadowed_sheet())
    o, d = H.primary_rays(SIZE)
    cells = K.table_on(H.cell_boxes(scn)[2], "cpu")
    out = {}
    for name, boxes in (("cell", H.cell_boxes(scn)[2]),
                        ("morton", H.morton_boxes(scn))):
        out[name] = (K.lists_on(H.tile_lists(o, d, boxes, SIZE, SIZE),
                                "cpu"), K.table_on(boxes, "cpu"))
    t, m = K.closest_plain(*out["cell"], SIZE, SIZE)
    x = H.hit_points(t.numpy(), m.numpy(), o, d)
    sd, dist = H.shadow_rays(x, np.asarray(scn.lights, np.float64)[0])
    out["shadow"] = (K.lists_on(H.tile_lists(
        x, sd, H.cell_boxes(scn)[2], SIZE, SIZE, tmax_cap=dist,
        sort_near=False), "cpu"), cells)
    rays = [torch.from_numpy(a) for a in H.shadow_inputs(x, sd, dist, SIZE,
                                                          SIZE)]
    # 8 tiles over 4 boxes of 5, 0, 5 and 3 rows: tiles 1, 3 and 6 list
    # 10 rows, tile 7 5 and tile 4 3; tiles 0 and 5 list nothing, tile 2
    # the box of no rows
    start = torch.tensor([0, 5, 5, 10], dtype=torch.int32)
    count = torch.tensor([5, 0, 5, 3], dtype=torch.int32)
    llen = torch.tensor([0, 2, 1, 2, 1, 0, 2, 1], dtype=torch.int32)
    ids = torch.tensor([[0, 2]] * 8, dtype=torch.int32)
    ids[2, 0], ids[4, 0], ids[7, 0] = 1, 3, 2
    out["ties"] = (K.Lists(llen, ids), K.Table(cells.rows[:13].contiguous(),
                                               start, count))
    return out, rays


@pytest.mark.parametrize("name", ["cell", "morton", "shadow", "ties"])
def test_ranked_orders_tiles_by_listed_rows(sheet, name):
    lists, table = sheet[0][name]
    r = K.ranked(lists, table)
    assert r.llen is lists.llen and r.ids is lists.ids
    order = r.order
    assert order.dtype == torch.int32 and order.is_contiguous()
    assert sorted(order.tolist()) == list(range(lists.llen.shape[0]))
    rows = K.tile_rows(lists, table)[order.long()].tolist()
    pairs = list(zip(rows, order.tolist()))
    # descending rows, ties by ascending tile index
    assert pairs == sorted(pairs, key=lambda p: (-p[0], p[1]))
    if name == "ties":
        assert order.tolist() == [1, 3, 6, 7, 4, 0, 2, 5]


@pytest.mark.parametrize("bad", ["length", "dtype", "device layout"])
def test_wrappers_check_the_order(sheet, bad):
    (lists, table), rays = sheet[0]["shadow"], sheet[1]
    order = K.ranked(lists, table).order
    order = {"length": order[:-1], "dtype": order.long(),
             "device layout": torch.stack([order, order], 1)[:, 0]}[bad]
    wrong = lists._replace(order=order)
    with pytest.raises(ValueError, match="order"):
        K.closest(wrong, table, SIZE, SIZE)
    with pytest.raises(ValueError, match="order"):
        K.occluded(wrong, table, *rays)
    # the plain versions take a ranked set of lists as they take any
    occ = K.occluded(K.ranked(lists, table), table, *rays)
    assert torch.equal(occ, K.occluded_plain(lists, table, *rays))
