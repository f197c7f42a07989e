"""The loop-overhead arms (``ops/diag_loops.py``, ``tools/diag_loops.py`` of
the port) == the JAX package's ``tools/diag_loops.py``.

The JAX tool's ``main()`` runs as it is, its 13 arms at their own trip
counts, with the module's ``pl`` replaced by a namespace whose
``pallas_call`` runs in interpret mode and ``timed`` by a function that
records each arm's output; the flat chains of 16 and 64 steps an iteration
are also run through the module-level ``make(adds, iters, unroll)`` at 400
iterations, where the port's eager chain is quick.  Tolerances:

* the multiply-add chains at rtol 1e-4: a * 0.999 + 1e-6 sticks at a
  float32 fixed point near 1e-3 that may lie ~500 ulps from 1e-3, and
  XLA:CPU's FMA and the port's separate roundings can stick at different
  points;
* the broadcast and reduce arms at rtol 1e-4 for the same reason (the
  reduce arms stay at 0 from a zero tile);
* the copy and scalar arms exactly;
* the port's plain chains, broadcast and reductions bit for bit against a
  NumPy float32 evaluation of the same recurrence from a random start (no
  contraction on either side), which also tests ``acc0``;
* the reduce probe (``tools/diag_loops.py::reduce_probe``, on which the
  card tests hold the kernel's reduce arms): the plain reductions show
  every group's max in every output, and each grouping error a kernel
  could make (another group, a warp, slot, shuffle or row left out) shows
  on at least one of its shifts.

The CUDA kernel runs only on a GPU: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold it against this plain version.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L
from opencl_montecarlo_path_tracing_tpu_torch.tools import diag_loops as TL
from tools import diag_loops as JL

RTOL = 1e-4
SHORT = 400              # iterations of the 16- and 64-step chains
ARM_OF = {label: arm for arm, label in TL.LABELS.items()}


@pytest.fixture(scope="module")
def jax_arms():
    rec = {}

    def record(fn, x, n_iters, tag):
        rec[ARM_OF[tag]] = np.asarray(jax.jit(fn)(x))

    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(JL, "pl", ns)
    mp.setattr(JL, "timed", record)
    try:
        JL.main()
        x = jax.numpy.zeros((8, 128), jax.numpy.float32)
        for adds in (16, 64):
            rec[f"short{adds}"] = np.asarray(
                jax.jit(JL.make(adds, SHORT, False))(x))
    finally:
        mp.undo()
    return rec


def _zero():
    return torch.zeros((8, 128), dtype=torch.float32)


@pytest.mark.parametrize("arm", L.ARMS)
def test_arm_matches_jax(jax_arms, arm):
    n1, n2 = TL.COUNTS[arm]
    table = torch.zeros(L.TABLE_SHAPE, dtype=torch.float32)
    if arm in ("flat16", "flat64"):
        n1, want = SHORT, jax_arms[f"short{L.STEPS[arm]}"]
    else:
        want = jax_arms[arm]
    out = L.run_plain(arm, _zero(), n1, n2, table=table).numpy()
    if arm in ("copy", "scalar"):
        np.testing.assert_array_equal(out, want)
    else:
        np.testing.assert_allclose(out, want, rtol=RTOL, atol=0)


def _numpy_chain(arm, a, n1, n2):
    f = np.float32
    if arm in L.STEPS:
        for _ in range(n1 * L.STEPS[arm] * (n2 if arm == "nested" else 1)):
            a = a * f(0.999) + f(1e-6)
    elif arm == "bcast":
        for i in range(n1):
            a = a + f(i)
    else:
        axis = {"reduce_full": None, "reduce_lane": 1, "reduce_sub": 0}[arm]
        for _ in range(n1):
            a = a + a.max(axis=axis, keepdims=True) * f(1e-9)
    return a


@pytest.mark.parametrize("arm", [a for a in L.ARMS
                                 if a not in ("copy", "scalar")])
def test_plain_chain_equals_numpy_float32(arm):
    n1, n2 = {"nested": (3, 50), "chunk32": (8, 0),
              "chunk128": (2, 0)}.get(arm, (256 // L.STEPS.get(arm, 1), 0))
    rng = np.random.RandomState(3)
    acc0 = rng.rand(8, 128).astype(np.float32)
    x = rng.rand(8, 128).astype(np.float32)
    want = _numpy_chain(arm, acc0.copy(), n1, n2) + x
    out = L.run_plain(arm, torch.from_numpy(x), n1, n2,
                      acc0=torch.from_numpy(acc0))
    np.testing.assert_array_equal(out.numpy(), want)


PROBE_ITERS = 64
_COL = np.arange(128)
_ROW = np.arange(8)


@pytest.mark.parametrize("shift", TL.PROBE_SHIFTS)
@pytest.mark.parametrize("arm", list(TL.REDUCE_AXIS))
def test_reduce_probe_decodes_the_plain_chain(arm, shift):
    """On ``reduce_probe``'s inputs the plain reduce equals the NumPy
    float32 recurrence bit for bit, and every background output names its
    own group's max."""
    x, acc0 = TL.reduce_probe(shift)
    out = L.run_plain(arm, torch.from_numpy(x), PROBE_ITERS,
                      acc0=torch.from_numpy(acc0)).numpy()
    np.testing.assert_array_equal(
        out, _numpy_chain(arm, acc0.copy(), PROBE_ITERS, 0) + x)
    assert TL.probe_decodes(arm, out, x, acc0, PROBE_ITERS)


def _halves_max(a):
    """Each lane's row max with the shuffle at distance 16 left out: the
    max over the 16 lanes of its half."""
    half = (_COL % 32) // 16
    m = np.stack([a[:, half == h].max(axis=1) for h in (0, 1)], axis=1)
    return m[:, half]


#: a kernel's grouping errors, as the max each element reads instead of
#: its group's: the full reduce's block holds column t in thread t (warp
#: t // 32), the lane reduce's warp holds column k * 32 + l in lane l's
#: slot k, the sub reduce's thread holds a column's 8 rows
GROUPING_FAULTS = {
    **{f"full drops warp {w}": (
        "reduce_full", lambda a, w=w: a[:, _COL // 32 != w].max())
       for w in range(4)},
    "lane reads the next row": (
        "reduce_lane",
        lambda a: np.roll(a.max(axis=1, keepdims=True), 1, axis=0)),
    **{f"lane drops slot {k}": (
        "reduce_lane",
        lambda a, k=k: a[:, _COL // 32 != k].max(axis=1, keepdims=True))
       for k in range(4)},
    "lane skips the shuffle at 16": ("reduce_lane", _halves_max),
    "sub reads the next column": (
        "reduce_sub",
        lambda a: np.roll(a.max(axis=0, keepdims=True), 1, axis=1)),
    **{f"sub drops row {r}": (
        "reduce_sub",
        lambda a, r=r: a[_ROW != r].max(axis=0, keepdims=True))
       for r in range(8)},
}


@pytest.mark.parametrize("fault", list(GROUPING_FAULTS))
def test_reduce_probe_catches_a_wrong_grouping(fault):
    """A reduce that reads another group's max, or its own short of one
    warp, slot, shuffle or row, fails ``probe_decodes`` on at least one of
    the probe's shifts (the card tests hold the kernel to the probe)."""
    arm, group_max = GROUPING_FAULTS[fault]
    caught = []
    for shift in TL.PROBE_SHIFTS:
        x, acc0 = TL.reduce_probe(shift)
        a = acc0.copy()
        for _ in range(PROBE_ITERS):
            a = a + group_max(a) * np.float32(1e-9)
        caught.append(not TL.probe_decodes(arm, a + x, x, acc0,
                                           PROBE_ITERS))
    assert any(caught)


def test_copy_and_scalar_arms_count_exactly():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(8, 128).astype(np.float32))
    table = torch.from_numpy(rng.rand(*L.TABLE_SHAPE).astype(np.float32))
    c = np.float32(0)
    for i in range(40):
        c = c + table.numpy()[0, (i % 16) * 128]
    assert torch.equal(L.run("copy", x, 40, table=table), x + float(c))
    assert torch.equal(L.run("scalar", x, 40), x + 40.0)


def test_tool_runs_on_cpu(capsys):
    counts = {a: (max(1, n1 // 100), n2) for a, (n1, n2) in TL.COUNTS.items()}
    res = TL.run_arms("cpu", counts)
    out = capsys.readouterr().out
    assert len(res) == 13 and "fori + 8KB HBM->SMEM DMA:" in out
    assert all(np.isfinite(ns) for _, _, ns in res.values())
    with pytest.raises(ValueError, match="table"):
        L.run("copy", _zero(), 1)
