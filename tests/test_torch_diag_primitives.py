"""The take-list primitives (``ops/diag_takelist.py``,
``tools/diag_primitives.py`` of the port) == the JAX package's
``tools/diag_primitives.py``.

The JAX tool's ``main(interpret=True)`` runs as it is, with its ``run``
replaced by one that records each arm's (out, count) and ``REPS`` set to
2 (``NB`` stays 128; both are module globals the kernels read when traced).
The port's plain version runs the same arms on the same tile.  Tolerances:
the counts equal (64 flagged blocks of 128 for the take-list, 0 for the
other arms); ``out`` at rtol 1e-5 - XLA:CPU may contract the take-list's
a + 1e-6 * b into an FMA, the port rounds the product first.

The CUDA kernel runs only on a GPU: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold it against this plain version.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_takelist as P
from opencl_montecarlo_path_tracing_tpu_torch.tools import (
    diag_primitives as TP)
from tools import diag_primitives as JP

REPS = 2
ARM_OF = {name.strip(): arm for arm, name in TP.NAMES.items()}


@pytest.fixture(scope="module")
def jax_arms():
    rec = {}

    def record(name, fn, *args, interpret=False):
        out, cnt = jax.jit(functools.partial(fn, interpret=interpret))(*args)
        rec[ARM_OF[name.strip()]] = (np.asarray(out),
                                     int(np.asarray(cnt)[0, 0]))
        rec.setdefault("x", np.asarray(args[0]))

    mp = pytest.MonkeyPatch()
    mp.setattr(JP, "REPS", REPS)
    mp.setattr(JP, "run", record)
    try:
        JP.main(interpret=True)
    finally:
        mp.undo()
    return rec


def test_inputs_equal_jax(jax_arms):
    x, flags = TP.inputs("cpu")
    np.testing.assert_array_equal(x.numpy(), jax_arms["x"])
    np.testing.assert_array_equal(flags.numpy(),
                                  (np.arange(JP.NB) % 2 == 0).astype(np.int32))


@pytest.mark.parametrize("arm", P.ARMS)
def test_arm_matches_jax(jax_arms, arm):
    x, flags = TP.inputs("cpu")
    out, cnt = P.run_plain(arm, x, P.NB, REPS, flags)
    j_out, j_cnt = jax_arms[arm]
    assert int(cnt[0]) == j_cnt == (64 if arm == "takelist" else 0)
    np.testing.assert_allclose(out.numpy(), j_out, rtol=1e-5, atol=0)


@pytest.mark.parametrize("scale", [0.5, 0.25, 1.0])
def test_takelist_count_is_the_flagged_blocks(scale):
    """The count comes from the list build itself, one way: the number of
    blocks with any x > b / nb (64, 32, 128 of 128 here), and the sum runs
    over exactly those blocks."""
    x = TP.inputs("cpu")[0] * (scale / 0.5)
    flagged = P.flagged(x, P.NB)
    out, cnt = P.run("takelist", x, P.NB, 1)
    assert int(cnt[0]) == int(flagged.sum()) == int(scale * 128)
    want = torch.zeros_like(x)
    for b in torch.nonzero(flagged).flatten().tolist():
        want = want + float(np.float32(1e-6) * np.float32(b))
    assert torch.equal(out, want)
    _, cnt0 = P.run("takelist", x, P.NB, 0)
    assert int(cnt0[0]) == -1            # no list built, no count


def test_tool_runs_on_cpu(capsys):
    res = TP.run_arms("cpu", reps=REPS)
    out = capsys.readouterr().out
    assert "take-list   : best" in out and "(cnt=64," in out
    assert res["takelist"][1] == 64 and res["noop"][1] == 0
    with pytest.raises(ValueError, match="unknown arm"):
        P.run("cond", *TP.inputs("cpu")[:1])
