"""On the card: the command's run of each one-chip cell, end to end.
Marked ``gpu``; without a CUDA device the test skips (decided in the
fixture).  Run on the card with
``python -m pytest --noconftest -m gpu benchmark/tests/test_bench_card.py``
(``--noconftest`` keeps ``tests/conftest.py``, which imports JAX, out)."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec

ONE_CHIP = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels)")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ONE_CHIP)
@pytest.mark.parametrize("traced", [0, 1])
def test_run_prints_a_correct_result(card, cell, traced):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(traced)],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"
    want = spec.cell(cell).per_layer if traced else spec.cell(cell).end_to_end
    if not traced:
        assert set(out["metrics"]) == {m["name"] for m in want}
    else:
        assert out["device"]["busy_s"] > 0
