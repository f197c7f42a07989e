"""The port's frame-wide CRN tool (``tools/validate_crn_frame.py``, A14) on
the CPU: the plain versions against the NumPy oracles on the same threefry
streams, at a size that keeps the oracles short.  Its run on the card at
64x64x2 is ``tests/test_torch_gpu.py::test_crn_frame_tool_on_gpu``.

A 16x16 frame is the camera's top-left corner, all sky, so these cases
hold the tool's control flow and exit codes; the films behind the sky are
held by ``tests/test_torch_oracles.py`` and the card run.
"""

import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch import api
from opencl_montecarlo_path_tracing_tpu_torch.tools import (
    validate_crn_frame as V)


def test_every_family_within_contract_exits_0(capsys):
    assert V.main(["--size", "16", "--spp", "1", "--device", "cpu",
                   "--families", "super,simple,bidirectional"]) == 0
    out = capsys.readouterr().out
    assert out.count("| super") == 2 and "| simple" in out
    assert "| bidirectional nvlp=128" in out and "contract OK" in out


@pytest.mark.parametrize("family", ["super (intended", "simple"])
def test_a_perturbed_film_exits_1(family, monkeypatch, capsys):
    real = api.render

    def perturbed(*a, **k):
        film = real(*a, **k)
        return film + torch.where(torch.arange(film.numel()).reshape(
            film.shape) % 7 == 0, 0.05, 0.0)

    monkeypatch.setattr(api, "render", perturbed)
    assert V.main(["--size", "16", "--spp", "1", "--device", "cpu",
                   "--families", family]) == 1
    out = capsys.readouterr().out
    assert "VIOLATION" in out and "contract VIOLATED" in out


def test_no_family_matched_exits_2():
    assert V.main(["--size", "16", "--device", "cpu", "--families",
                   "nosuch"]) == 2
