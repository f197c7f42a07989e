"""The port's CLI options beyond the render itself: --checkpoint /
--spp-per-step, --profile-stages (3 and 7 stages), PT_KERNEL_DEBUG, and
the device selection by PT_PLATFORM / PT_DEVICE / OCL_DEVICE.

Every run renders at 8x8 to 16x16 on the CPU, on scenes written by
``scene/builtin.py::write_scene_files``.  The 7-stage report is held
against the JAX CLI's, stage names and order; the others against that
CLI's stage lists (``utils/cli.py::_staged_vlp_render`` of the JAX
package).  Tolerances: a checkpointed image against the one-shot image at
1 uint8 step (the windows' films are summed on the host in another order);
a staged image against the unstaged one and a resumed run against a
repeated one byte for byte (the same functions in the same order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu_torch.models.super import render_super
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    procedural_super_scene, write_scene_files)
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import load_scene
from opencl_montecarlo_path_tracing_tpu_torch.utils import cli
from opencl_montecarlo_path_tracing_tpu_torch.utils.checkpoint import (
    FilmCheckpoint, render_resumable)
from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import (
    film_to_rgba8, load_pam)
from tests.test_torch_utils import _one_thread_warm_sqrt  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "opencl_montecarlo_path_tracing_tpu_torch"

SEVEN_STAGES = ["light paths random sampling",
                "light paths metropolis sampling",
                "VLPs min/max reduction (compute bounding box)",
                "Read VLPs bounding box", "init VLPs grid", "rendering",
                "read render data", "write render data"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    write_scene_files(procedural_super_scene(), str(d))
    return str(d)


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PT_PLATFORM", "PT_DEVICE", "OCL_PLATFORM",
                        "OCL_DEVICE", "PT_KERNEL_DEBUG")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(kw)
    return env


def _run(module, args, cwd, **env):
    return subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                          env=_env(**env), capture_output=True, text=True,
                          timeout=600)


def stages(stdout):
    """The stage names of a report, in order."""
    return [ln.split(" : ")[0] for ln in stdout.splitlines()
            if " : " in ln and ln.endswith("GB/s")]


# (variant, positionals): small light passes for the VLP variants
CHECKPOINTED = [("super", ["12", "12"]), ("superlmem", ["12", "12"]),
                ("simple", ["12", "12", "16"]),
                ("trianglegrid", ["12", "12", "3.0"]),
                ("bidirectional", ["12", "12", "32"]),
                ("metropolis", ["12", "12", "8", "2"]),
                ("metropolis_vlpgrid", ["12", "12", "8", "2", "3.0"])]


@pytest.mark.parametrize("variant,pos", CHECKPOINTED,
                         ids=[c[0] for c in CHECKPOINTED])
def test_checkpoint_equals_one_shot(variant, pos, scene_dir, tmp_path,
                                    monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    base = [variant, *pos, "--spp", "8", "--seed", "3", "--scene-dir",
            scene_dir, "--device", "cpu"]
    assert cli.main(base + ["--out", "one.ppm"]) == 0
    capsys.readouterr()
    ck = ["--checkpoint", "ck.npz", "--spp-per-step", "3"]
    assert cli.main(base + ck + ["--out", "a.ppm"]) == 0
    out = capsys.readouterr().out
    assert "(checkpointed, 8 spp) : 144 pixels in " in out
    assert FilmCheckpoint.load("ck.npz").spp_done == 8
    # a completed checkpoint: the second run renders nothing new
    assert cli.main(base + ck + ["--out", "b.ppm"]) == 0
    one, a, b = (load_pam(f).data for f in ("one.ppm", "a.ppm", "b.ppm"))
    assert np.array_equal(a, b)
    assert np.abs(a.astype(int) - one.astype(int)).max() <= 1


def test_cli_resumes_a_crashed_render(scene_dir, tmp_path, monkeypatch,
                                      capsys):
    """A CLI render cut after its first window, resumed by the CLI in
    another process, equals the uncut checkpointed render."""
    from opencl_montecarlo_path_tracing_tpu_torch.models import super as MS
    calls = []

    def crashing(*args, **kw):
        if calls:
            raise RuntimeError("cut")
        calls.append(kw["spp_offset"])
        return render_super(*args, **kw)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(MS, "render_super", crashing)
    args = ["super", "16", "16", "--spp", "8", "--seed", "4",
            "--scene-dir", scene_dir, "--device", "cpu",
            "--spp-per-step", "3", "--checkpoint", "ck.npz"]
    with pytest.raises(RuntimeError, match="cut"):
        cli.main(args + ["--out", "cut.ppm"])
    capsys.readouterr()
    assert calls == [0]
    assert FilmCheckpoint.load(str(tmp_path / "ck.npz")).spp_done == 3
    r = _run(PKG, args + ["--out", "a.ppm"], str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "rendering (checkpointed, 8 spp)" in r.stdout
    full = render_resumable(lambda *a, **kw: render_super(
        *a, device="cpu", **kw), make_key(4), load_scene(scene_dir), 16, 16,
        8, spp_per_step=3, seed=4)
    assert np.array_equal(load_pam(str(tmp_path / "a.ppm")).data,
                          film_to_rgba8(full.film))


def test_checkpoint_of_another_variant_starts_over(scene_dir, tmp_path,
                                                   monkeypatch, capsys):
    """A finished ``super`` checkpoint handed to ``bidirectional`` at the
    same size, spp and seed: the second render starts over instead of
    taking up the first film."""
    monkeypatch.chdir(tmp_path)
    common = ["12", "12", "--spp", "4", "--seed", "6", "--scene-dir",
              scene_dir, "--device", "cpu"]
    ck = ["--checkpoint", "ck.npz", "--spp-per-step", "2"]
    assert cli.main(["super", *common, *ck, "--out", "s.ppm"]) == 0
    first = FilmCheckpoint.load("ck.npz")
    assert first.meta["variant"] == "super"
    # a film no render gives: it shows in the image if it is taken up
    first.film = np.full_like(first.film, 1e3)
    first.save("ck.npz")
    assert cli.main(["bidirectional", *common, *ck, "--out", "b.ppm"]) == 0
    assert "(checkpointed, 4 spp)" in capsys.readouterr().out
    assert FilmCheckpoint.load("ck.npz").meta["variant"] == "bidirectional"
    assert cli.main(["bidirectional", *common, "--out", "one.ppm"]) == 0
    b, one = (load_pam(f).data for f in ("b.ppm", "one.ppm"))
    assert np.abs(b.astype(int) - one.astype(int)).max() <= 1


# (variant, positionals, extra flags, the stage names the JAX CLI reports)
STAGED = [
    ("bidirectional", ["12", "12", "32"], [],
     ["light tracer", "rendering", "read render data", "write render data"]),
    ("metropolis", ["12", "12", "8", "2"], [],
     ["light tracer + metropolis", "rendering", "read render data",
      "write render data"]),
    ("metropolis_vlpgrid", ["12", "12", "8", "2", "3.0"], [],
     ["light tracer + metropolis", "min/max reduction + VLPs grid init",
      "rendering", "read render data", "write render data"]),
    ("metropolis_vlpgrid", ["12", "12", "8", "2", "3.0"],
     ["--dynamic-grid-res"], SEVEN_STAGES),
]


@pytest.mark.parametrize("variant,pos,flags,want", STAGED,
                         ids=["bpt", "mlt", "vlpgrid", "vlpgrid_dynamic"])
def test_profile_stages(variant, pos, flags, want, scene_dir, tmp_path,
                        monkeypatch, capsys):
    """The stage report in the JAX CLI's names and order, and the staged
    image equal to the unstaged render's."""
    monkeypatch.chdir(tmp_path)
    base = [variant, *pos, "--spp", "2", "--seed", "5", "--scene-dir",
            scene_dir, "--device", "cpu", *flags]
    assert cli.main(base + ["--profile-stages", "--out", "s.ppm"]) == 0
    out = capsys.readouterr().out
    assert stages(out) == want
    assert ("VLPs grid size: " in out) == ("--dynamic-grid-res" in flags)
    assert cli.main(base + ["--out", "u.ppm"]) == 0
    assert np.array_equal(load_pam("s.ppm").data, load_pam("u.ppm").data)


def test_seven_stages_match_the_jax_cli(scene_dir, tmp_path):
    args = ["metropolis_vlpgrid", "8", "8", "8", "2", "3.0", "--spp", "2",
            "--seed", "1", "--scene-dir", scene_dir, "--profile-stages",
            "--dynamic-grid-res"]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    rt = _run(PKG, args + ["--device", "cpu"], str(tmp_path / "t"))
    rj = _run("opencl_montecarlo_path_tracing_tpu", args,
              str(tmp_path / "j"), PT_PLATFORM="cpu",
              JAX_PLATFORM_NAME="cpu")
    assert rt.returncode == 0, rt.stderr
    assert rj.returncode == 0, rj.stderr
    assert stages(rt.stdout) == stages(rj.stdout) == SEVEN_STAGES
    grid = [ln for ln in rt.stdout.splitlines() if ln.startswith("VLPs grid")]
    assert grid == [ln for ln in rj.stdout.splitlines()
                    if ln.startswith("VLPs grid")]


@pytest.mark.parametrize("flag", ["1", None], ids=["set", "unset"])
def test_kernel_debug_lines(flag, scene_dir, tmp_path):
    args = ["trianglegrid", "8", "8", "3.0", "--spp", "1", "--seed", "1",
            "--scene-dir", scene_dir, "--device", "cpu"]
    env = {"PT_KERNEL_DEBUG": flag} if flag else {}
    r = _run(PKG, args, str(tmp_path), **env)
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith("[grid DDA] rays=")]
    assert bool(lines) == bool(flag)


def test_pt_platform_cpu(scene_dir, tmp_path):
    r = _run(PKG, ["super", "8", "8", "--spp", "1", "--seed", "1",
                   "--scene-dir", scene_dir], str(tmp_path),
             PT_PLATFORM="cpu")
    assert r.returncode == 0, r.stderr
    assert "Using device: cpu" in r.stdout
    assert load_pam(str(tmp_path / "result.ppm")).width == 8


def test_missing_device_exits_1(scene_dir, tmp_path):
    """No such CUDA device: exit 1 and name the count; never the CPU."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    r = _run(PKG, ["super", "8", "8", "--spp", "1", "--scene-dir",
                   scene_dir], str(tmp_path), PT_DEVICE=str(have + 5))
    assert r.returncode == 1
    assert f"no device {have + 5}; have {have}" in r.stderr
    assert not (tmp_path / "result.ppm").exists()


# (environment, the device the CLI takes, or None for a missing one) -
# each without --device
SELECTION = [({"OCL_PLATFORM": "cpu"}, "cpu"),
             ({"OCL_PLATFORM": "0", "PT_PLATFORM": "cpu"}, "cpu"),
             ({"PT_PLATFORM": "cpu", "PT_DEVICE": "1"}, None),
             ({"OCL_DEVICE": "7"}, None),
             ({"PT_PLATFORM": "tpu"}, None)]


@pytest.mark.parametrize("env,want", SELECTION,
                         ids=["ocl_platform", "numeric_ocl_platform",
                              "cpu_index", "ocl_device", "unknown"])
def test_device_selection(env, want, monkeypatch, capsys):
    for k in ("PT_PLATFORM", "PT_DEVICE", "OCL_PLATFORM", "OCL_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is None and "OCL_DEVICE" in env and torch.cuda.is_available() \
            and torch.cuda.device_count() > int(env["OCL_DEVICE"]):
        pytest.skip("the machine has that many GPUs")
    got = cli._select_device(None)
    if want is None:
        assert got is None
        err = capsys.readouterr().err
        assert ("unknown device 'tpu'" if env.get("PT_PLATFORM") == "tpu"
                else "no device") in err
    else:
        assert got == torch.device(want)
        assert f"Using device: {want}" in capsys.readouterr().out
    # an explicit --device wins over the environment
    assert cli._select_device("cpu") == torch.device("cpu")
