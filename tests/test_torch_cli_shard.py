"""The port's CLI ``--shard N|RxS`` (utils/cli.py).

The errors run in this process (one rank, no process group); the
renders under ``torchrun --nproc-per-node 2 ... --device cpu`` (gloo).
Scenes are written with ``scene/builtin.py::write_scene_files``.  Byte
equalities, each with its reason:

* the 2-rank PAM against the JAX CLI's ``--shard 2`` PAM (8 virtual CPU
  devices, in this process): the same samples, summed in another order,
  quantised to the same bytes at 16x16;
* a 2-rank render resumed from a checkpoint of its first window, against
  the unsharded checkpointed run: at most 1 uint8 step (the last window
  is summed over two ranks), and every rank started at the saved window.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from opencl_montecarlo_path_tracing_tpu.utils import cli as jcli
from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu_torch.models.super import render_super
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    procedural_super_scene, write_scene_files)
from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import load_scene
from opencl_montecarlo_path_tracing_tpu_torch.utils import cli
from opencl_montecarlo_path_tracing_tpu_torch.utils.checkpoint import (
    FilmCheckpoint)
from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import load_pam
from tests.test_torch_utils import _one_thread_warm_sqrt  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "opencl_montecarlo_path_tracing_tpu_torch"


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    write_scene_files(procedural_super_scene(), str(d))
    return str(d)


def _torchrun(args, cwd, nproc=2):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PT_PLATFORM", "PT_DEVICE", "OCL_PLATFORM",
                        "OCL_DEVICE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", PKG, *args, "--device",
         "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=180)


ERRORS = [
    (["super", "--shard", "2x"], "bad --shard spec '2x'"),
    (["super", "--shard", "0"], "bad --shard spec '0'"),
    (["super", "--shard", "2"],
     "--shard 2 needs 2 ranks; have 1 (launch with torchrun "
     "--nproc-per-node 2)"),
    (["bidirectional", "--shard", "2x2"], "--shard 2x2 needs 4 ranks"),
    (["simple", "--shard", "2x1"],
     "2-D --shard is not supported for simple"),
    (["trianglegrid", "--shard", "1x2"],
     "2-D --shard is not supported for trianglegrid"),
    (["nodof", "--shard", "1x1"], "2-D --shard is not supported for nodof"),
    (["super", "--shard", "1x2", "--checkpoint", "ck.npz"],
     "not 2-D meshes"),
    (["nodof", "--shard", "1", "--checkpoint", "ck.npz"], "not nodof"),
    (["metropolis_vlpgrid", "--shard", "1", "--profile-stages"],
     "incompatible with --profile-stages"),
    # the windows of a checkpointed render must divide by the ranks,
    # checked before the first one (and before the rank count)
    (["super", "--spp", "96", "--spp-per-step", "32", "--shard", "3",
      "--checkpoint", "ck.npz"],
     "--shard 3: every --checkpoint window must divide by 3 "
     "(--spp-per-step 32, last window 0)"),
    (["super", "--spp", "97", "--spp-per-step", "32", "--shard", "2",
      "--checkpoint", "ck.npz"],
     "(--spp-per-step 32, last window 1)"),
    (["super", "--spp", "2", "--shard", "1x1"], None),
]


@pytest.mark.parametrize("args,msg", ERRORS,
                         ids=[" ".join(a[0:3]) + f"-{i}"
                              for i, (a, _) in enumerate(ERRORS)])
def test_shard_errors_exit_1_before_rendering(args, msg, scene_dir,
                                              tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(args[:1] + ["8", "8"] + args[1:] +
                  ["--scene-dir", scene_dir, "--device", "cpu"])
    err = capsys.readouterr().err
    if msg is None:           # a 1x1 mesh renders in a plain process
        assert rc == 0 and os.path.exists("result.ppm")
        return
    assert rc == 1 and msg in err, err
    assert not os.path.exists("ck.npz")
    assert not os.path.exists("result.ppm")


def test_two_ranks_match_the_jax_cli(scene_dir, tmp_path, monkeypatch):
    args = ["super", "16", "16", "--spp", "4", "--seed", "1",
            "--scene-dir", scene_dir, "--shard", "2"]
    r = _torchrun(args + ["--out", "t.ppm"], str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("rendering (sharded 2) :") == 1   # rank 0 reports
    monkeypatch.chdir(tmp_path)
    assert jcli.main(args + ["--out", "j.ppm"]) == 0
    t, j = load_pam("t.ppm"), load_pam("j.ppm")
    assert (t.width, t.height) == (16, 16)
    assert np.array_equal(t.data, j.data)


def test_two_ranks_resume_a_checkpoint(scene_dir, tmp_path, monkeypatch):
    """The unsharded CLI renders 4 spp in 2 checkpointed windows; its
    file, cut back to the first window, is resumed by 2 ranks: rank 0
    reads it and the ranks render the last window only."""
    monkeypatch.chdir(tmp_path)
    args = ["super", "16", "16", "--spp", "4", "--seed", "1",
            "--scene-dir", scene_dir, "--checkpoint", "ck.npz",
            "--spp-per-step", "2"]
    assert cli.main(args + ["--out", "one.ppm", "--device", "cpu"]) == 0
    ck = FilmCheckpoint.load("ck.npz")
    assert ck.spp_done == 4
    ck.film = render_super(make_key(1), load_scene(scene_dir), 16, 16, 2,
                           spp_total=4, device="cpu").numpy()
    ck.spp_done = 2
    ck.save("ck.npz")
    r = _torchrun(args + ["--shard", "2", "--out", "two.ppm"],
                  str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "(checkpointed, 4 spp)" in r.stdout
    assert FilmCheckpoint.load("ck.npz").spp_done == 4
    a, b = load_pam("one.ppm").data, load_pam("two.ppm").data
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
