"""The port's `super` slice end to end, against the JAX package, and the
API and CLI surface of every variant.

``api.render("super" / "superlmem")``, film quantisation, PAM output and
the CLI (``super``, and the simple family's ``simple``, ``nodof`` and
``simplecpu``) go through both packages with the same scene, seed and
quirks.  Tolerances, each with its reason:

* films: the common-random-number contract of
  ``tools/validate_crn_frame.py`` (display-scale p99.5 < 1e-5, razor-edge
  ties (> 1e-4) on < 0.6% of pixels) - both packages consume the same
  threefry streams, so only float rounding and razor-edge ties differ;
* RGBA8 images: equal on >= 99.5% of pixels (a rounding difference can
  cross an integer boundary of the truncation); ``simplecpu``'s exactly
  (the same NumPy tracer on both sides);
* the regression fixture: rtol = atol = 2e-3, as in
  ``tests/test_regression_films.py``;
* PAM bytes and quantisation of one film: exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import opencl_montecarlo_path_tracing_tpu as jpt
from opencl_montecarlo_path_tracing_tpu.core import quirks as JQ
from opencl_montecarlo_path_tracing_tpu.ops import reduce as JR
from opencl_montecarlo_path_tracing_tpu.utils import pam as JP
from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
    demo_scene as j_demo_scene)
import opencl_montecarlo_path_tracing_tpu_torch as tpt
from opencl_montecarlo_path_tracing_tpu_torch.convert import key_from_jax
from opencl_montecarlo_path_tracing_tpu_torch.core import quirks as TQ
from opencl_montecarlo_path_tracing_tpu_torch.ops import reduce as TR
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
    demo_scene, procedural_super_scene, write_scene_files)
from opencl_montecarlo_path_tracing_tpu_torch.utils import cli
from opencl_montecarlo_path_tracing_tpu_torch.utils import pam as TP
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "films.npz")
PIXEL_AGREE = 0.995


def pixel_agreement(a, b):
    return float((np.asarray(a) == np.asarray(b)).all(axis=-1).mean())


# (variant, quirks name, w, h, spp): 24x24 is the issue's slice size (a
# sky corner of the fixed camera); 40x320 reaches the floor and objects
CASES = [("super", "DEFAULT", 24, 24, 4),
         ("superlmem", "REFERENCE_LMEM", 24, 24, 4),
         ("super", "REFERENCE", 40, 320, 2),
         ("superlmem", "REFERENCE_LMEM", 40, 320, 2)]


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_render_matches_jax(case):
    variant, qname, w, h, spp = case
    jq, tq = getattr(JQ, qname), getattr(TQ, qname)
    scene = demo_scene()[0]
    want = np.asarray(jpt.render(variant, j_demo_scene()[0], w, h, spp=spp,
                                 seed=1, quirks=jq))
    got = tpt.render(variant, scene, w, h, spp=spp, seed=1, quirks=tq,
                     device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (h, w, 3)
    ok, stats = crn_ok(got, want, spp)
    assert ok, stats
    img_t = tpt.render(variant, scene, w, h, spp=spp, seed=1, quirks=tq,
                       as_rgba8=True, device="cpu")
    img_j = jpt.render(variant, j_demo_scene()[0], w, h, spp=spp, seed=1,
                       quirks=jq, as_rgba8=True)
    assert img_t.dtype == np.uint8 and img_t.shape == (h, w, 4)
    assert pixel_agreement(img_t, img_j) >= PIXEL_AGREE


def test_regression_fixture():
    """The port's 512^2 x 1 spp super film summary == the JAX package's
    stored fixture (tools/make_regression_films.py)."""
    film = tpt.render("super", procedural_super_scene(), 512, 512, spp=1,
                      seed=11, device="cpu").numpy()
    got = film.reshape(16, 32, 16, 32, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(got, np.load(FIXTURE)["super"],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("wrap", [False, True])
def test_quantize_film_matches_jax(wrap):
    g = np.random.default_rng(5)
    film = g.uniform(-20, 400, (9, 7, 3)).astype(np.float32)
    got = TR.quantize_film(torch.from_numpy(film), wrap=wrap).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(JR.quantize_film(film, wrap)))
    np.testing.assert_array_equal(got, TP.film_to_rgba8(film, wrap=wrap))
    got16 = TR.quantize_film16(torch.from_numpy(film)).numpy()
    np.testing.assert_array_equal(got16, np.asarray(JR.quantize_film16(film)))


@pytest.mark.parametrize("depth", [8, 16])
def test_pam_bytes_match_jax(tmp_path, depth):
    g = np.random.default_rng(6)
    hi = 256 if depth == 8 else 65536
    dtype = np.uint8 if depth == 8 else np.uint16
    data = g.integers(0, hi, (5, 7, 4)).astype(dtype)
    info = dict(width=7, height=5, channels=4, maxval=hi - 1, depth=depth)
    TP.save_pam(str(tmp_path / "t.ppm"), TP.ImgInfo(data=data, **info))
    JP.save_pam(str(tmp_path / "j.ppm"), JP.ImgInfo(data=data, **info))
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    back = TP.load_pam(str(tmp_path / "t.ppm"))
    np.testing.assert_array_equal(back.data, data)


def _run_cli(module, args, cwd):
    env = dict(os.environ)
    env["PT_PLATFORM"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_matches_jax(tmp_path, monkeypatch, capsys):
    scene_dir = tmp_path / "scene"
    write_scene_files(procedural_super_scene(), str(scene_dir))
    args = ["super", "32", "32", "--spp", "2", "--seed", "1",
            "--scene-dir", str(scene_dir)]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    monkeypatch.chdir(tmp_path / "t")
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Seed: 1" in out and "Cam_forward" in out
    assert "Number of triangles: 96" in out
    assert "rendering" in out and "GB/s" in out
    rj = _run_cli("opencl_montecarlo_path_tracing_tpu", args,
                  str(tmp_path / "j"))
    assert rj.returncode == 0, rj.stderr
    t = TP.load_pam(str(tmp_path / "t" / "result.ppm"))
    j = JP.load_pam(str(tmp_path / "j" / "result.ppm"))
    assert (t.width, t.height, t.channels) == (32, 32, 4)
    assert pixel_agreement(t.data, j.data) >= PIXEL_AGREE


# the simple family's subcommands: (args, output file, its width and
# height); simple and simplecpu read no scene files, nodof reads the
# written demo files and renders an 8x8 sample grid a pixel
SIMPLE_CLI = [(["simple", "16", "12", "4", "--spp", "2"], "result.ppm",
               16, 12),
              (["nodof", "12", "8"], "result.ppm", 12, 8),
              (["simplecpu", "16", "12", "--spp", "2"], "resultCPU.ppm",
               16, 12)]


@pytest.mark.parametrize("case", SIMPLE_CLI, ids=[c[0][0] for c in SIMPLE_CLI])
def test_cli_simple_family_matches_jax(case, tmp_path, monkeypatch, capsys):
    args, out_name, w, h = case
    args = args + ["--seed", "1"]
    if args[0] == "nodof":
        write_scene_files(procedural_super_scene(), str(tmp_path / "scene"))
        args += ["--scene-dir", str(tmp_path / "scene")]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    monkeypatch.chdir(tmp_path / "t")
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Seed: 1" in out and "Cam_forward" in out
    stage = {"simple": "rendering :", "nodof": "rendering+reduction :",
             "simplecpu": "rendering (host) :"}[args[0]]
    assert stage in out and "GB/s" in out
    rj = _run_cli("opencl_montecarlo_path_tracing_tpu", args,
                  str(tmp_path / "j"))
    assert rj.returncode == 0, rj.stderr
    t = TP.load_pam(str(tmp_path / "t" / out_name))
    j = JP.load_pam(str(tmp_path / "j" / out_name))
    assert (t.width, t.height, t.channels) == (w, h, 4)
    assert pixel_agreement(t.data, j.data) >= PIXEL_AGREE
    if args[0] == "simplecpu":
        # the same NumPy tracer on the same draws: the same bytes, and the
        # CPU tracer's camera basis (z_vect = +1) printed
        assert np.array_equal(t.data, j.data)
        assert out.split("Cam_up")[1].split("\n")[0] == \
            rj.stdout.split("Cam_up")[1].split("\n")[0]


def test_cli_nodof_wide_pam_widens_the_image(tmp_path, monkeypatch):
    """--pam-maxval 65535 widens nodof's RGBA8 image exactly (x 257)."""
    write_scene_files(procedural_super_scene(), str(tmp_path / "scene"))
    monkeypatch.chdir(tmp_path)
    base = ["nodof", "8", "8", "--seed", "2", "--scene-dir",
            str(tmp_path / "scene"), "--device", "cpu"]
    assert cli.main(base + ["--out", "a.ppm"]) == 0
    assert cli.main(base + ["--out", "b.ppm", "--pam-maxval", "65535"]) == 0
    a, b = TP.load_pam("a.ppm"), TP.load_pam("b.ppm")
    assert b.maxval == 65535
    np.testing.assert_array_equal(b.data, a.data.astype(np.uint16) * 257)


def test_cli_unknown_variant_fails(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["raytracer", "8", "8", "--device", "cpu"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import opencl_montecarlo_path_tracing_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'opencl_montecarlo_path_tracing_tpu' not in sys.modules\n"
        "assert 'tools' not in sys.modules, 'the JAX tools imported'\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_cuda_request_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA request is served")
    with pytest.raises(RuntimeError, match="is_available"):
        tpt.render("super", demo_scene()[0], 8, 8, spp=1, device="cuda")


# small light passes for the Metropolis variants (their defaults run 512
# chains x 8 rounds)
_SMALL = {"metropolis": dict(n_seedpaths=16, mutation_rounds=2),
          "metropolis_vlpgrid": dict(n_seedpaths=16, mutation_rounds=2),
          "bidirectional": dict(n_vlp=64)}


@pytest.mark.parametrize("variant", tpt.VARIANTS)
def test_every_variant_renders(variant):
    """Each of the nine variants renders on the CPU and returns the
    documented shape and type: the pre-ambient float32 film as a tensor,
    nodof's RGBA8 image as a numpy array."""
    out = tpt.render(variant, demo_scene()[0], 8, 8, spp=4, seed=1,
                     device="cpu", **_SMALL.get(variant, {}))
    if variant == "nodof":
        assert isinstance(out, np.ndarray)
        assert out.shape == (8, 8, 4) and out.dtype == np.uint8
        assert (out[..., 3] == 255).all()
    else:
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert out.shape == (8, 8, 3) and out.dtype == torch.float32
        assert torch.isfinite(out).all()


def test_key_from_jax():
    from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import (
        make_key as t_make_key)
    for seed in (0, 7, (1 << 40) + 3):
        assert key_from_jax(make_key(seed)) == t_make_key(seed)
