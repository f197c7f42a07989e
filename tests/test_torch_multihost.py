"""Multi-process rendering is real: 2 OS processes, ``multihost.initialize``
in its env-driven mode (torchrun's MASTER_ADDR / MASTER_PORT / RANK /
WORLD_SIZE), gloo on the CPU, one spp mesh over both ranks; the film
matches the single-process render to the CRN contract (utils/crn.py: the
same samples summed in another order), as ``tests/test_multihost.py``
holds the JAX package's (at atol 2e-3).  Explicit arguments that cannot
rendezvous raise instead of degrading to one process."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist

from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu_torch.models.super import render_super
from opencl_montecarlo_path_tracing_tpu_torch.parallel import multihost
from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import demo_scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_torch_utils import _one_thread_warm_sqrt  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    torch.sqrt(torch.rand(16384) * 400.0)   # the first sqrt (ROADMAP C)
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.parallel import (
        mesh, multihost)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    multihost.initialize(device="cpu")          # env-driven
    m = mesh.make_spp_mesh(device="cpu")
    assert m.size == 2 and m.rank == torch.distributed.get_rank()
    film = mesh.render_super_sharded(make_key(31), demo_scene()[0], 8, 8,
                                     4, m)
    if multihost.is_primary():
        np.save(sys.argv[1], film.numpy())
    torch.distributed.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_render(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = tmp_path / "film.npy"
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(out)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    film = np.load(out)
    single = render_super(make_key(31), demo_scene()[0], 8, 8, 4,
                          device="cpu")
    ok, st = crn_ok(film, single, 4)
    assert ok, st


def test_env_driven_without_environment_is_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device="cpu")
    assert not dist.is_initialized() and multihost.is_primary()


def test_initialize_explicit_bad_args_raise():
    """Explicit-arg failures propagate (no silent single-process
    degradation): an incomplete set, and a coordinator nobody serves."""
    with pytest.raises(ValueError, match="needs coordinator_address"):
        multihost.initialize(num_processes=2, process_id=0, device="cpu")
    port = _free_port()     # nothing listens there
    with pytest.raises((RuntimeError, TimeoutError, OSError)):
        multihost.initialize(f"127.0.0.1:{port}", 2, 1, device="cpu",
                             timeout=1.0)
    assert not dist.is_initialized()
