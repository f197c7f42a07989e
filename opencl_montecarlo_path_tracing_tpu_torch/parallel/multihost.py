"""Multi-process launch support.

Port of ``opencl_montecarlo_path_tracing_tpu/parallel/multihost.py``.  The
reference is strictly single-process/single-device (one in-order
cl_command_queue, ocl_boiler.h:150).  The port's multi-device story is
PyTorch's: one process per rank, every rank runs the same program (as
``shard_map`` runs one body per device), and ``torch.distributed`` carries
the collectives - NCCL between CUDA devices, gloo on the CPU.  The SPMD
renderers in parallel/mesh.py consume a ``Mesh`` built over the ranks.

Typical launch (one process per GPU):

    torchrun --nproc-per-node 8 my_render.py

    from opencl_montecarlo_path_tracing_tpu_torch.parallel import (
        mesh, multihost)
    multihost.initialize()                  # env-driven (torchrun)
    m = mesh.make_spp_mesh()                # a mesh over every rank
    film = mesh.render_super_sharded(key, scene, 1024, 1024, 4096, m)
    # film is replicated on every rank; rank 0 writes the PAM file
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    request, the CPU when ``device`` is the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "false; the port never renders a CUDA request on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda", timeout: float = 60.0) -> None:
    """``torch.distributed.init_process_group`` with explicit or
    env-driven parameters.

    No-op when already initialized.  With no arguments (env-driven mode)
    the rendezvous comes from torchrun's MASTER_ADDR, MASTER_PORT, RANK
    and WORLD_SIZE; without them this is a no-op - the normal
    single-process case.  With EXPLICIT arguments every failure
    propagates: a wrong coordinator address or process id must not
    silently degrade a launch to N independent single-process renders.
    ``coordinator_address`` is ``host:port`` (a TCP store on it) or an
    init URL (``file://...``).

    ``backend`` follows ``device``: ``nccl`` for CUDA, ``gloo`` for the
    CPU; an explicit backend wins (gloo on CUDA devices stages every
    collective through the host, which lets several ranks share one GPU).
    A rank that does not arrive within ``timeout`` seconds fails the
    rendezvous instead of hanging it."""
    if dist.is_initialized():
        return
    env_driven = (coordinator_address is None and num_processes is None
                  and process_id is None)
    if env_driven and not all(k in os.environ for k in _ENV):
        return
    if not env_driven and (coordinator_address is None
                           or num_processes is None or process_id is None):
        raise ValueError("explicit initialize() needs coordinator_address, "
                         "num_processes and process_id")
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    if env_driven:
        dist.init_process_group(init_method="env://", **kw)
        return
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(init_method=url, world_size=int(num_processes),
                            rank=int(process_id), **kw)


def is_primary() -> bool:
    """Rank 0 (or the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
