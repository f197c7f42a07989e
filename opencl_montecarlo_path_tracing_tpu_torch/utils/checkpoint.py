"""Film checkpoint / resume.

Port of ``opencl_montecarlo_path_tracing_tpu/utils/checkpoint.py``, with
the same ``.npz`` layout, so a checkpoint written by either package loads
in the other.  The reference has no checkpointing (SURVEY.md section 5:
"closest analog: committed result images").  The rebuild gets it from the
counter-based RNG: a render is a sum of disjoint spp windows (a window's
ray ids are ``pixel * spp_total + spp_offset + s``,
models/common.py::accumulate_spp, and the kernels key the same ids), so a
film can be saved mid-accumulation and resumed later, on another device,
with the same sample content.  The film accumulates on the host in
float32: each window's tensor is copied over when it is done.  A render
sharded over a process group (parallel/mesh.py) checkpoints from rank 0
alone: it reads the file and tells the other ranks where to start, and
it alone writes (several ranks writing one file would corrupt it).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass
class FilmCheckpoint:
    film: np.ndarray          # pre-ambient float32 (H, W, 3) accumulated so far
    spp_done: int             # samples accumulated
    spp_total: int            # logical total (fixes the RNG stream space)
    seed: int
    meta: dict

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, film=self.film, spp_done=self.spp_done,
            spp_total=self.spp_total, seed=self.seed,
            meta_keys=np.array(list(self.meta.keys()), dtype=object),
            meta_vals=np.array([str(v) for v in self.meta.values()],
                               dtype=object))

    @staticmethod
    def load(path: str) -> "FilmCheckpoint":
        # object arrays need pickle: load only checkpoints this program wrote
        z = np.load(path, allow_pickle=True)
        meta = dict(zip(z["meta_keys"].tolist(), z["meta_vals"].tolist()))
        return FilmCheckpoint(film=z["film"], spp_done=int(z["spp_done"]),
                              spp_total=int(z["spp_total"]),
                              seed=int(z["seed"]), meta=meta)


def render_resumable(render_fn, key, scene, width, height, spp_total,
                     checkpoint_path: str | None = None,
                     spp_per_step: int = 64, seed: int = 0,
                     meta: dict | None = None, group=None, **kw):
    """Accumulate ``spp_total`` samples in windows of ``spp_per_step``,
    checkpointing after each window.  ``render_fn`` must accept
    (key, scene, width, height, spp=..., spp_offset=..., spp_total=...)
    and return a (height, width, 3) film, a tensor on any device or an
    array.  ``meta`` names what else the film depends on (the CLI gives
    the variant, the scene files, the quirks and the parameters); it is
    saved with the film.  A checkpoint of another total, seed or size,
    or whose meta lacks or differs in one of those entries, restarts the
    render.

    ``group``: the process group of a sharded ``render_fn`` (every window
    a collective of its ranks, which all call this function).  Rank 0
    loads the checkpoint and broadcasts its ``spp_done``, so that every
    rank starts at the same window, and rank 0 alone saves; the returned
    film is the whole film on rank 0 only (the other ranks hold the
    windows rendered in this call).

    Returns the completed FilmCheckpoint.
    """
    meta = {k: str(v) for k, v in (meta or {}).items()}
    primary = group is None or dist.get_rank(group) == 0
    ck = None
    if checkpoint_path and primary and os.path.exists(checkpoint_path):
        ck = FilmCheckpoint.load(checkpoint_path)
        if (ck.spp_total != spp_total or ck.seed != seed
                or ck.film.shape != (height, width, 3)
                or any(ck.meta.get(k) != v for k, v in meta.items())):
            ck = None  # incompatible checkpoint: start over
    if ck is None:
        ck = FilmCheckpoint(film=np.zeros((height, width, 3), np.float32),
                            spp_done=0, spp_total=spp_total, seed=seed,
                            meta={"width": width, "height": height, **meta})
    if group is not None:
        done = [ck.spp_done]
        # src is the group's rank 0: a mesh's ranks start at global rank 0
        dist.broadcast_object_list(done, src=0, group=group)
        ck.spp_done = done[0]

    while ck.spp_done < spp_total:
        step = min(spp_per_step, spp_total - ck.spp_done)
        film = render_fn(key, scene, width, height, spp=step,
                         spp_offset=ck.spp_done, spp_total=spp_total, **kw)
        if hasattr(film, "detach"):
            film = film.detach().cpu().numpy()
        ck.film = ck.film + np.asarray(film, np.float32)
        ck.spp_done += step
        if checkpoint_path and primary:
            ck.save(checkpoint_path)
    return ck
