"""Rank-mesh parallelism: spp sharding with a film all-reduce.

Port of ``opencl_montecarlo_path_tracing_tpu/parallel/mesh.py``.  The
reference is a single-device codebase (one in-order cl_command_queue,
ocl_boiler.h:150); its only scaling axes are the 2-D NDRange and the
sample-parallel decomposition of CLSuperPathTracer_lmem_NoDoF.  The JAX
package shards spp over a device mesh with ``shard_map``; here every rank
of a ``torch.distributed`` process group runs the same body (one process
per device, parallel/multihost.py), renders a disjoint sample window of
the *same* logical sample space (counter-based RNG keyed on
pixel*spp_total + sample, so the set of drawn samples is independent of
the layout), and the films are summed by ``all_reduce``.

The per-rank sample windows make the sharded image equal to the
single-device image up to float summation order.  Row bands (nodof, the
2-D meshes) and the VLP light-pass windows are equal bit for bit: their
draws key on global pixel, work-item and chain indices.

Collectives go through :func:`_collect`: NCCL takes device tensors, gloo
host tensors (a CUDA tensor is copied over and back, so several ranks can
share one GPU - NCCL refuses that).  A mesh of one rank without a process
group has identity collectives, the counterpart of the JAX package's
one-device mesh.  No compiled-program cache is kept: a torch body has no
trace to reuse.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..core.quirks import Quirks, DEFAULT
from ..models.common import MAX_BOUNCES
from ..models.super import film_super
from ..ops.intersect import SceneArrays, prep_scene
from ..scene.scene import Scene
from .multihost import rank_device

_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out on named axes, rank-major in ``jax.make_mesh``'s
    order: the last axis varies fastest (rank = iy * n_spp + isp).

    ``group`` is the process group over the mesh's ranks, or None for a
    mesh of one rank outside any group; ``axis_groups`` holds this rank's
    sub-group along each axis of a 2-D mesh (None for an axis of size 1);
    ``rank`` is this rank's flat index, None on a rank the mesh does not
    include; ``device`` is where this rank renders."""
    shape: dict
    device: torch.device
    rank: int | None = 0
    group: object = None
    axis_groups: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.rank is None:
            raise ValueError("this rank is not part of the mesh")
        axes = list(self.shape)
        inner = math.prod(self.shape[a] for a in axes[axes.index(axis) + 1:])
        return (self.rank // inner) % self.shape[axis]

    def axis_group(self, axis: str):
        if len(self.shape) == 1:
            return self.group
        return self.axis_groups.get(axis)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh_ranks(n: int):
    """(group, this rank's index) of a mesh over ranks [0, n): the world
    group when it has n ranks, else a new group that every rank creates
    (torch requires it); the index is None on ranks past n."""
    world = _world()
    if n > world:
        raise ValueError(f"a mesh of {n} needs {n} ranks; have {world}")
    if not dist.is_initialized():
        return None, 0
    rank = dist.get_rank()
    if n == world:
        return dist.group.WORLD, rank
    group = dist.new_group(list(range(n))) if n > 1 else None
    return group, (rank if rank < n else None)


def make_spp_mesh(n_devices: int | None = None, axis: str = "spp",
                  device="cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks (default: all of
    them), rendering on this rank's ``device`` (multihost.rank_device)."""
    n = _world() if n_devices is None else int(n_devices)
    group, rank = _mesh_ranks(n)
    return Mesh({axis: n}, rank_device(device), rank, group)


def make_mesh_2d(n_rows: int, n_spp: int, device="cuda") -> Mesh:
    """2-D mesh: image rows ('y') x samples ('spp') over the first
    n_rows * n_spp ranks.  Every rank creates every row and column
    sub-group, in the same order (or the ranks deadlock)."""
    group, rank = _mesh_ranks(n_rows * n_spp)
    axis_groups = {}
    if group is not None:
        for iy in range(n_rows):
            ranks = [iy * n_spp + s for s in range(n_spp)]
            g = dist.new_group(ranks) if n_spp > 1 else None
            if rank is not None and rank // n_spp == iy:
                axis_groups["spp"] = g
        for isp in range(n_spp):
            ranks = [iy * n_spp + isp for iy in range(n_rows)]
            g = dist.new_group(ranks) if n_rows > 1 else None
            if rank is not None and rank % n_spp == isp:
                axis_groups["y"] = g
    return Mesh({"y": n_rows, "spp": n_spp}, rank_device(device), rank,
                group, axis_groups)


def _collect(t: torch.Tensor, group, op: str):
    """The one collective of this module: ``op="sum"`` returns the
    all-reduced sum of ``t`` over ``group``, ``op="gather"`` every rank's
    ``t`` in rank order.  NCCL gets the device tensor; gloo a host copy,
    the result copied back (chosen by the group's backend).  With no
    group, the identity."""
    if group is None:
        return t if op == "sum" else [t]
    host = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    x = t.detach().to("cpu" if host else t.device, copy=True).contiguous()
    if op == "sum":
        dist.all_reduce(x, group=group)
        return x.to(t.device)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return [p.to(t.device) for p in parts]


def _window(offset, idx: int, local: int) -> int:
    """A rank's first sample, ``offset + idx * local`` in uint32."""
    return (int(offset) + idx * local) & _MASK


def _prep(scene):
    return prep_scene(scene) if isinstance(scene, Scene) else scene


def _axis(mesh: Mesh) -> str:
    """The axis of a 1-D mesh."""
    return tuple(mesh.shape)[0]


def shard_spp(film_fn, mesh: Mesh, spp: int, axis: str = "spp",
              spp_total: int | None = None):
    """Wrap ``film_fn(key, spp_local, spp_offset, spp_total) -> film`` into
    the SPMD body ``(key, spp_offset) -> film``: each rank renders its
    sample window of the ``spp`` samples starting at the global
    ``spp_offset``, and the films are summed over ``axis``; the result is
    replicated.  ``spp_total`` fixes the logical RNG stream space
    (defaults to ``spp``); pass the full-render total when rendering a
    checkpoint window so windows compose (utils/checkpoint.py)."""
    n = mesh.shape[axis]
    if spp % n:
        raise ValueError(f"spp={spp} not divisible by mesh size {n}")
    local = spp // n
    total = spp if spp_total is None else spp_total

    def body(key, spp_offset=0):
        idx = mesh.index(axis)
        film = film_fn(key, local, _window(spp_offset, idx, local), total)
        return _collect(film, mesh.axis_group(axis), "sum")

    return body


def render_super_sharded(key, scene: Scene | SceneArrays, width: int,
                         height: int, spp: int, mesh: Mesh | None = None,
                         quirks: Quirks = DEFAULT,
                         max_bounces: int = MAX_BOUNCES,
                         spp_offset: int = 0, spp_total: int | None = None):
    """Multi-rank render of the full scene; returns the replicated
    pre-ambient film (H, W, 3) on the rank's device.  ``spp_offset`` /
    ``spp_total`` select a sample window for checkpointed accumulation."""
    scn = _prep(scene)
    mesh = make_spp_mesh() if mesh is None else mesh

    def film_fn(k, local, offset, total):
        return film_super(k, scn, width, height, local, offset, total,
                          quirks, max_bounces, device=mesh.device)

    return shard_spp(film_fn, mesh, spp, _axis(mesh),
                     spp_total)(key, spp_offset)


def render_simple_sharded(key, width: int, height: int, spp: int,
                          mesh: Mesh | None = None,
                          quirks: Quirks = DEFAULT,
                          max_bounces: int = MAX_BOUNCES,
                          spp_offset: int = 0, spp_total: int | None = None):
    """spp-sharded render of the multi-bounce mirror tracer
    (CLSimplePathTracer): each rank renders its sample window of the
    business-card scene (kernel B5 on CUDA takes spp windows) and the
    films are summed."""
    from ..models.simple import film_simple
    mesh = make_spp_mesh() if mesh is None else mesh

    def film_fn(k, local, offset, total):
        return film_simple(k, width, height, local, offset, total, quirks,
                           max_bounces, device=mesh.device)

    return shard_spp(film_fn, mesh, spp, _axis(mesh),
                     spp_total)(key, spp_offset)


def _shard_light(mesh: Mesh, n_items: int, nlights: int) -> bool:
    """Whether a light pass of ``n_items`` work items (VLP work items or
    chains) a light is windowed over the whole (flattened) mesh: an
    indivisible window, or no lights, renders it replicated, as the JAX
    package does."""
    return bool(nlights) and n_items % mesh.size == 0


def bpt_light_pass(key, scn: SceneArrays, n_vlp: int, quirks: Quirks,
                   mesh: Mesh, sharded: bool = True):
    """The bidirectional light pass on ``mesh``: with ``sharded`` (and a
    divisible window) each rank emits the work-item window
    [r*n_vlp/n, (r+1)*n_vlp/n) of every light over the flattened mesh
    (r = iy*n_spp + isp on a 2-D mesh), the windows are all-gathered and
    reassembled to the reference's vlp[gi + l*n_vlp] layout; otherwise
    every rank emits the full table.  Bit-equal to ``emit_vlps``."""
    from ..ops.vlp import emit_vlps
    n = mesh.size
    nlights = int(scn.lights.shape[0])
    if not (sharded and _shard_light(mesh, n_vlp, nlights)):
        return emit_vlps(key, scn, n_vlp, quirks, device=mesh.device)
    if mesh.rank is None:
        raise ValueError("this rank is not part of the mesh")
    localv = n_vlp // n
    part = emit_vlps(key, scn, n_vlp, quirks, gi0=mesh.rank * localv,
                     count=localv, device=mesh.device)
    g = torch.stack(_collect(part, mesh.group, "gather"))
    return (g.reshape(n, nlights, localv, 4).permute(1, 0, 2, 3)
            .reshape(nlights * n_vlp, 4))


def mlt_light_pass(key, scn: SceneArrays, n_seedpaths: int,
                   mutation_rounds: int, quirks: Quirks, mesh: Mesh,
                   sharded: bool = True):
    """The Metropolis light pass on ``mesh``: with ``sharded`` (and a
    divisible window) each rank runs the chain window
    [r*n/N, (r+1)*n/N) of every light's seed/Mutate/emit pipeline over the
    flattened mesh, the windows are all-gathered and reassembled to the
    light-major, slot, chain layout of ``mlt_vlps``; otherwise every rank
    runs every chain.  Bit-equal to ``mlt_vlps``."""
    from ..models.metropolis import mlt_vlps
    n = mesh.size
    nlights = int(scn.lights.shape[0])
    if not (sharded and _shard_light(mesh, n_seedpaths, nlights)):
        return mlt_vlps(key, scn, n_seedpaths, mutation_rounds, quirks,
                        device=mesh.device)
    if mesh.rank is None:
        raise ValueError("this rank is not part of the mesh")
    localc = n_seedpaths // n
    part = mlt_vlps(key, scn, n_seedpaths, mutation_rounds, quirks,
                    chain0=mesh.rank * localc, chains=localc,
                    device=mesh.device)
    # part: [light][slot][chain window] -> [light][slot][chain]
    g = torch.stack(_collect(part, mesh.group, "gather"))
    return (g.reshape(n, nlights, 4, localc, 4).permute(1, 2, 0, 3, 4)
            .reshape(nlights * 4 * n_seedpaths, 4))


def _light_pass_mode(light_pass: str) -> bool:
    if light_pass not in ("sharded", "replicated"):
        raise ValueError(f"light_pass={light_pass!r}: sharded or replicated")
    return light_pass == "sharded"


def render_bidirectional_sharded(key, scene, width: int, height: int,
                                 spp: int, mesh: Mesh | None = None,
                                 n_vlp: int = 512,
                                 quirks: Quirks = DEFAULT,
                                 use_grid: bool = False,
                                 light_pass: str = "sharded",
                                 spp_offset: int = 0,
                                 spp_total: int | None = None):
    """spp-sharded bidirectional render.

    ``light_pass="sharded"`` (default): each rank emits only its n_vlp/n
    work-item window of the lightTracer pass and the VLP table is
    all-gathered (:func:`bpt_light_pass`); an indivisible window or a
    scene without lights renders the pass replicated.  The film is
    bit-equal to the replicated light pass's.

    ``light_pass="replicated"``: every rank emits the SAME full VLP set
    (same key -> identical emission, no communication)."""
    from ..models.bidirectional import film_bidirectional
    scn = _prep(scene)
    mesh = make_spp_mesh() if mesh is None else mesh
    sharded = _light_pass_mode(light_pass)
    axis = _axis(mesh)
    n = mesh.shape[axis]
    if spp % n:
        raise ValueError(f"spp={spp} not divisible by mesh size {n}")
    local = spp // n
    total = spp if spp_total is None else spp_total
    vlps = bpt_light_pass(key, scn, n_vlp, quirks, mesh, sharded)
    film = film_bidirectional(
        key, scn, width, height, local,
        _window(spp_offset, mesh.index(axis), local), total, n_vlp, quirks,
        use_grid=use_grid, precomputed_vlps=vlps, device=mesh.device)
    return _collect(film, mesh.group, "sum")


def render_metropolis_sharded(key, scene, width: int, height: int,
                              spp: int, mesh: Mesh | None = None,
                              n_seedpaths: int = 512,
                              mutation_rounds: int = 8,
                              quirks: Quirks = DEFAULT,
                              use_grid: bool = False,
                              grid_modifier: float = 3.0,
                              light_pass: str = "sharded",
                              spp_offset: int = 0,
                              spp_total: int | None = None):
    """spp-sharded Metropolis render.

    ``light_pass="sharded"`` (default): each rank runs only its
    n_seedpaths/n chain window and the VLP table is all-gathered
    (:func:`mlt_light_pass`), which removes the n-fold replicated chain
    work; an indivisible window or a scene without lights renders the
    pass replicated.

    ``light_pass="replicated"``: every rank derives the identical full
    VLP set (chains keyed on (key, chain id), no communication)."""
    from ..models.metropolis import film_metropolis
    scn = _prep(scene)
    mesh = make_spp_mesh() if mesh is None else mesh
    sharded = _light_pass_mode(light_pass)
    axis = _axis(mesh)
    n = mesh.shape[axis]
    if spp % n:
        raise ValueError(f"spp={spp} not divisible by mesh size {n}")
    local = spp // n
    total = spp if spp_total is None else spp_total
    vlps = mlt_light_pass(key, scn, n_seedpaths, mutation_rounds, quirks,
                          mesh, sharded)
    film = film_metropolis(
        key, scn, width, height, local,
        _window(spp_offset, mesh.index(axis), local), total, n_seedpaths,
        mutation_rounds, quirks, use_grid=use_grid,
        grid_modifier=grid_modifier, precomputed_vlps=vlps,
        device=mesh.device)
    return _collect(film, mesh.group, "sum")


def render_trianglegrid_sharded(key, scene, width: int, height: int,
                                spp: int, mesh: Mesh | None = None,
                                cell_size_modifier: float = 3.0,
                                quirks: Quirks = DEFAULT,
                                max_bounces: int = MAX_BOUNCES,
                                spp_offset: int = 0,
                                spp_total: int | None = None):
    """spp-sharded grid-accelerated render: every rank renders its sample
    window through ``render_trianglegrid`` - the same deterministic grid
    build everywhere on the CPU (the uniform-grid walk), the super
    kernels' walk (B2/B3) on CUDA (``accel="auto"``) - and the films are
    summed."""
    from ..models.trianglegrid import render_trianglegrid
    scn = _prep(scene)
    mesh = make_spp_mesh() if mesh is None else mesh

    def film_fn(k, local, offset, total):
        return render_trianglegrid(
            k, scn, width, height, local, cell_size_modifier, offset, total,
            quirks, max_bounces, device=mesh.device)

    return shard_spp(film_fn, mesh, spp, _axis(mesh),
                     spp_total)(key, spp_offset)


def render_sample_parallel_sharded(key, scene, width: int, height: int,
                                   sample_grid: int = 8,
                                   mesh: Mesh | None = None,
                                   quirks: Quirks = DEFAULT,
                                   max_bounces: int = MAX_BOUNCES):
    """Image-row-sharded NoDoF render: each rank produces one horizontal
    pixel-row band (samples and reduction stay on its device,
    models/sample_parallel.py) and the uint8 bands are all-gathered.  Band
    content equals the single-device image exactly (ray ids are keyed on
    the global pixel index)."""
    from ..models.sample_parallel import render_sample_parallel
    scn = _prep(scene)
    mesh = make_spp_mesh(axis="y") if mesh is None else mesh
    axis = _axis(mesh)
    n = mesh.shape[axis]
    if height % n:
        raise ValueError(f"height={height} not divisible by mesh size {n}")
    rows = height // n
    img = render_sample_parallel(
        key, scn, width, height, sample_grid, quirks, max_bounces,
        row_offset=mesh.index(axis) * rows, rows=rows, device=mesh.device)
    return torch.cat(_collect(img, mesh.group, "gather"), dim=0)


def _split_2d(mesh: Mesh, height: int, spp: int):
    ny, nspp = mesh.shape["y"], mesh.shape["spp"]
    if height % ny or spp % nspp:
        raise ValueError(f"height={height} % {ny} or spp={spp} % "
                         f"{nspp} != 0")
    return height // ny, spp // nspp


def _reduce_2d(film, mesh: Mesh):
    """psum over 'spp', then the row bands gathered over 'y'."""
    film = _collect(film, mesh.axis_group("spp"), "sum")
    return torch.cat(_collect(film, mesh.axis_group("y"), "gather"), dim=0)


def render_super_sharded_2d(key, scene: Scene | SceneArrays, width: int,
                            height: int, spp: int, mesh: Mesh,
                            quirks: Quirks = DEFAULT,
                            max_bounces: int = MAX_BOUNCES):
    """Render sharded over BOTH the image-row axis and the spp axis: each
    rank renders a (rows/n_y) band for its spp window; films are summed
    over 'spp' and gathered over 'y'.  Sample content is identical to the
    single-device render."""
    scn = _prep(scene)
    rows, local = _split_2d(mesh, height, spp)
    film = film_super(key, scn, width, height, local,
                      mesh.index("spp") * local, spp, quirks, max_bounces,
                      row_offset=mesh.index("y") * rows, rows=rows,
                      device=mesh.device)
    return _reduce_2d(film, mesh)


def render_bidirectional_sharded_2d(key, scene, width: int, height: int,
                                    spp: int, mesh: Mesh, n_vlp: int = 512,
                                    quirks: Quirks = DEFAULT,
                                    use_grid: bool = False):
    """Bidirectional render sharded over image rows ('y') AND spp
    ('spp'), with the LIGHT pass sharded over the FLATTENED mesh (each of
    the n_y*n_spp ranks emits the work-item window of its flat rank,
    :func:`bpt_light_pass`); each rank then renders its (row band, spp
    window) and the film is summed over 'spp' and gathered over 'y'."""
    from ..models.bidirectional import film_bidirectional
    scn = _prep(scene)
    rows, local = _split_2d(mesh, height, spp)
    vlps = bpt_light_pass(key, scn, n_vlp, quirks, mesh)
    film = film_bidirectional(
        key, scn, width, height, local, mesh.index("spp") * local, spp,
        n_vlp, quirks, use_grid=use_grid, precomputed_vlps=vlps,
        row_offset=mesh.index("y") * rows, rows=rows, device=mesh.device)
    return _reduce_2d(film, mesh)


def render_metropolis_sharded_2d(key, scene, width: int, height: int,
                                 spp: int, mesh: Mesh,
                                 n_seedpaths: int = 512,
                                 mutation_rounds: int = 8,
                                 quirks: Quirks = DEFAULT,
                                 use_grid: bool = False,
                                 grid_modifier: float = 3.0):
    """Metropolis render sharded over rows x spp with the chain pipeline
    sharded over the flattened mesh (:func:`mlt_light_pass`) - the 2-D
    analogue of render_metropolis_sharded's sharded light pass."""
    from ..models.metropolis import film_metropolis
    scn = _prep(scene)
    rows, local = _split_2d(mesh, height, spp)
    vlps = mlt_light_pass(key, scn, n_seedpaths, mutation_rounds, quirks,
                          mesh)
    film = film_metropolis(
        key, scn, width, height, local, mesh.index("spp") * local, spp,
        n_seedpaths, mutation_rounds, quirks, use_grid=use_grid,
        grid_modifier=grid_modifier, precomputed_vlps=vlps,
        row_offset=mesh.index("y") * rows, rows=rows, device=mesh.device)
    return _reduce_2d(film, mesh)
