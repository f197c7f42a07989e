"""Multi-rank rendering over ``torch.distributed`` (port of the JAX
package's ``parallel/``): parallel/mesh.py holds the meshes and the
sharded renderers, parallel/multihost.py the process-group launch."""

from .mesh import (
    make_spp_mesh, make_mesh_2d, shard_spp,
    render_super_sharded, render_super_sharded_2d, render_simple_sharded,
    render_bidirectional_sharded, render_metropolis_sharded,
    render_bidirectional_sharded_2d, render_metropolis_sharded_2d,
    render_trianglegrid_sharded, render_sample_parallel_sharded,
)

__all__ = [
    "make_spp_mesh", "make_mesh_2d", "shard_spp",
    "render_super_sharded", "render_super_sharded_2d",
    "render_simple_sharded",
    "render_bidirectional_sharded", "render_metropolis_sharded",
    "render_bidirectional_sharded_2d", "render_metropolis_sharded_2d",
    "render_trianglegrid_sharded", "render_sample_parallel_sharded",
]
