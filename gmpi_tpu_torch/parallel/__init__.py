"""Multi-card training and rendering over ``torch.distributed`` (port of
``gmpi_tpu/parallel``): process meshes with ``data``, ``plane`` and ``tile``
axes, and the plane/tile-sharded renderers."""

from gmpi_tpu_torch.parallel.mesh import Mesh, batch_share, make_mesh, replicate
from gmpi_tpu_torch.parallel.render import (ordered_allcombine, render_mpi_plane_sharded,
                                            render_mpi_plane_sharded_pipelined,
                                            render_mpi_plane_tile_sharded,
                                            render_mpi_tile_sharded)

__all__ = [
    "Mesh",
    "batch_share",
    "make_mesh",
    "ordered_allcombine",
    "render_mpi_plane_sharded",
    "render_mpi_plane_sharded_pipelined",
    "render_mpi_plane_tile_sharded",
    "render_mpi_tile_sharded",
    "replicate",
]
