"""Visualisation (port of ``gmpi_tpu/viz``): camera-path renders, videos, MPI
sheets and mesh extraction."""

from gmpi_tpu_torch.viz.mesh import (
    extract_mesh_from_alpha,
    marching_tetrahedra,
    mpi_mesh_volume_bounds,
    save_ply,
    smooth_volume,
)
from gmpi_tpu_torch.viz.render_video import (
    render_camera_path,
    render_video_artifacts,
    save_mpi_sheets,
    save_video,
    sweep_angles,
)

__all__ = [
    "extract_mesh_from_alpha",
    "marching_tetrahedra",
    "mpi_mesh_volume_bounds",
    "render_camera_path",
    "render_video_artifacts",
    "save_mpi_sheets",
    "save_ply",
    "save_video",
    "smooth_volume",
    "sweep_angles",
]
