"""Lighting augmentation on MPI textures (port of ``gmpi_tpu/core/lighting.py``).

Pipeline: expected depth from the alphas (the renderer's cumprod weights),
Gaussian-blur it, back-project to a per-texel point cloud through the last
plane's xyz grid, finite-difference cross-product normals, a light position
sampled on the pose sphere, Lambertian shading ``ka + kd * max(0, -n.l)`` with
(ka, kd) grown linearly over ``n_grow_iters``, multiplied into the MPI RGB and
clipped to [0, 1].  A function of (mpi, step, generator): the schedule
position is an argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import poses as poses_mod
from benchmark.reference.render import COMPOSITE_EPS

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class LightingConfig:
    sphere_center_z: float
    sphere_r: float
    ka_max: float = 0.9
    kd_max: float = 0.1
    n_grow_iters: int = 1000
    l_h_mean: float = 0.0
    l_h_std: float = 0.2
    l_v_mean: float = 0.2
    l_v_std: float = 0.05
    blur_ksize: int = 9


def _gaussian_kernel1d(ksize: int) -> np.ndarray:
    """OpenCV's sigma for a kernel size."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable Gaussian blur of ``[B, C, H, W]`` with reflect padding."""
    k = torch.from_numpy(_gaussian_kernel1d(ksize)).to(x.device, x.dtype)
    c = x.shape[1]
    pad = ksize // 2
    xp = F.pad(x, [pad, pad, pad, pad], mode="reflect")
    y = F.conv2d(xp, k.reshape(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    return F.conv2d(y, k.reshape(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)


def expected_depth(mpi_alpha: torch.Tensor, plane_ds: torch.Tensor) -> torch.Tensor:
    """``[B, L, 1, H, W]`` alphas and ``[L]`` depths -> ``[B, 1, H, W]``."""
    shifted = torch.cat([torch.ones_like(mpi_alpha[:, :1]), 1.0 - mpi_alpha + COMPOSITE_EPS],
                        dim=1)
    weights = mpi_alpha * torch.cumprod(shifted, dim=1)[:, :-1]
    return torch.sum(weights * plane_ds.reshape(1, -1, 1, 1, 1), dim=1)


def texel_point_cloud(mpi_alpha: torch.Tensor, dhw: torch.Tensor, xyz_last_plane: torch.Tensor,
                      blur_ksize: int) -> torch.Tensor:
    """Back-project the blurred expected depth through the last plane's texel
    rays: ``[B, H, W, 3]``."""
    depth = gaussian_blur(expected_depth(mpi_alpha, dhw[:, 0]), blur_ksize)[:, 0]  # [B, H, W]
    scale = depth[..., None] / (xyz_last_plane[..., 2:] + EPS)
    return xyz_last_plane * scale


def finite_difference_normals(grid_3d: torch.Tensor) -> torch.Tensor:
    """Cross-product normals from the 4 neighbour triangles, replicate-padded
    and normalized: ``[B, H, W, 3]``."""
    center = grid_3d[:, 1:-1, 1:-1]
    up = grid_3d[:, :-2, 1:-1] - center
    down = grid_3d[:, 2:, 1:-1] - center
    left = grid_3d[:, 1:-1, :-2] - center
    right = grid_3d[:, 1:-1, 2:] - center
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731
    normal = cross(up, left) + cross(left, down) + cross(down, right) + cross(right, up)
    normal = F.pad(normal.permute(0, 3, 1, 2), [1, 1, 1, 1], mode="replicate").permute(0, 2, 3, 1)
    return normal / (torch.sqrt(torch.sum(normal**2, dim=3, keepdim=True)) + EPS)


def light_pose_config(cfg: LightingConfig) -> poses_mod.SphereCameraConfig:
    """The distribution the light's position is drawn from."""
    return poses_mod.SphereCameraConfig(
        sphere_center_z=cfg.sphere_center_z, sphere_r=cfg.sphere_r,
        yaw_mean=cfg.l_h_mean, yaw_std=cfg.l_h_std,
        pitch_mean=cfg.l_v_mean, pitch_std=cfg.l_v_std,
        n_truncated_stds=2.0, sample_method="truncated_gaussian")


def light_mpi(cfg: LightingConfig, mpi: torch.Tensor, dhw: torch.Tensor,
              xyz_last_plane: torch.Tensor, step: int,
              generator: Optional[torch.Generator] = None, light_yaws=None, light_pitches=None
              ) -> torch.Tensor:
    """Re-light ``mpi [B, L, 4, H, W]`` (values in [0, 1]).  dhw ``[L, 3]``;
    xyz_last_plane ``[H, W, 3]`` texel coordinates of the last plane; ``step``
    the position in the growth schedule.  The light's angles are drawn from
    ``generator`` unless given."""
    bs = mpi.shape[0]
    rgb, alpha = mpi[:, :, :3], mpi[:, :, 3:]
    grid_3d = texel_point_cloud(alpha, dhw, xyz_last_plane, cfg.blur_ksize)

    c2w, _, _ = poses_mod.sample_sphere_poses(generator, bs, light_pose_config(cfg),
                                              given_yaws=light_yaws,
                                              given_pitches=light_pitches, device=mpi.device)
    sphere_center = torch.tensor([0.0, 0.0, cfg.sphere_center_z], device=mpi.device)
    light_dir = sphere_center[None] - c2w[:, :3, 3]
    light_dir = light_dir / torch.linalg.vector_norm(light_dir, dim=-1, keepdim=True)

    normal = finite_difference_normals(grid_3d)  # [B, H, W, 3]
    diffuse = -torch.sum(normal * light_dir.reshape(-1, 1, 1, 3), dim=3)
    diffuse = torch.clamp(diffuse, min=0.0)[:, None, None]  # [B, 1, 1, H, W]

    ratio = min(1.0, float(step) / cfg.n_grow_iters)
    shading = ratio * cfg.ka_max + diffuse * (ratio * cfg.kd_max)
    return torch.cat([torch.clamp(rgb * shading, 0.0, 1.0), alpha], dim=2)
