"""Pinhole camera model (port of ``gmpi_tpu/core/camera.py``).

World convention of the reference MPI frame: **+X right, +Y down, +Z
forward**.  Ray grids are float32 and built on the device of the poses.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    """Pinhole intrinsics ``K = [[f, 0, w/2], [0, f, h/2], [0, 0, 1]]`` with
    ``f = w / (2 tan(fov/2))``."""

    focal: float
    height: int
    width: int


def intrinsics_from_fov(fov_deg: float, height: int, width: int) -> Intrinsics:
    tan_half = math.tan(math.pi * fov_deg / (2.0 * 180.0))
    return Intrinsics(focal=width / (2.0 * tan_half), height=height, width=width)


def pixel_ray_dirs_cam(intr: Intrinsics, from_pixel_center: bool = True,
                       device="cpu") -> torch.Tensor:
    """Unit per-pixel ray directions in the camera frame, ``[3, H, W]`` f32."""
    h, w, f = intr.height, intr.width, intr.focal
    off = 0.5 if from_pixel_center else 0.0
    xs = (torch.arange(w, dtype=torch.float32, device=device) + off - w / 2.0) / f
    ys = (torch.arange(h, dtype=torch.float32, device=device) + off - h / 2.0) / f
    xx = xs[None, :].expand(h, w)
    yy = ys[:, None].expand(h, w)
    p = torch.stack([xx, yy, torch.ones_like(xx)], dim=0)
    return p / torch.linalg.vector_norm(p, dim=0, keepdim=True)


def border_ray_dirs_cam(intr: Intrinsics) -> np.ndarray:
    """Unit rays through the four image corners, ``[3, 4]`` float64 numpy
    (host-side frustum fitting only)."""
    h, w, f = intr.height, intr.width, intr.focal
    us = np.array([0.0, w, 0.0, w])
    vs = np.array([0.0, 0.0, h, h])
    p = np.stack([(us - w / 2.0) / f, (vs - h / 2.0) / f, np.ones(4)], axis=0)
    return p / np.linalg.norm(p, axis=0, keepdims=True)


def generate_rays(intr: Intrinsics, c2w: torch.Tensor, from_pixel_center: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World rays for camera-to-world transforms ``c2w [..., 4, 4]``.

    Returns ray_dir ``[..., 3, H, W]``, eye_pos ``[..., 3]``, z_dir ``[..., 3]``.
    """
    c2w = c2w.to(torch.float32)
    dirs_cam = pixel_ray_dirs_cam(intr, from_pixel_center, device=c2w.device)
    rot = c2w[..., :3, :3]
    eye = c2w[..., :3, 3]
    z_dir = rot[..., :, 2]
    ray_dir = torch.matmul(rot, dirs_cam.reshape(3, -1))
    ray_dir = ray_dir.reshape(c2w.shape[:-2] + (3, intr.height, intr.width))
    return ray_dir, eye, z_dir
