"""Static warp-band estimation for the tile-banded warp (port of
``gmpi_tpu/core/bands.py``).

The tiled warp needs band sizes fixed ahead of the render, covering each
output tile's texture-coordinate span (``ops/tiled_warp.required_bands``).
Spans depend on the camera pose; for a truncated pose distribution the worst
case is at the corners of the (yaw, pitch) range, so sampling the extreme and
centre poses once at setup gives safe static bands for every training and eval
render under that distribution.  Planning is host work and runs on the CPU.

``fused_plans_for_config`` and ``fused_slab_plan_for_config`` of the JAX
module have no counterpart: the port's fused forward and splat run a thread
per pixel and need no band plan.  The one plan the fused path can take, the
adjoint kernel's windows, comes from ``core.renderer.plan_fused``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses as poses_mod
from gmpi_tpu_torch.core.geometry import PlaneGeometry
from gmpi_tpu_torch.core.renderer import homography_grid
from gmpi_tpu_torch.ops.tiled_warp import required_bands
from gmpi_tpu_torch.ops.tiled_warp_adjoint import check_monotone, required_output_bands


def _round_up(x: int, m: int = 8) -> int:
    return ((x + m - 1) // m) * m


def _corner_rays(camera_cfg, fov_deg: float, img_h: int, img_w: int):
    """Rays ``(ray_dir, eye, z_dir)`` from the 9 corner and centre poses of
    the truncated (yaw, pitch) range: the worst-case pose set of all static
    band planning."""
    c = camera_cfg
    n = c.n_truncated_stds
    yaws, pitches = [], []
    for sy in (-n, 0.0, n):
        for sp in (-n, 0.0, n):
            yaws.append(c.yaw_mean + sy * c.yaw_std)
            pitches.append(c.pitch_mean + sp * c.pitch_std)
    yaws = torch.tensor(yaws, dtype=torch.float32).reshape(-1, 1)
    pitches = torch.tensor(pitches, dtype=torch.float32).reshape(-1, 1)
    c2w, _, _ = poses_mod.sample_sphere_poses(None, len(yaws), c, given_yaws=yaws,
                                              given_pitches=pitches, device="cpu")
    return cam.generate_rays(cam.intrinsics_from_fov(fov_deg, img_h, img_w), c2w)


def estimate_bands(geom: PlaneGeometry, camera_cfg: poses_mod.SphereCameraConfig,
                   fov_deg: float, img_h: int, img_w: int, margin: float = 1.15,
                   tile: Optional[Tuple[int, int]] = None) -> Tuple[int, ...]:
    """Safe ``(band_y, band_x)`` for all poses within the truncation range,
    followed by the tiled adjoint's ``(rows, cols)`` output bands when the
    warp is monotone over that range (else the 2-tuple)."""
    ray_dir, eye, z_dir = _corner_rays(camera_cfg, fov_deg, img_h, img_w)
    v, n_l = ray_dir.shape[0], geom.n_planes
    dhw = geom.dhw.detach().cpu().float()[None].expand(v, n_l, 3).reshape(v * n_l, 3)
    ray = ray_dir[:, None].expand(v, n_l, 3, img_h, img_w).reshape(v * n_l, 3, img_h, img_w)
    eye_f = eye[:, None].expand(v, n_l, 3).reshape(v * n_l, 3)
    z_f = z_dir[:, None].expand(v, n_l, 3).reshape(v * n_l, 3)
    grid, _ = homography_grid(dhw, eye_f, ray, z_f)
    if tile is None:
        # must mirror core/renderer._sample's tile heuristic
        tile = (8 if img_h % 8 == 0 else 1,
                256 if img_w % 256 == 0 else 128 if img_w % 128 == 0 else img_w)
    tex_shape = (v * n_l, 4, img_h, img_w)  # texture assumed image-sized
    by, bx = required_bands(tex_shape, grid, tile=tile)
    by = _round_up(math.ceil(by * margin))
    bx = _round_up(math.ceil(bx * margin))
    if not check_monotone(tex_shape, grid):
        return by, bx
    # the adjoint runs on taller and wider texture tiles, which amortize the
    # overlap of neighbouring tiles' bands
    atile = (32 if img_h % 32 == 0 else tile[0],
             512 if img_w % 512 == 0 else 256 if img_w % 256 == 0 else tile[1])
    pbr, pbc = required_output_bands(tex_shape, grid, tile=atile)
    return by, bx, _round_up(math.ceil(pbr * margin)), _round_up(math.ceil(pbc * margin))


def bands_for_config(cfg, img_size: Optional[int] = None, n_planes: Optional[int] = None
                     ) -> Optional[Tuple[int, ...]]:
    """Bands of :func:`estimate_bands` for an ``ExperimentConfig``, or None
    when the image is too small for tiling to pay off."""
    img = img_size or cfg.hparams.img_size
    if img < 128:
        return None
    planes = dataclasses.replace(cfg.planes, n_planes=n_planes or cfg.planes.n_planes)
    geom = dataclasses.replace(cfg, planes=planes).plane_geometry(device="cpu")
    return estimate_bands(geom, cfg.camera, cfg.fov_deg, img, img)
