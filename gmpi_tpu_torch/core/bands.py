"""Static warp-band estimation for the tile-banded warp (port of
``gmpi_tpu/core/bands.py``).

The tiled warp needs band sizes fixed ahead of the render, covering each
output tile's texture-coordinate span (``ops/tiled_warp.required_bands``).
Spans depend on the camera pose; for a truncated pose distribution the worst
case is at the corners of the (yaw, pitch) range, so sampling the extreme and
centre poses once at setup gives safe static bands for every training and eval
render under that distribution.

Planning runs on the caller's device (CUDA by default, as every entry point of
the port; ``device="cpu"`` asks for the host), as the JAX package plans on its
default device.  The homography grids of all (pose, plane) pairs would not fit
at once at 1024^2 (9 poses x 96 planes of 1024^2 x 2 coordinates is 7.2 GB),
so they are built and measured in groups whose grids and intermediates stay
under ``PLAN_STEP_BYTES``.  Every measure is a maximum (or, for monotonicity,
an all) over the pairs, so the grouping changes no value.

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
from gmpi_tpu_torch.ops.tiled_warp import required_bands, tiling
from gmpi_tpu_torch.ops.tiled_warp_adjoint import check_monotone, required_output_bands
from gmpi_tpu_torch.utils.device import resolve_device

PLAN_STEP_BYTES = 2 ** 30  # homography grids and intermediates alive in one planning group
_PLAN_FLOATS_PER_PIXEL = 24  # of one (pose, plane) pair: rays, grid, depth, coordinates, floors


def _round_up(x: int, m: int = 8) -> int:
    return ((x + m - 1) // m) * m


def _corner_rays(camera_cfg, fov_deg: float, img_h: int, img_w: int, device="cuda"):
    """Rays ``(ray_dir, eye, z_dir)`` on ``device`` from the 9 corner and
    centre poses of the truncated (yaw, pitch) range: the worst-case pose set
    of all static band planning."""
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
                                              given_pitches=pitches, device=device)
    return cam.generate_rays(cam.intrinsics_from_fov(fov_deg, img_h, img_w), c2w)


def required_spans(dhw: torch.Tensor, rays, img_h: int, img_w: int,
                   tile: Optional[Tuple[int, int]] = None) -> Tuple[Optional[int], ...]:
    """The spans, without margin, that the tiled warp and its adjoint need
    for every (pose, plane) pair of ``rays = (ray_dir [V, 3, H, W], eye [V,
    3], z_dir [V, 3])`` and ``dhw [L, 3]``: ``(band_y, band_x, adjoint rows,
    adjoint cols)``, the last two None where the warp is not monotone, for
    the tiles of ``tiled_warp.tiling`` (``tile`` in place of its warp tile).
    Measured on the rays' device, the pairs in groups under
    ``PLAN_STEP_BYTES``."""
    ray_dir, eye, z_dir = rays
    dev = ray_dir.device
    dhw = dhw.detach().to(dev, torch.float32)
    n_planes = dhw.shape[0]
    n_pairs = ray_dir.shape[0] * n_planes
    group = max(1, min(n_pairs, PLAN_STEP_BYTES // (_PLAN_FLOATS_PER_PIXEL * 4 * img_h * img_w)))
    tile, atile = tiling(img_h, img_w, tile)[:2]
    by = bx = pbr = pbc = 0
    monotone = True
    for i in range(0, n_pairs, group):
        pair = torch.arange(i, min(i + group, n_pairs), device=dev)
        pose, plane = pair // n_planes, pair % n_planes
        grid, _ = homography_grid(dhw[plane], eye[pose], ray_dir[pose], z_dir[pose])
        tex_shape = (pair.shape[0], 4, img_h, img_w)  # texture assumed image-sized
        by, bx = (max(a, b) for a, b in zip((by, bx), required_bands(tex_shape, grid, tile=tile)))
        monotone = monotone and check_monotone(tex_shape, grid)
        if monotone:
            pbr, pbc = (max(a, b) for a, b in zip(
                (pbr, pbc), required_output_bands(tex_shape, grid, tile=atile)))
        del grid
    return (by, bx, pbr, pbc) if monotone else (by, bx, None, None)


def estimate_bands(geom: PlaneGeometry, camera_cfg: poses_mod.SphereCameraConfig,
                   fov_deg: float, img_h: int, img_w: int, margin: float = 1.15,
                   tile: Optional[Tuple[int, int]] = None, device="cuda") -> Tuple[int, ...]:
    """Safe ``(band_y, band_x)`` for all poses within the truncation range,
    followed by the tiled adjoint's ``(rows, cols)`` output bands when the
    warp is monotone over that range (else the 2-tuple): the spans of
    :func:`required_spans` at the corner poses, widened by ``margin``,
    planned on ``device``."""
    dev = resolve_device(device)
    rays = _corner_rays(camera_cfg, fov_deg, img_h, img_w, device=dev)
    spans = required_spans(geom.dhw, rays, img_h, img_w, tile=tile)
    return tuple(_round_up(math.ceil(b * margin)) for b in spans if b is not None)


def bands_for_config(cfg, img_size: Optional[int] = None, n_planes: Optional[int] = None,
                     device="cuda") -> Optional[Tuple[int, ...]]:
    """Bands of :func:`estimate_bands` for an ``ExperimentConfig``, planned
    on ``device``, or None when the image is too small for tiling to pay
    off."""
    dev = resolve_device(device)
    img = img_size or cfg.hparams.img_size
    if img < 128:
        return None
    planes = dataclasses.replace(cfg.planes, n_planes=n_planes or cfg.planes.n_planes)
    geom = dataclasses.replace(cfg, planes=planes).plane_geometry(device=dev)
    return estimate_bands(geom, cfg.camera, cfg.fov_deg, img, img, device=dev)
