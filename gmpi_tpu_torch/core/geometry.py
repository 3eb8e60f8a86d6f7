"""MPI plane geometry (port of ``gmpi_tpu/core/geometry.py``).

The depth schedule and the spatial-extent fit are host-side numpy, done once
when a model is built; the result, ``PlaneGeometry.dhw``, is a float32 tensor
on the caller's device and feeds the renderer and the generator's
depth-conditioning heads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses as poses_mod
from gmpi_tpu_torch.utils.device import resolve_device


def sample_distance(dmin: float, dmax: float, num: int, method: str) -> np.ndarray:
    """Plane depths front-to-back; ``inverse`` is uniform in disparity."""
    assert 0 < dmin <= dmax
    assert 1 <= num < 9999
    if method == "uniform":
        radii = np.linspace(dmin, dmax, num=num)
    elif method == "log-uniform":
        radii = np.exp(np.linspace(np.log(dmin), np.log(dmax), num=num))
    elif method == "sqrt":
        radii = np.linspace(dmin**0.5, dmax**0.5, num=num) ** 2
    elif method == "squared":
        radii = np.sqrt(np.linspace(dmin**2, dmax**2, num=num))
    elif method == "inverse":
        radii = (1.0 / np.linspace(1.0 / dmax, 1.0 / dmin, num=num))[::-1]
    else:
        raise ValueError(method)
    return np.asarray(radii, dtype=np.float32)


def _deterministic_c2w(yaw, pitch, sphere_center_z: float, sphere_r: float) -> np.ndarray:
    """float64 look-at c2w for fixed angles (host twin of ``c2w_from_yaw_pitch``)."""
    yaw = np.asarray(yaw, dtype=np.float64).reshape(-1)
    pitch = np.asarray(pitch, dtype=np.float64).reshape(-1)
    cp = np.abs(np.cos(pitch))
    pos = np.stack([sphere_r * cp * np.cos(yaw), sphere_r * cp * np.sin(yaw),
                    sphere_r * np.sin(pitch)], axis=-1)
    fwd = -pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    right = np.cross(np.broadcast_to(np.array([0.0, 0.0, -1.0]), fwd.shape), fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    down /= np.linalg.norm(down, axis=-1, keepdims=True)
    c2s = np.tile(np.eye(4), (pos.shape[0], 1, 1))
    c2s[:, :3, :3] = np.stack([right, down, fwd], axis=-1)
    c2s[:, :3, 3] = pos
    s2w = poses_mod.sphere_to_world_matrix(np.array([0.0, 0.0, sphere_center_z]))
    return np.einsum("ij,njk->nik", s2w, c2s)


def _frustum_plane_bounds(c2w: np.ndarray, border_dirs_cam: np.ndarray, z_plane: float):
    """Per-camera (min_x, max_x, min_y, max_y) of the corner rays on ``z=z_plane``."""
    rot = c2w[:, :3, :3]
    eye = c2w[:, :3, 3]
    dirs = np.einsum("nij,jk->nik", rot, border_dirs_cam)
    scale = (z_plane - eye[:, 2:3]) / dirs[:, 2, :]
    x = eye[:, 0:1] + dirs[:, 0, :] * scale
    y = eye[:, 1:2] + dirs[:, 1, :] * scale
    return x.min(axis=1), x.max(axis=1), y.min(axis=1), y.max(axis=1)


def fit_plane_dhws(*, fov_deg: float, sphere_center_z: float, sphere_r: float,
                   yaw_min: float, yaw_max: float, pitch_min: float, pitch_max: float,
                   plane_zs: np.ndarray, enlarge_factor: float = 1.0, confined: bool = False,
                   n_sweep: int = 100) -> Tuple[np.ndarray, float]:
    """Plane extents such that every camera of the truncated pose range sees
    every plane: ``(dhws [L, 3] float64, tex_expand_ratio)``, front-to-back."""
    plane_zs = np.asarray(plane_zs, dtype=np.float64)
    border = cam.border_ray_dirs_cam(cam.intrinsics_from_fov(fov_deg, 4, 4))
    yy, pp = np.meshgrid(np.linspace(yaw_min, yaw_max, n_sweep),
                         np.linspace(pitch_min, pitch_max, n_sweep), indexing="ij")
    all_yaws = np.concatenate([yy.reshape(-1), [(yaw_min + yaw_max) / 2.0]])
    all_pitches = np.concatenate([pp.reshape(-1), [(pitch_min + pitch_max) / 2.0]])
    c2w = _deterministic_c2w(all_yaws, all_pitches, sphere_center_z, sphere_r)
    z_last = float(plane_zs[-1])
    min_x, max_x, min_y, max_y = _frustum_plane_bounds(c2w, border, z_last)

    # the mid-angle pose (last entry) defines the base / confined sizes
    base_spatial_size = min(max_x[-1] - min_x[-1], max_y[-1] - min_y[-1])
    confined_h = 2.0 * max(abs(min_y[-1]), abs(max_y[-1]))
    confined_w = 2.0 * max(abs(min_x[-1]), abs(max_x[-1]))
    bmin_x, bmax_x = min_x.min(), max_x.max()
    bmin_y, bmax_y = min_y.min(), max_y.max()
    bound = max(abs(bmin_x), abs(bmax_x), abs(bmin_y), abs(bmax_y))
    if bound > 5.0:
        raise ValueError(f"MPI plane extent {bound:.3f} > 5.0: camera pose range too large "
                         "for an MPI; reduce yaw/pitch stddev or n_truncated_stds")
    spatial_h = 2.0 * max(abs(bmin_y), abs(bmax_y)) * enlarge_factor
    spatial_w = 2.0 * max(abs(bmin_x), abs(bmax_x)) * enlarge_factor

    dhws = [[z_last, spatial_h, spatial_w]]
    for i in range(len(plane_zs) - 2, -1, -1):
        z = float(plane_zs[i])
        if confined:
            dhws.append([z, confined_h, confined_w])
        else:
            dhws.append([z, confined_h * z / z_last, confined_w * z / z_last])
    dhws = np.asarray(dhws[::-1], dtype=np.float64)
    return dhws, float(np.max(dhws[:, 1:] / base_spatial_size))


class PlaneGeometry(NamedTuple):
    """Per-plane (depth, spatial_h, spatial_w), ``dhw [L, 3]`` float32 on the
    model's device, front (nearest) to back; ``min_d``/``max_d`` bound the
    depth range of the normalized conditioning coordinates."""

    dhw: torch.Tensor
    min_d: float
    max_d: float

    @property
    def n_planes(self) -> int:
        return self.dhw.shape[0]


def build_plane_geometry(*, n_planes: int, min_d: float, max_d: float,
                         distance_sample_method: str = "inverse", fov_deg: float,
                         sphere_center_z: float, sphere_r: float, yaw_mean: float,
                         yaw_std: float, pitch_mean: float, pitch_std: float,
                         n_truncated_stds: float = 2.0, enlarge_factor: float = 1.001,
                         confined: bool = True, device="cuda") -> PlaneGeometry:
    """Depth schedule + clamp + extent fit, as one call."""
    dev = resolve_device(device)
    zs = np.clip(sample_distance(min_d, max_d, n_planes, distance_sample_method), min_d, max_d)
    dhws, _ = fit_plane_dhws(
        fov_deg=fov_deg, sphere_center_z=sphere_center_z, sphere_r=sphere_r,
        yaw_min=yaw_mean - n_truncated_stds * yaw_std, yaw_max=yaw_mean + n_truncated_stds * yaw_std,
        pitch_min=pitch_mean - n_truncated_stds * pitch_std,
        pitch_max=pitch_mean + n_truncated_stds * pitch_std,
        plane_zs=zs.astype(np.float64), enlarge_factor=enlarge_factor, confined=confined)
    return PlaneGeometry(dhw=torch.as_tensor(dhws, dtype=torch.float32, device=dev),
                         min_d=min_d, max_d=max_d)


def plane_xyz_grid(geom: PlaneGeometry, tex_h: int, tex_w: int) -> torch.Tensor:
    """Texel 3D coordinates ``[L, H, W, 3]``: x/y = linspace(-1, 1) times half
    the plane's extent, z = plane depth."""
    dhw = geom.dhw
    n_l = dhw.shape[0]
    dev = dhw.device
    z = dhw[:, 0].reshape(n_l, 1, 1).expand(n_l, tex_h, tex_w)
    col = torch.linspace(-1.0, 1.0, tex_w, device=dev)
    row = torch.linspace(-1.0, 1.0, tex_h, device=dev)
    x = (col[None, None, :] * (dhw[:, 2] / 2.0).reshape(n_l, 1, 1)).expand(n_l, tex_h, tex_w)
    y = (row[None, :, None] * (dhw[:, 1] / 2.0).reshape(n_l, 1, 1)).expand(n_l, tex_h, tex_w)
    return torch.stack([x, y, z], dim=-1).to(torch.float32)


def normalize_xyz(geom: PlaneGeometry, xyz: torch.Tensor, value_range: str = "01") -> torch.Tensor:
    """Normalize to [0,1]^3 (or [-1,1]^3) by the last plane's extent and the
    depth range."""
    last_h, last_w = geom.dhw[-1, 1], geom.dhw[-1, 2]
    min_d = torch.tensor(geom.min_d, dtype=torch.float32, device=xyz.device)
    max_d = torch.tensor(geom.max_d, dtype=torch.float32, device=xyz.device)
    min_xyz = torch.stack([-last_w / 2.0, -last_h / 2.0, min_d])
    max_xyz = torch.stack([last_w / 2.0, last_h / 2.0, max_d])
    out = (xyz - min_xyz) / (max_xyz - min_xyz)
    if value_range == "-11":
        out = 2.0 * out - 1.0
    elif value_range != "01":
        raise ValueError(value_range)
    return out


def multi_res_xyz(geom: PlaneGeometry, tex_size: int, normalized: bool = True,
                  value_range: str = "01", ztype: str = "depth") -> Dict[int, torch.Tensor]:
    """res -> ``[L, res, res, 3]`` for every synthesis resolution 4..tex_size,
    on the device of ``geom.dhw``; ``ztype="disparity"`` conditions on 1/z."""
    assert tex_size >= 4 and (tex_size & (tex_size - 1)) == 0
    assert ztype in ("depth", "disparity"), ztype
    out = {}
    res = 4
    while res <= tex_size:
        xyz = plane_xyz_grid(geom, res, res)
        if ztype == "disparity":
            xyz = torch.cat([xyz[..., :2], 1.0 / xyz[..., 2:]], dim=-1)
        out[res] = normalize_xyz(geom, xyz, value_range) if normalized else xyz
        res *= 2
    return out


def plane_interp_weights(min_d: float, max_d: float, n_src: int, n_tgt: int,
                         method: str = "inverse", device="cuda") -> torch.Tensor:
    """Linear weights ``[n_tgt, n_src + 2]`` that re-sample ``n_src`` trained
    planes to ``n_tgt`` eval planes by depth, with sentinel columns for
    targets out of range (the reference's ``MPIRenderer.get_xyz_interpolate_ws``,
    ``mpi_renderer.py:209-250``); the ``learnable_param`` embedding's
    ``z_interpolation_ws``."""
    src = np.concatenate([[-999999.0], sample_distance(min_d, max_d, n_src, method),
                          [999999.0]])
    tgt = sample_distance(min_d, max_d, n_tgt, method)
    ws = np.zeros((n_tgt, n_src + 2), dtype=np.float32)
    for i, d in enumerate(tgt):
        j = int(np.searchsorted(src, d, side="right") - 1)
        j = min(max(j, 0), n_src)
        span = src[j + 1] - src[j]
        ws[i, j] = (src[j + 1] - d) / (span + 1e-8)
        ws[i, j + 1] = (d - src[j]) / (span + 1e-8)
    return torch.from_numpy(ws).to(resolve_device(device))
