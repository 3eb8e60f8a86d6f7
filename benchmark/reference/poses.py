"""Camera poses on a sphere (port of ``gmpi_tpu/core/poses.py``).

Cameras sit on a sphere of radius ``r`` centred at ``(0, 0, sphere_center_z)``
in the world frame (+X right, +Y down, +Z forward) and look at its centre.
Randomness comes from an explicit ``torch.Generator`` (drawn on the CPU, then
moved to ``device``), in place of ``jax.random`` keys: the two streams differ,
so parity checks pass ``given_yaws`` / ``given_pitches``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from torch import device as resolve_device


class SphereCameraConfig(NamedTuple):
    sphere_center_z: float
    sphere_r: float
    yaw_mean: float
    yaw_std: float
    pitch_mean: float
    pitch_std: float
    n_truncated_stds: float = 2.0
    sample_method: str = "truncated_gaussian"  # uniform | gaussian | truncated_gaussian


# sphere frame (+X back, +Y right, +Z up) -> world frame: Rx(90°) @ Rz(-90°)
_SPHERE_TO_WORLD_ROT = np.array(
    [[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]], dtype=np.float64)


def sphere_to_world_matrix(sphere_center: np.ndarray) -> np.ndarray:
    """4x4 sphere-frame -> world-frame transform ``translate(center) @ rot``."""
    m = np.eye(4)
    m[:3, :3] = _SPHERE_TO_WORLD_ROT
    t = np.eye(4)
    t[:3, 3] = np.asarray(sphere_center, dtype=np.float64).reshape(-1)
    return t @ m


def truncated_normal(generator: Optional[torch.Generator], shape: Tuple[int, ...],
                     mean, std, n_stds: float) -> torch.Tensor:
    """Resample-4 truncated normal: draw 4 candidates per element, keep the
    first in range, clip otherwise.  CPU float32."""
    cand = torch.randn(shape + (4,), generator=generator, dtype=torch.float32) * std + mean
    lo = mean - n_stds * std
    hi = mean + n_stds * std
    valid = ((cand > lo) & (cand < hi)).to(torch.int32)
    idx = torch.argmax(valid, dim=-1, keepdim=True)  # first in-range candidate
    out = torch.gather(cand, -1, idx)[..., 0]
    return torch.clamp(out, lo, hi)


def sample_yaw_pitch(generator: Optional[torch.Generator], n: int, cfg: SphereCameraConfig,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """``[n, 1]`` yaws and pitches drawn per ``cfg.sample_method``."""
    dev = resolve_device(device)
    if cfg.sample_method == "uniform":
        span = 2 * cfg.n_truncated_stds
        yaws = (torch.rand((n, 1), generator=generator) - 0.5) * span * cfg.yaw_std + cfg.yaw_mean
        pitches = (torch.rand((n, 1), generator=generator) - 0.5) * span * cfg.pitch_std + cfg.pitch_mean
    elif cfg.sample_method in ("normal", "gaussian"):
        yaws = torch.randn((n, 1), generator=generator) * cfg.yaw_std + cfg.yaw_mean
        pitches = torch.randn((n, 1), generator=generator) * cfg.pitch_std + cfg.pitch_mean
    elif cfg.sample_method == "truncated_gaussian":
        yaws = truncated_normal(generator, (n, 1), cfg.yaw_mean, cfg.yaw_std, cfg.n_truncated_stds)
        pitches = truncated_normal(generator, (n, 1), cfg.pitch_mean, cfg.pitch_std, cfg.n_truncated_stds)
    else:
        raise ValueError(cfg.sample_method)
    return yaws.to(dev, torch.float32), pitches.to(dev, torch.float32)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def c2w_from_yaw_pitch(yaws: torch.Tensor, pitches: torch.Tensor,
                       sphere_center_z: float, sphere_r: float) -> torch.Tensor:
    """Camera-to-world ``[N, 4, 4]`` for cameras on the sphere looking at its
    centre (position on the sphere, look-at, sphere->world change of basis)."""
    yaws = yaws.reshape(-1).to(torch.float32)
    pitches = pitches.reshape(-1).to(torch.float32)
    cp = torch.abs(torch.cos(pitches))
    pos = torch.stack([sphere_r * cp * torch.cos(yaws), sphere_r * cp * torch.sin(yaws),
                       sphere_r * torch.sin(pitches)], dim=-1)
    fwd = _normalize(-pos)
    down0 = torch.tensor([0.0, 0.0, -1.0], dtype=pos.dtype, device=pos.device).expand_as(fwd)
    right = _normalize(torch.linalg.cross(down0, fwd, dim=-1))
    down = _normalize(torch.linalg.cross(fwd, right, dim=-1))
    n = pos.shape[0]
    c2s = torch.zeros((n, 4, 4), dtype=pos.dtype, device=pos.device)
    c2s[:, :3, :3] = torch.stack([right, down, fwd], dim=-1)
    c2s[:, :3, 3] = pos
    c2s[:, 3, 3] = 1.0
    s2w = torch.as_tensor(sphere_to_world_matrix(np.array([0.0, 0.0, sphere_center_z])),
                          dtype=pos.dtype, device=pos.device)
    return torch.matmul(s2w, c2s)


def sample_sphere_poses(generator: Optional[torch.Generator], n: int, cfg: SphereCameraConfig,
                        given_yaws=None, given_pitches=None, device="cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random (or given-angle) poses: ``(c2w [N,4,4], yaws [N,1], pitches [N,1])``."""
    dev = resolve_device(device)
    if given_yaws is None:
        yaws, pitches = sample_yaw_pitch(generator, n, cfg, device=dev)
    else:
        yaws = torch.as_tensor(given_yaws, dtype=torch.float32, device=dev).reshape(n, 1)
        pitches = torch.as_tensor(given_pitches, dtype=torch.float32, device=dev).reshape(n, 1)
    return c2w_from_yaw_pitch(yaws, pitches, cfg.sphere_center_z, cfg.sphere_r), yaws, pitches


def linspace_sphere_poses(n: int, cfg: SphereCameraConfig, horizontal: bool = True,
                          device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic sweep over ±n_truncated_stds around the mean."""
    dev = resolve_device(device)
    sweep = torch.linspace(-cfg.n_truncated_stds, cfg.n_truncated_stds, n,
                           device=dev).reshape(n, 1)
    if horizontal:
        yaws = sweep * cfg.yaw_std + cfg.yaw_mean
        pitches = torch.full((n, 1), cfg.pitch_mean, device=dev)
    else:
        yaws = torch.full((n, 1), cfg.yaw_mean, device=dev)
        pitches = sweep * cfg.pitch_std + cfg.pitch_mean
    return c2w_from_yaw_pitch(yaws, pitches, cfg.sphere_center_z, cfg.sphere_r), yaws, pitches


def yaw_pitch_from_w2c(w2c: torch.Tensor, sphere_center: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover ``(yaw, pitch)`` ``[..., 1]`` from world-to-camera matrices
    ``[..., 4, 4]`` (the inverse of the construction; ``cam_utils.py:1005-1050``
    semantics).  The eye in world coordinates is ``-R^T t``; moved into the
    sphere frame, the spherical parameterization inverts to the angles."""
    rot = w2c[..., :3, :3]
    t = w2c[..., :3, 3]
    eye_world = -torch.einsum("...ji,...j->...i", rot, t)
    rel = eye_world - torch.as_tensor(sphere_center, dtype=w2c.dtype, device=w2c.device)
    # world -> sphere frame: the inverse (transpose) of the sphere-to-world rotation
    rot_ws = torch.as_tensor(_SPHERE_TO_WORLD_ROT.T, dtype=w2c.dtype, device=w2c.device)
    p = torch.einsum("ij,...j->...i", rot_ws, rel)
    r = torch.linalg.vector_norm(p, dim=-1)
    pitch = torch.arcsin(torch.clamp(p[..., 2] / r, -1.0, 1.0))
    yaw = torch.atan2(p[..., 1], p[..., 0])
    return yaw[..., None], pitch[..., None]
