"""The plain MPI renderer: a per-pixel ``F.grid_sample`` of every plane into
its camera, then the front-to-back over-composite.

The semantics of the reference renderer (``homography_grid``, ``composite``
and the gather path of ``render_mpi`` in the port's ``core/renderer.py``,
here without bands, kernels or slabs): bilinear sampling with zeros padding
and ``align_corners=True``, weights ``alpha * cumprod(1 - alpha + 1e-10)``,
depth through ``1 / (1 / depth)`` as the reference orders it.  The grid and
the per-plane depth carry no gradient.  ``plane_chunk`` composites the
planes in slabs to bound memory; it changes nothing but the sum's grouping.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import precision

COMPOSITE_EPS = 1e-10


def homography_grid(dhw, eye_pos, ray_dir, z_dir) -> Tuple[torch.Tensor, torch.Tensor]:
    """UV grid ``[N, H, W, 2]`` and plane depth ``[N, 1, H, W]`` of (plane,
    camera) pairs: dhw/eye_pos/z_dir ``[N, 3]``, ray_dir ``[N, 3, H, W]``."""
    n, _, h, w = ray_dir.shape
    scale = (dhw[:, 0:1] - eye_pos[:, 2:3]).reshape(n, 1, 1) / ray_dir[:, 2]
    x = eye_pos[:, 0].reshape(n, 1, 1) + ray_dir[:, 0] * scale
    y = eye_pos[:, 1].reshape(n, 1, 1) + ray_dir[:, 1] * scale
    u = 2.0 * x / dhw[:, 2].reshape(n, 1, 1)
    v = 2.0 * y / dhw[:, 1].reshape(n, 1, 1)
    grid = torch.stack([u, v], dim=-1)
    dist2depth = torch.einsum("nchw,nc->nhw", ray_dir, z_dir)
    return grid, (scale * dist2depth).reshape(n, 1, h, w)


def render(rgba: torch.Tensor, dhw: torch.Tensor, ray_dir: torch.Tensor, eye_pos: torch.Tensor,
           z_dir: torch.Tensor, plane_chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rgba [V, L, 4, Th, Tw]`` (plane 0 nearest), dhw ``[L, 3]``, one
    camera per view -> ``(color [V, 3, H, W] in [0, 1], depth [V, 1, H, W])``."""
    v, n_l = rgba.shape[:2]
    h, w = ray_dir.shape[2:]
    chunk = plane_chunk or n_l
    rgba = precision.render_input(rgba.to(torch.float32))
    color = torch.zeros((v, 3, h, w), device=rgba.device)
    depth_out = torch.zeros((v, 1, h, w), device=rgba.device)
    trans = torch.ones((v, 1, h, w), device=rgba.device)
    for lo in range(0, n_l, chunk):
        hi = min(n_l, lo + chunk)
        m = hi - lo
        with torch.no_grad():
            grid, depth = homography_grid(
                dhw[lo:hi].float().repeat(v, 1),
                eye_pos.float().repeat_interleave(m, 0),
                ray_dir.float().repeat_interleave(m, 0),
                z_dir.float().repeat_interleave(m, 0))
            depth = 1.0 / (1.0 / depth)
        tex = rgba[:, lo:hi].reshape(v * m, 4, *rgba.shape[3:])
        sampled = F.grid_sample(tex, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=True).reshape(v, m, 4, h, w)
        alpha = sampled[:, :, 3:4]
        shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + COMPOSITE_EPS], dim=1)
        reach = trans[:, None] * torch.cumprod(shifted, dim=1)[:, :-1]
        weights = reach * alpha
        color = color + torch.sum(weights * sampled[:, :, :3], dim=1)
        depth_out = depth_out + torch.sum(weights * depth.reshape(v, m, 1, h, w), dim=1)
        trans = trans * torch.prod(1.0 - alpha + COMPOSITE_EPS, dim=1)
    return color, depth_out
