"""Image utilities (port of the training-time part of ``gmpi_tpu/utils/img.py``):
Sobel gradients and the edge-aware depth smoothness loss."""

from __future__ import annotations

import torch
import torch.nn.functional as F

SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def filter2d_reflect(x: torch.Tensor, kernel) -> torch.Tensor:
    """Depthwise 2D cross-correlation of ``[B, C, H, W]`` with reflect padding."""
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    c = x.shape[1]
    kh, kw = k.shape
    xp = F.pad(x, [kw // 2, kw // 2, kh // 2, kh // 2], mode="reflect")
    return F.conv2d(xp, k[None, None].expand(c, 1, kh, kw), groups=c)


def image_gradient(img: torch.Tensor) -> torch.Tensor:
    """Mean of |Sobel_x| and |Sobel_y|."""
    return (filter2d_reflect(img, SOBEL_X).abs() + filter2d_reflect(img, SOBEL_Y).abs()) / 2.0


def edge_aware_smooth_loss(rgb: torch.Tensor, depth: torch.Tensor, e_min: float = 0.05,
                           g_min: float = 0.01) -> torch.Tensor:
    """Edge-aware depth smoothness (Sec 3.4 of arXiv 2004.11364): penalize
    the depth gradient of ``depth [B, 1, H, W]`` except at edges of ``rgb
    [B, 3, H, W]`` (gradient above ``e_min`` of its maximum), with ``g_min``
    of the largest depth gradient as slack."""
    rgb_grad = image_gradient(rgb).mean(dim=1, keepdim=True)
    depth_grad = image_gradient(depth)
    max_rgb = rgb_grad.amax(dim=(2, 3), keepdim=True)
    max_depth = depth_grad.amax(dim=(2, 3), keepdim=True)
    not_edge = (rgb_grad <= e_min * max_rgb).to(rgb.dtype)
    excess = torch.clamp(depth_grad - g_min * max_depth, min=0.0)
    return torch.sum(excess * not_edge) / (torch.sum(not_edge) + 1e-8)
