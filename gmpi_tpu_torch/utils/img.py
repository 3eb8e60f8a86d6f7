"""Image utilities (port of ``gmpi_tpu/utils/img.py``): range conversions,
Sobel gradients, the edge-aware depth smoothness loss and colour ramps."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def to_unit_range(x):
    """[-1, 1] -> [0, 1]."""
    return (x + 1.0) / 2.0


def to_sym_range(x):
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


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


def color_ramp(c0, c1, n: int) -> np.ndarray:
    """``n`` RGB colours interpolating ``c0`` -> ``c1`` linearly, ``[n, 3]``
    float32 in [0, 1] (the reference's ``utils/color_grad.py``)."""
    c0 = np.asarray(c0, np.float32).reshape(1, 3)
    c1 = np.asarray(c1, np.float32).reshape(1, 3)
    t = np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(-1, 1)
    return c0 * (1 - t) + c1 * t


def hex_to_rgb(h: str) -> np.ndarray:
    """``"#rrggbb"`` -> float32 RGB in [0, 1]."""
    h = h.lstrip("#")
    return np.array([int(h[i:i + 2], 16) / 255.0 for i in (0, 2, 4)], np.float32)
