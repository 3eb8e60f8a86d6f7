"""Bilinear grid sampling with ``F.grid_sample`` semantics (port of
``gmpi_tpu/ops/grid_sample.py``).

The JAX package writes this sampler out in ``jnp`` (one window gather per
pixel) because it has no library call for it; it reaches no hand-written
kernel there.  Here the library call exists, so :func:`grid_sample_bilinear`
wraps it.  :func:`_unnormalize` is the coordinate convention that the tiled
warp and its adjoint share with it:

* ``align_corners=True``:  ``pix = (g + 1) / 2 * (size - 1)``;
* ``align_corners=False``: ``pix = ((g + 1) * size - 1) / 2``;
* ``padding_mode="zeros"``: taps outside ``[0, size - 1]`` contribute zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(g: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def grid_sample_bilinear(tex: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool = True) -> torch.Tensor:
    """Sample ``tex [N, C, H, W]`` at ``grid [N, Ho, Wo, 2]`` (last dim (x, y)
    in [-1, 1]), bilinear with zeros padding: ``[N, C, Ho, Wo]``."""
    return F.grid_sample(tex, grid.to(tex.dtype), mode="bilinear", padding_mode="zeros",
                         align_corners=align_corners)
