"""Exact scatter-free adjoint of the tile-banded warp, the "tiled splat"
(port of ``gmpi_tpu/ops/tiled_warp_adjoint.py``).

The backward of bilinear sampling with respect to the texture is a splat:
``d_tex[ty, tx] = sum_p hat(fx_p - tx) hat(fy_p - ty) cot_p``.  Autograd
expresses it as a scatter-add of per-tile patches.  This module computes the
same sum as dense algebra, with the roles of texture and image swapped
relative to the forward pass: for each *texture* tile the contributing output
pixels lie in a bounded output-space band (the warp is projective and, for
this camera range, monotone along both image axes).  Per texture tile:

1. slice the output-pixel band of ``cot`` / ``fx`` / ``fy``;
2. build hat matrices against the tile's texel grid:
   ``M_y[p, ty] = hat(fy_p - ty)``, ``M_x[p, tx] = hat(fx_p - tx)``;
3. accumulate with one matrix product:
   ``d_tile[(ty, c), tx] = (M_y (x) cot)[p, (ty, c)]^T @ M_x[p, tx]``.

Out-of-image padding of the band carries sentinel coordinates, so padded
pixels contribute exactly zero.  The band *starts* come from ``searchsorted``
over per-row and per-column coordinate extrema (monotone for non-flipping
homographies, see :func:`check_monotone`); band *sizes* are static, estimated
per camera distribution like the forward bands.  It reaches no hand-written
kernel, here as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gmpi_tpu_torch.ops.grid_sample import _unnormalize

_SENTINEL = -1e6


def _coords(tex_shape, grid, align_corners):
    _, _, th, tw = tex_shape
    return (_unnormalize(grid[..., 0], tw, align_corners),  # fx [N, Ho, Wo]
            _unnormalize(grid[..., 1], th, align_corners))


def check_monotone(tex_shape, grid: torch.Tensor, align_corners: bool = True) -> bool:
    """The band search assumes fy extrema are non-decreasing along image rows
    and fx extrema along image columns (no flips, no rotations beyond 90
    degrees)."""
    fx, fy = _coords(tex_shape, grid, align_corners)
    fy_max = fy.amax(dim=2)  # [N, Ho]
    fx_max = fx.amax(dim=1)  # [N, Wo]
    ok_y = bool(torch.all(torch.diff(fy_max, dim=1) >= -1e-3))
    ok_x = bool(torch.all(torch.diff(fx_max, dim=1) >= -1e-3))
    return ok_y and ok_x


def required_output_bands(tex_shape, grid: torch.Tensor, align_corners: bool = True,
                          tile: Tuple[int, int] = (8, 128)) -> Tuple[int, int]:
    """Smallest ``(rows, cols)`` output band covering every texture tile's
    contributing pixels for this grid (host helper, mirrors
    ``tiled_warp.required_bands``)."""
    n, _, th, tw = tex_shape
    fx, fy = (f.detach().cpu().numpy() for f in _coords(tex_shape, grid, align_corners))
    tr, tc = tile
    max_rows = max_cols = 1
    fy_max, fy_min = fy.max(axis=2), fy.min(axis=2)
    fx_max, fx_min = fx.max(axis=1), fx.min(axis=1)
    for ni in range(n):
        for t0 in range(0, th, tr):
            rows = np.where((fy_max[ni] >= t0 - 1) & (fy_min[ni] <= t0 + tr + 1))[0]
            if rows.size:
                max_rows = max(max_rows, rows[-1] - rows[0] + 1)
        for t0 in range(0, tw, tc):
            cols = np.where((fx_max[ni] >= t0 - 1) & (fx_min[ni] <= t0 + tc + 1))[0]
            if cols.size:
                max_cols = max(max_cols, cols[-1] - cols[0] + 1)
    return int(max_rows) + 2, int(max_cols) + 2


def grid_sample_tiled_adjoint(cot: torch.Tensor, grid: torch.Tensor,
                              tex_shape: Tuple[int, int, int, int], band_rows: int,
                              band_cols: int, tile: Tuple[int, int] = (8, 128),
                              align_corners: bool = True, row_scan: bool = False,
                              rows_per_step: int = 1, step_bytes: Optional[int] = None
                              ) -> torch.Tensor:
    """``d_tex [N, C, Th, Tw]``, the adjoint warp of ``cot [N, C, Ho, Wo]``
    (the cotangent of the warped output) for the forward sampling grid ``grid
    [N, Ho, Wo, 2]``, with no scatter.

    ``row_scan`` / ``rows_per_step`` mirror the forward: texture tile rows are
    processed in groups in a loop, to balance live memory against per-step
    overhead.  ``step_bytes`` also bounds the planes of a step: they go
    through in groups whose hats and mixed products stay under it (at 96
    planes of 1024^2, one plane's tile row of them takes ~1.6 GB).  Planes
    are independent, so the grouping changes no value."""
    n, c, th, tw = tex_shape
    tr, tc = tile
    if th % tr or tw % tc:
        raise ValueError(f"texture {th}x{tw} is not a multiple of the tile {tr}x{tc}")
    n_ty, n_tx = th // tr, tw // tc
    g = n_ty
    if row_scan:
        g = max(1, min(rows_per_step, n_ty))
        while n_ty % g:
            g -= 1
    n_step = n
    if step_bytes is not None:
        # fx, fy, cot bands, both hats and the mixed product of a plane's g tile rows
        plane_bytes = 4 * g * n_tx * band_rows * band_cols * (2 + c + tr + tc + tr * c)
        n_step = max(1, min(n, step_bytes // plane_bytes))
    return torch.cat([_adjoint_planes(cot[i:i + n_step], grid[i:i + n_step],
                                      (min(n_step, n - i), c, th, tw), band_rows, band_cols,
                                      tile, align_corners, g)
                      for i in range(0, n, n_step)])


def _adjoint_planes(cot, grid, tex_shape, band_rows, band_cols, tile, align_corners, g):
    """:func:`grid_sample_tiled_adjoint` of a group of planes, ``g`` tile rows
    a step."""
    n, c, th, tw = tex_shape
    _, _, ho, wo = cot.shape
    tr, tc = tile
    n_ty, n_tx = th // tr, tw // tc
    dev = cot.device
    fx, fy = _coords(tex_shape, grid, align_corners)

    # pad output space; sentinel coordinates make padded pixels contribute zero
    pad_r, pad_c = band_rows, band_cols
    cot_pad = F.pad(cot, (pad_c, pad_c, pad_r, pad_r))
    fx_pad = F.pad(fx, (pad_c, pad_c, pad_r, pad_r), value=_SENTINEL)
    fy_pad = F.pad(fy, (pad_c, pad_c, pad_r, pad_r), value=_SENTINEL)

    # band starts from monotone extrema, in padded coordinates
    ty0 = torch.arange(n_ty, device=dev, dtype=torch.float32) * tr  # texel row of each tile row
    tx0 = torch.arange(n_tx, device=dev, dtype=torch.float32) * tc

    def starts(ext, t0s, pad, padded_len, band):
        # first unpadded index whose max coordinate reaches t0 - 1, shifted
        # into padded coordinates and clamped so that the band slice fits
        idx = torch.searchsorted(ext.contiguous(), (t0s - 1.0).expand(n, -1).contiguous())
        return torch.clamp(idx + pad, 0, padded_len - band)

    py_lo = starts(fy.amax(dim=2), ty0, pad_r, ho + 2 * pad_r, band_rows)  # [N, n_ty]
    px_lo = starts(fx.amax(dim=1), tx0, pad_c, wo + 2 * pad_c, band_cols)  # [N, n_tx]

    n_idx = torch.arange(n, device=dev).reshape(n, 1, 1, 1, 1)
    cols = (px_lo[:, :, None] + torch.arange(band_cols, device=dev))[:, None, :, None, :]
    p = band_rows * band_cols
    out = []
    for r0 in range(0, n_ty, g):
        rows = (py_lo[:, r0:r0 + g, None] + torch.arange(band_rows, device=dev)
                )[:, :, None, :, None]
        # bands of this group's tiles: [N, g, n_tx, band_rows, band_cols(, C)]
        fx_b = fx_pad[n_idx, rows, cols].reshape(n, g, n_tx, p, 1)
        fy_b = fy_pad[n_idx, rows, cols].reshape(n, g, n_tx, p, 1)
        cot_b = cot_pad.permute(0, 2, 3, 1)[n_idx, rows, cols].reshape(n, g, n_tx, p, 1, c)
        tys = (ty0[r0:r0 + g, None] + torch.arange(tr, device=dev)).reshape(1, g, 1, 1, tr)
        txs = (tx0[:, None] + torch.arange(tc, device=dev)).reshape(1, 1, n_tx, 1, tc)
        m_y = torch.clamp(1.0 - torch.abs(fy_b - tys), min=0.0)  # [N, g, n_tx, P, tr]
        m_x = torch.clamp(1.0 - torch.abs(fx_b - txs), min=0.0)  # [N, g, n_tx, P, tc]
        wmat = (m_y[..., None] * cot_b).reshape(n, g, n_tx, p, tr * c)
        d = torch.matmul(wmat.transpose(-1, -2), m_x)  # [N, g, n_tx, tr*C, tc]
        out.append(d.reshape(n, g, n_tx, tr, c, tc))
    d_all = out[0] if len(out) == 1 else torch.cat(out, dim=1)  # [N, n_ty, n_tx, tr, C, tc]
    return d_all.permute(0, 4, 1, 3, 2, 5).reshape(n, c, th, tw)
