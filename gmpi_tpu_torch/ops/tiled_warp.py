"""Tile-banded warp: bilinear grid sampling as dense algebra (port of
``gmpi_tpu/ops/tiled_warp.py``).

The formulation exploits the smoothness of homography warps: within an output
tile of ``tile_r x tile_c`` pixels the source coordinates span a bounded
texture band.  Per tile:

1. slice one contiguous texture patch ``[B_x, B_y * C]`` (the patch gather:
   ``patch_backend="torch"`` is one advanced index, ``"cuda"`` the
   hand-written kernel of ``ops/patch_gather.py``);
2. build bilinear *hat* weights against the patch grid,
   ``hat_x[p, j] = relu(1 - |tx_p - (x_lo + j)|)`` (two nonzeros per row, and
   exactly zero for out-of-patch taps, which reproduces
   ``padding_mode="zeros"`` on the zero-padded texture);
3. interpolate with two contractions: ``M[p, (y, c)] = hat_x[p, :] @
   patch[:, (y, c)]``, then ``out[p, c] = sum_y hat_y[p, y] M[p, y, c]``.

``sum_y hat_y (sum_x hat_x T)`` is exactly separable bilinear interpolation,
so results match ``grid_sample_bilinear`` to fp32 reassociation.  The two
contractions are plain matrix products outside any hand-written kernel, here
as in the JAX package; callers on a CUDA device keep TF32 off for them
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).

Band sizes are static and must cover every tile's coordinate span;
:func:`required_bands` measures the true spans of a grid, :func:`bands_cover`
checks a configuration at run time, and ``check=True`` NaN-poisons the output
of a render whose poses leave the planned bands.

This is a workaround for hardware whose per-pixel gathers are slow.  A CUDA
card gathers well, so here the path exists for parity with the JAX package
and as the home of the patch-gather kernel, not because it is the fast way to
sample.

The port does not round the patch starts down to tile boundaries on its
kernel backend (the JAX package does on its Pallas backend, and widens the
bands for it): the CUDA kernel copies from any offset, so both backends read
the same patches and give the same values bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from gmpi_tpu_torch.ops.grid_sample import _unnormalize
from gmpi_tpu_torch.ops.patch_gather import gather_patches, gather_patches_ref

PATCH_BACKENDS = ("torch", "cuda")


def _tile_coords(tex_shape, grid, align_corners, tile_r, tile_c):
    """Texel coordinates of ``grid`` by output tile:
    ``(fx_t, fy_t [N, nty, ntx, tile_r, tile_c], nty, ntx)``."""
    n, _, h, w = tex_shape
    _, ho, wo, _ = grid.shape
    if ho % tile_r or wo % tile_c:
        raise ValueError(f"output {ho}x{wo} is not a multiple of the tile {tile_r}x{tile_c}")
    fx = _unnormalize(grid[..., 0], w, align_corners)  # [N, Ho, Wo]
    fy = _unnormalize(grid[..., 1], h, align_corners)
    nty, ntx = ho // tile_r, wo // tile_c
    fx_t = fx.reshape(n, nty, tile_r, ntx, tile_c).permute(0, 1, 3, 2, 4)
    fy_t = fy.reshape(n, nty, tile_r, ntx, tile_c).permute(0, 1, 3, 2, 4)
    return fx_t, fy_t, nty, ntx


def _max_span(f: torch.Tensor) -> torch.Tensor:
    """Largest per-tile span of ``floor(f)`` plus 3: the band origin is
    ``floor_min - 1`` and the highest tap ``floor_max + 1``."""
    f0 = torch.floor(f)
    return torch.max(f0.amax(dim=(3, 4)) - f0.amin(dim=(3, 4))) + 3


def required_bands(tex_shape: Tuple[int, int, int, int], grid: torch.Tensor,
                   align_corners: bool = True, tile: Tuple[int, int] = (8, 128)
                   ) -> Tuple[int, int]:
    """Smallest ``(B_y, B_x)`` covering every tile of this grid (host helper)."""
    fx_t, fy_t, _, _ = _tile_coords(tex_shape, grid, align_corners, *tile)
    return int(_max_span(fy_t)), int(_max_span(fx_t))


def bands_cover(tex_shape: Tuple[int, int, int, int], grid: torch.Tensor, band_y: int,
                band_x: int, align_corners: bool = True, tile: Tuple[int, int] = (8, 128)
                ) -> torch.Tensor:
    """0-dim bool tensor: True iff every tile's source span fits the static
    bands.  A few reductions on the grid's device, no host synchronization."""
    fx_t, fy_t, _, _ = _tile_coords(tex_shape, grid, align_corners, *tile)
    return (_max_span(fy_t) <= band_y) & (_max_span(fx_t) <= band_x)


def _hat(rel: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``relu(1 - |rel - taps|)``: ``rel [..., P, 1]`` against ``taps [B]``.
    Without a gradient to record it is built in one buffer, in place: at
    serving sizes a hat matrix runs to gigabytes and each out-of-place step
    would hold another copy."""
    d = rel - taps
    if torch.is_grad_enabled() and d.requires_grad:
        return torch.clamp(1.0 - torch.abs(d), min=0.0)
    return d.abs_().neg_().add_(1.0).clamp_(min=0.0)


def _warp_row_tiles(texf, fx_row, fy_row, band_y, band_x, pad_y, pad_x, h, w, c,
                    patch_backend="torch", compute_dtype=None):
    """Warp a batch of tiles: fx/fy ``[N, T, tile_r, tile_c]`` -> ``[N, T, P, C]``.

    ``texf`` is the x-major fused texture ``[N, Wp, Hp*C]``, so patches slice
    out as ready ``[B_x, B_y*C]`` matrix operands."""
    n, t = fx_row.shape[0], fx_row.shape[1]
    p_tile = fx_row.shape[2] * fx_row.shape[3]
    y_lo = torch.floor(fy_row.amin(dim=(2, 3))).to(torch.int32) - 1  # [N, T]
    x_lo = torch.floor(fx_row.amin(dim=(2, 3))).to(torch.int32) - 1
    y_lo_c = torch.clamp(y_lo + pad_y, 0, h + 2 * pad_y - band_y)
    x_lo_c = torch.clamp(x_lo + pad_x, 0, w + 2 * pad_x - band_x)
    offs = torch.stack([x_lo_c, y_lo_c * c], dim=-1)  # [N, T, 2] int32, clamped in range
    with record_function("tiled_warp.patches"):
        if patch_backend == "cuda":
            pm = gather_patches(texf, offs.contiguous(), band_x, band_y * c, validate=False)
        else:
            pm = gather_patches_ref(texf, offs, band_x, band_y * c)
        # [N, T, B_x, B_y*C]

    with record_function("tiled_warp.hats"):
        ty_rel = fy_row.reshape(n, t, p_tile, 1) - (y_lo_c - pad_y).to(fy_row.dtype)[..., None, None]
        tx_rel = fx_row.reshape(n, t, p_tile, 1) - (x_lo_c - pad_x).to(fx_row.dtype)[..., None, None]
        hat_y = _hat(ty_rel, torch.arange(band_y, device=texf.device, dtype=fy_row.dtype))
        hat_x = _hat(tx_rel, torch.arange(band_x, device=texf.device, dtype=fx_row.dtype))
        # [N, T, P, B_y], [N, T, P, B_x]
        if compute_dtype is not None:
            # fast mode: operands rounded to compute_dtype (pm already is)
            hat_x, hat_y = hat_x.to(compute_dtype), hat_y.to(compute_dtype)
    with record_function("tiled_warp.contract_x"):
        mixed = torch.matmul(hat_x, pm).float().reshape(n, t, p_tile, band_y, c)
    with record_function("tiled_warp.contract_y"):
        return torch.einsum("ntpy,ntpyc->ntpc", hat_y.float(), mixed)


def grid_sample_tiled(tex: torch.Tensor, grid: torch.Tensor, band_y: int = 32,
                      band_x: int = 160, tile: Tuple[int, int] = (8, 128),
                      align_corners: bool = True, row_scan: bool = False,
                      rows_per_step: int = 1, patch_backend: str = "torch",
                      compute_dtype: Optional[torch.dtype] = None, check: bool = False
                      ) -> torch.Tensor:
    """Bilinear sample with zeros padding through tile bands: ``tex [N, C, H,
    W]`` at ``grid [N, Ho, Wo, 2]`` -> ``[N, C, Ho, Wo]`` float32.

    ``band_y`` / ``band_x`` must cover each tile's source span (see
    :func:`required_bands`).  ``check=True`` adds the out-of-band assertion
    of the band contract: if any tile's span exceeds the bands the output is
    NaN-poisoned, so the violation shows in any loss or comparison downstream
    instead of silently dropping taps.

    ``row_scan=True`` processes the tile rows in groups of ``rows_per_step``
    in a loop, same results, with the hat matrices of one group alive at a
    time instead of all ``nty * ntx`` tiles'.  ``patch_backend``: ``"torch"``
    (an advanced index; differentiable) or ``"cuda"`` (the patch-gather
    kernel; on CPU tensors its plain version; no gradient).
    ``compute_dtype=torch.bfloat16`` rounds the texture and the hats to bf16
    for the first contraction.
    """
    if patch_backend not in PATCH_BACKENDS:
        raise ValueError(f"patch_backend: expected one of {PATCH_BACKENDS}, got {patch_backend!r}")
    n, c, h, w = tex.shape
    _, ho, wo, _ = grid.shape
    tile_r, tile_c = tile
    fx_t, fy_t, nty, ntx = _tile_coords(tex.shape, grid, align_corners, tile_r, tile_c)

    # generous zero pad: every clamped band start reads real texels or zeros.
    # x-major fused layout [N, Wp, Hp*C]: patch slices arrive matmul-ready.
    pad_y, pad_x = band_y, band_x
    texl = F.pad(tex.permute(0, 3, 2, 1), (0, 0, pad_y, pad_y, pad_x, pad_x)).reshape(
        n, w + 2 * pad_x, (h + 2 * pad_y) * c)
    if compute_dtype is not None:
        texl = texl.to(compute_dtype)
    g = nty
    if row_scan:
        g = max(1, min(rows_per_step, nty))
        while nty % g:
            g -= 1
    rows = []
    for r0 in range(0, nty, g):  # one step warps g * ntx tiles
        fx_g = fx_t[:, r0:r0 + g].reshape(n, g * ntx, tile_r, tile_c)
        fy_g = fy_t[:, r0:r0 + g].reshape(n, g * ntx, tile_r, tile_c)
        rows.append(_warp_row_tiles(texl, fx_g, fy_g, band_y, band_x, pad_y, pad_x, h, w, c,
                                    patch_backend, compute_dtype))
    out = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)  # [N, nty*ntx, P, C]
    out = out.reshape(n, nty, ntx, tile_r, tile_c, c).permute(0, 5, 1, 3, 2, 4).reshape(
        n, c, ho, wo)
    if check:
        ok = bands_cover(tex.shape, grid, band_y, band_x, align_corners, tile)
        out = torch.where(ok, out, float("nan"))
    return out


def make_tiled_warp_with_adjoint(band_y: int, band_x: int, adjoint_bands: Tuple[int, int],
                                 tile: Tuple[int, int] = (8, 128), align_corners: bool = True,
                                 row_scan: bool = False, rows_per_step: int = 1,
                                 adjoint_tile: Tuple[int, int] = (32, 512),
                                 adjoint_rows_per_step: int = 1, patch_backend: str = "torch",
                                 adjoint_step_bytes: Optional[int] = None
                                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Tiled warp with the exact scatter-free adjoint as its backward.

    Returns ``f(tex, grid) -> samples`` whose backward computes ``d_tex``
    through :func:`gmpi_tpu_torch.ops.tiled_warp_adjoint.grid_sample_tiled_adjoint`
    instead of autograd's scatter-add, and keeps only ``grid`` as residual (the
    hats are recomputed).  The grid is a constant (UV grids carry no gradient).
    ``adjoint_step_bytes`` bounds the backward's live hats a step (its plane
    groups).
    """
    from gmpi_tpu_torch.ops.tiled_warp_adjoint import grid_sample_tiled_adjoint

    pbr, pbc = adjoint_bands

    class TiledWarp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tex, grid):
            ctx.save_for_backward(grid)
            ctx.tex_shape = tuple(tex.shape)
            return grid_sample_tiled(tex, grid, band_y, band_x, tile, align_corners, row_scan,
                                     rows_per_step, patch_backend=patch_backend)

        @staticmethod
        def backward(ctx, cot):
            (grid,) = ctx.saved_tensors
            th, tw = ctx.tex_shape[2], ctx.tex_shape[3]
            atile = (adjoint_tile[0] if th % adjoint_tile[0] == 0 else (8 if th % 8 == 0 else 1),
                     adjoint_tile[1] if tw % adjoint_tile[1] == 0 else
                     (256 if tw % 256 == 0 else 128 if tw % 128 == 0 else tw))
            d_tex = grid_sample_tiled_adjoint(cot, grid, ctx.tex_shape, pbr, pbc, tile=atile,
                                              align_corners=align_corners, row_scan=row_scan,
                                              rows_per_step=adjoint_rows_per_step,
                                              step_bytes=adjoint_step_bytes)
            return d_tex, None

    return TiledWarp.apply
