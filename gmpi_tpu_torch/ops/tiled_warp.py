"""Tile-banded warp: bilinear grid sampling through texture bands (port of
``gmpi_tpu/ops/tiled_warp.py``).

The formulation exploits the smoothness of homography warps: within an output
tile of ``tile_r x tile_c`` pixels the source coordinates span a bounded
texture band, ``band_y x band_x`` texels from one texel before the tile's
least coordinate; each pixel is interpolated from its tile's band alone.

The warp picks one of two routes for this, by what it is asked:

* the *taps* (:func:`_sample_taps`) where autograd records nothing through
  it and no ``compute_dtype`` is asked for: the band origins of all tiles in
  one pass over the coordinates, then one launch of the hand-written kernel
  of ``ops/texture_sample.py`` (K10), which reads each pixel's four taps
  straight from the texture (a 1024^2 plane stays in the card's L2 while its
  pixels are served), with a tap outside the band or the texture read as
  zero; on CPU tensors its plain version.  No padded copy and no patch is
  made.  The kernel has no gradient: inside
  :func:`make_tiled_warp_with_adjoint` the forward takes this route, and the
  tiled adjoint is the backward;
* the *hats* (:func:`_sample_hats`) otherwise, the differentiable plain route
  the JAX package takes: per tile one contiguous patch ``[B_x, B_y * C]``
  sliced by one advanced index from a zero-padded x-major copy of the
  texture, and bilinear *hat* weights against the patch grid, ``hat_x[p, j]
  = relu(1 - |tx_p - (x_lo + j)|)`` (two nonzeros per row), contracted:
  ``M[p, (y, c)] = hat_x[p, :] @ patch[:, (y, c)]``, then ``out[p, c] =
  sum_y hat_y[p, y] M[p, y, c]``.  ``compute_dtype=torch.bfloat16`` rounds
  the texture and the hats, which the taps never form, so that mode takes the
  hats too.

Both give exactly zero for out-of-band taps, which reproduces
``padding_mode="zeros"`` on the zero-padded texture, and both are separable
bilinear interpolation, so results match ``grid_sample_bilinear`` to fp32
reassociation.  The contractions are plain matrix products outside any
hand-written kernel, as in the JAX package; callers on a CUDA device keep
TF32 off for them (``torch.backends.cuda.matmul.allow_tf32 = False``,
PyTorch's default).

The tiling (the warp's tile, the adjoint's, and the tile rows a step of the
hats) comes from :func:`tiling`, the one rule that the renderer and the band
planner (``core/bands.py``) also follow.  Band sizes are static and must cover
every tile's coordinate span; :func:`required_bands` measures the true spans
of a grid, :func:`bands_cover` checks a configuration at run time, and
``check=True`` NaN-poisons the output of a render whose poses leave the
planned bands.

The port does not round the band origins down to tile boundaries (the JAX
package does on its Pallas backend, and widens the bands for it): both routes
read the same bands from any origin.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gmpi_tpu_torch.ops.grid_sample import _unnormalize
from gmpi_tpu_torch.ops.patch_gather import gather_patches_ref
from gmpi_tpu_torch.ops.texture_sample import band_origins, texture_sample
from gmpi_tpu_torch.utils.inspect import profile_scope


class Tiling(NamedTuple):
    """What :func:`tiling` returns."""
    tile: Tuple[int, int]          # the warp's output tile (rows, columns)
    adjoint_tile: Tuple[int, int]  # the tiled adjoint's texture tile
    row_scan: bool                 # tile rows in steps of rows_per_step, not all at once
    rows_per_step: int


def tiling(h: int, w: int, tile: Optional[Tuple[int, int]] = None) -> Tiling:
    """The banded warp's tiling of an ``h x w`` image (the warp's output, and
    the texture of its adjoint, image-sized on every route): tiles of 8 rows
    (else 1) and 256 or 128 columns (else the width); the adjoint's texture
    tiles taller and wider, 32 rows and 512 or 256 columns where they divide,
    to amortize the overlap of neighbouring tiles' bands; and, over 32 tile
    rows, the rows in ~64 steps as the JAX package takes them (the warp's hats
    and its adjoint cut the rows and group the textures further under their
    ``step_bytes``; the taps take every row at once).  ``tile`` stands in for
    the rule's warp tile (the parity tests pass the JAX package's); the
    adjoint tile and the steps follow it.
    The warp, its adjoint and ``core/bands.required_spans`` take their
    defaults from here."""
    tile = tile or (8 if h % 8 == 0 else 1, 256 if w % 256 == 0 else 128 if w % 128 == 0 else w)
    adjoint_tile = (32 if h % 32 == 0 else tile[0],
                    512 if w % 512 == 0 else 256 if w % 256 == 0 else tile[1])
    nty = h // tile[0]
    return Tiling(tuple(tile), adjoint_tile, nty > 32, max(1, nty // 64) if nty > 32 else 1)


def _tile_coords(tex_shape, grid, align_corners, tile=None):
    """Texel coordinates of ``grid`` by output tile (``tile`` None: the rule's):
    ``(fx_t, fy_t [N, nty, ntx, tile_r, tile_c], nty, ntx)``."""
    n, _, h, w = tex_shape
    _, ho, wo, _ = grid.shape
    tile_r, tile_c = tile or tiling(ho, wo).tile
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
                   align_corners: bool = True, tile: Optional[Tuple[int, int]] = None
                   ) -> Tuple[int, int]:
    """Smallest ``(B_y, B_x)`` covering every tile of this grid (host helper)."""
    fx_t, fy_t, _, _ = _tile_coords(tex_shape, grid, align_corners, tile)
    return int(_max_span(fy_t)), int(_max_span(fx_t))


def bands_cover(tex_shape: Tuple[int, int, int, int], grid: torch.Tensor, band_y: int,
                band_x: int, align_corners: bool = True, tile: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
    """0-dim bool tensor: True iff every tile's source span fits the static
    bands.  A few reductions on the grid's device, no host synchronization."""
    fx_t, fy_t, _, _ = _tile_coords(tex_shape, grid, align_corners, tile)
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
                    compute_dtype=None):
    """Warp a batch of tiles through the hats: fx/fy ``[N, T, tile_r,
    tile_c]`` -> ``[N, T, P, C]``.

    ``texf`` is the x-major fused texture ``[N, Wp, Hp*C]``, so patches slice
    out as ready ``[B_x, B_y*C]`` matrix operands."""
    n, t = fx_row.shape[0], fx_row.shape[1]
    p_tile = fx_row.shape[2] * fx_row.shape[3]
    y_lo = torch.floor(fy_row.amin(dim=(2, 3))).to(torch.int32) - 1  # [N, T]
    x_lo = torch.floor(fx_row.amin(dim=(2, 3))).to(torch.int32) - 1
    y_lo_c = torch.clamp(y_lo + pad_y, 0, h + 2 * pad_y - band_y)
    x_lo_c = torch.clamp(x_lo + pad_x, 0, w + 2 * pad_x - band_x)
    offs = torch.stack([x_lo_c, y_lo_c * c], dim=-1)  # [N, T, 2] int32, clamped in range
    with profile_scope("tiled_warp.patches"):
        pm = gather_patches_ref(texf, offs, band_x, band_y * c)  # [N, T, B_x, B_y*C]
    with profile_scope("tiled_warp.hats"):
        ty_rel = fy_row.reshape(n, t, p_tile, 1) - (y_lo_c - pad_y).to(fy_row.dtype)[..., None, None]
        tx_rel = fx_row.reshape(n, t, p_tile, 1) - (x_lo_c - pad_x).to(fx_row.dtype)[..., None, None]
        hat_y = _hat(ty_rel, torch.arange(band_y, device=texf.device, dtype=fy_row.dtype))
        hat_x = _hat(tx_rel, torch.arange(band_x, device=texf.device, dtype=fx_row.dtype))
        # [N, T, P, B_y], [N, T, P, B_x]
        if compute_dtype is not None:
            # fast mode: operands rounded to compute_dtype (pm already is)
            hat_x, hat_y = hat_x.to(compute_dtype), hat_y.to(compute_dtype)
    with profile_scope("tiled_warp.contract_x"):
        mixed = torch.matmul(hat_x, pm).float().reshape(n, t, p_tile, band_y, c)
    with profile_scope("tiled_warp.contract_y"):
        return torch.einsum("ntpy,ntpyc->ntpc", hat_y.float(), mixed)


def step_groups(n: int, n_rows: int, rows: int, row_bytes: int, step_bytes: Optional[int],
                item_bytes: int = 0) -> Tuple[int, int]:
    """``(tile rows a step, items a step)`` for ``n`` items (textures or
    planes) of ``n_rows`` tile rows, ``rows`` a step as asked, where one
    item's tile row holds ``row_bytes`` in a step and the item itself
    ``item_bytes`` whatever its rows.  With ``step_bytes``, fewer rows a step
    (a divisor of ``n_rows``) where one item's rows exceed it, and the items
    in equal groups whose steps stay under it; at least one row and one
    item."""
    if step_bytes is None:
        return rows, n
    while rows > 1 and rows * row_bytes > step_bytes:
        rows -= 1
        while n_rows % rows:
            rows -= 1
    n_groups = -(-n // max(1, step_bytes // (rows * row_bytes + item_bytes)))
    return rows, -(-n // n_groups)


def grid_sample_tiled(tex: torch.Tensor, grid: torch.Tensor, band_y: int = 32,
                      band_x: int = 160, tile: Optional[Tuple[int, int]] = None,
                      align_corners: bool = True, row_scan: Optional[bool] = None,
                      rows_per_step: Optional[int] = None,
                      compute_dtype: Optional[torch.dtype] = None, check: bool = False,
                      step_bytes: Optional[int] = None) -> torch.Tensor:
    """Bilinear sample with zeros padding through tile bands: ``tex [N, C, H,
    W]`` at ``grid [N, Ho, Wo, 2]`` -> ``[N, C, Ho, Wo]`` float32.

    ``band_y`` / ``band_x`` must cover each tile's source span (see
    :func:`required_bands`).  ``check=True`` adds the out-of-band assertion
    of the band contract: if any tile's span exceeds the bands the output is
    NaN-poisoned, so the violation shows in any loss or comparison downstream
    instead of silently dropping taps.

    The route is the warp's own (see the module doc): the taps where
    autograd records nothing through ``tex`` or ``grid`` and
    ``compute_dtype`` is None, else the hats.  ``compute_dtype=
    torch.bfloat16`` rounds the texture and the hats to bf16 for the first
    contraction.  The taps read the texture in one kernel launch and hold
    nothing but the output, whatever the size.

    On the hats, ``row_scan=True`` processes the tile rows in groups of
    ``rows_per_step`` in a loop, same results, with the hat matrices of one
    group alive at a time instead of all ``nty * ntx`` tiles'.
    ``step_bytes`` bounds what a step of the hats holds (:func:`step_groups`):
    its hats and mixed products.  The textures go through in equal groups,
    each with its own padded copy, and where one texture's tile rows of a
    step exceed the budget, fewer rows a step (at 512 textures of 1024^2, the
    worst-view candidates of a FFHQ1024 step, one step over all of them would
    hold ~32 GB of hats).  Textures and tiles are independent, so the
    grouping changes no value.  ``tile``, ``row_scan`` and ``rows_per_step``
    default to :func:`tiling`'s.
    """
    t = tiling(grid.shape[1], grid.shape[2], tile)
    fx_t, fy_t, nty, _ = _tile_coords(tex.shape, grid, align_corners, t.tile)
    if compute_dtype is None and not (torch.is_grad_enabled()
                                      and (tex.requires_grad or grid.requires_grad)):
        out = _sample_taps(tex, fx_t, fy_t, band_y, band_x)
    else:
        g = nty
        if t.row_scan if row_scan is None else row_scan:
            g = max(1, min(t.rows_per_step if rows_per_step is None else rows_per_step, nty))
            while nty % g:
                g -= 1
        out = _sample_hats(tex, fx_t, fy_t, band_y, band_x, g, step_bytes, compute_dtype)
    if check:
        ok = bands_cover(tex.shape, grid, band_y, band_x, align_corners, t.tile)
        out = torch.where(ok, out, float("nan"))
    return out


def _sample_taps(tex, fx_t, fy_t, band_y, band_x):
    """The taps route of :func:`grid_sample_tiled` on the tile coordinates
    ``fx_t, fy_t [N, nty, ntx, tile_r, tile_c]`` (views of ``[N, Ho, Wo]``
    coordinates): every tile's band origin in one pass, then K10 over all
    textures and tiles in one launch; no gradient."""
    n, _, h, w = tex.shape
    nty, ntx, tile_r, tile_c = fx_t.shape[1:]
    fx, fy = (f.transpose(2, 3).reshape(n, nty * tile_r, ntx * tile_c).contiguous()
              for f in (fx_t, fy_t))
    with profile_scope("tiled_warp.sample"):
        origins = band_origins(fx, fy, (band_y, band_x), (tile_r, tile_c), h, w)
        return texture_sample(tex.contiguous(), origins, fx, fy, (band_y, band_x),
                              (tile_r, tile_c))


def _sample_hats(tex, fx_t, fy_t, band_y, band_x, g, step_bytes, compute_dtype=None):
    """The hats route of :func:`grid_sample_tiled` on the tile coordinates
    ``fx_t, fy_t [N, nty, ntx, tile_r, tile_c]``, ``g`` tile rows a step: the
    advanced index and the hat contractions, differentiable.  A step holds a
    texture's hats and mixed products a tile row."""
    n, c = tex.shape[:2]
    nty, ntx, tile_r, tile_c = fx_t.shape[1:]
    g, n_step = step_groups(n, nty, g, 4 * tile_r * ntx * tile_c
                            * (band_x + band_y + band_y * c), step_bytes)
    out = torch.cat([_warp_textures(tex[i:i + n_step], fx_t[i:i + n_step], fy_t[i:i + n_step],
                                    band_y, band_x, g, compute_dtype)
                     for i in range(0, n, n_step)])  # [N, nty*ntx, P, C]
    return out.reshape(n, nty, ntx, tile_r, tile_c, c).permute(0, 5, 1, 3, 2, 4).reshape(
        n, c, nty * tile_r, ntx * tile_c)


def _warp_textures(tex, fx_t, fy_t, band_y, band_x, g, compute_dtype):
    """:func:`grid_sample_tiled` of a group of textures, ``g`` tile rows a
    step, through the hats: ``[N, nty*ntx, P, C]``."""
    n, c, h, w = tex.shape
    nty, ntx, tile_r, tile_c = fx_t.shape[1:]
    # generous zero pad: every clamped band start reads real texels or zeros.
    # x-major fused layout [N, Wp, Hp*C]: patch slices arrive matmul-ready.
    pad_y, pad_x = band_y, band_x
    texl = F.pad(tex.permute(0, 3, 2, 1), (0, 0, pad_y, pad_y, pad_x, pad_x)).reshape(
        n, w + 2 * pad_x, (h + 2 * pad_y) * c)
    if compute_dtype is not None:
        texl = texl.to(compute_dtype)
    rows = []
    for r0 in range(0, nty, g):  # one step warps g * ntx tiles
        fx_g = fx_t[:, r0:r0 + g].reshape(n, g * ntx, tile_r, tile_c)
        fy_g = fy_t[:, r0:r0 + g].reshape(n, g * ntx, tile_r, tile_c)
        rows.append(_warp_row_tiles(texl, fx_g, fy_g, band_y, band_x, pad_y, pad_x, h, w, c,
                                    compute_dtype))
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


def make_tiled_warp_with_adjoint(band_y: int, band_x: int, adjoint_bands: Tuple[int, int],
                                 tile: Optional[Tuple[int, int]] = None,
                                 align_corners: bool = True, row_scan: Optional[bool] = None,
                                 rows_per_step: Optional[int] = None,
                                 adjoint_tile: Optional[Tuple[int, int]] = None,
                                 adjoint_rows_per_step: int = 1,
                                 step_bytes: Optional[int] = None
                                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Tiled warp with the exact scatter-free adjoint as its backward.

    Returns ``f(tex, grid) -> samples`` whose forward takes the taps and whose
    backward computes ``d_tex`` through
    :func:`gmpi_tpu_torch.ops.tiled_warp_adjoint.grid_sample_tiled_adjoint`
    instead of autograd's scatter-add, and keeps only ``grid`` as residual (the
    hats are recomputed).  The grid is a constant (UV grids carry no gradient).
    ``step_bytes`` bounds what a step of the backward holds (the forward's
    taps hold nothing but their output).  The tiling
    defaults to :func:`tiling`'s, the adjoint's on the texture's size.
    """
    from gmpi_tpu_torch.ops.tiled_warp_adjoint import grid_sample_tiled_adjoint

    pbr, pbc = adjoint_bands

    class TiledWarp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tex, grid):
            ctx.save_for_backward(grid)
            ctx.tex_shape = tuple(tex.shape)
            # autograd records nothing in here, so the warp takes the taps
            return grid_sample_tiled(tex, grid, band_y, band_x, tile, align_corners,
                                     row_scan, rows_per_step, step_bytes=step_bytes)

        @staticmethod
        def backward(ctx, cot):
            (grid,) = ctx.saved_tensors
            scan = tiling(grid.shape[1], grid.shape[2], tile).row_scan if row_scan is None \
                else row_scan
            atile = adjoint_tile or tiling(*ctx.tex_shape[2:], tile).adjoint_tile
            # autograd's engine runs this outside the forward's render span (on a card,
            # in its own thread), so the backward's kernels get a span of their own
            with profile_scope("render.backward"):
                d_tex = grid_sample_tiled_adjoint(cot, grid, ctx.tex_shape, pbr, pbc,
                                                  tile=atile, align_corners=align_corners,
                                                  row_scan=scan,
                                                  rows_per_step=adjoint_rows_per_step,
                                                  step_bytes=step_bytes)
            return d_tex, None

    return TiledWarp.apply
