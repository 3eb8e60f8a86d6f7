"""Bilinear taps of the tile-banded warp, read from its patches (K8).

:func:`sample_patches` interpolates the tile-banded warp's output pixels from
the patches that :func:`gmpi_tpu_torch.ops.patch_gather.gather_patches` (K7)
copied out of the padded texture: per pixel the two columns and two rows of
taps around its texel coordinate, with a tap outside the patch read as zero.
It is the same bilinear sum as the hat matrices and contractions of
``ops/tiled_warp.py`` (x first, then y), without forming them.  On a CUDA
tensor it launches the hand-written kernel of ``csrc/patch_sample.cu`` (or
raises); on a CPU tensor it runs the plain version :func:`sample_patches_ref`,
index gathers.  Each kernel launch adds one to ``LAUNCHES["patch_sample"]``.

The JAX package has no such kernel (it leaves the interpolation to XLA's
matrix products); there is no gradient through it, as there is none through
the patch gather.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gmpi_tpu_torch.ops import _build
from gmpi_tpu_torch.ops._build import LAUNCHES  # noqa: F401  (launches by kernel; re-exported)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 12 + [_P]  # of gmpi_patch_sample; the last is the stream


def _tile_pixels(offs, ho, wo, tile, first_tile):
    """Output rows ``[T, tile_r]`` and columns ``[T, tile_c]`` of the tiles
    ``first_tile .. first_tile + T - 1`` (row-major over the output's tiles)."""
    tile_r, tile_c = tile
    dev = offs.device
    tg = first_tile + torch.arange(offs.shape[1], device=dev)
    ntx = wo // tile_c
    oy = (tg // ntx)[:, None] * tile_r + torch.arange(tile_r, device=dev)
    ox = (tg % ntx)[:, None] * tile_c + torch.arange(tile_c, device=dev)
    return oy, ox


def sample_patches_ref(patches: torch.Tensor, offs: torch.Tensor, fx: torch.Tensor,
                       fy: torch.Tensor, pad: Tuple[int, int], tile: Tuple[int, int],
                       out: torch.Tensor, first_tile: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the tap sampler: the four taps of each pixel
    by index gathers, in the kernel's arithmetic.  Arguments and result as
    :func:`sample_patches`."""
    n, t, band_x, byc = patches.shape
    c = out.shape[1]
    band_y = byc // c
    pad_y, pad_x = pad
    oy, ox = _tile_pixels(offs, fx.shape[1], fx.shape[2], tile, first_tile)
    rows, cols = oy[:, :, None], ox[:, None, :]  # [T, tile_r, 1], [T, 1, tile_c]
    offs = offs.long()
    rx = fx[:, rows, cols] - (offs[..., 0] - pad_x).to(fx.dtype)[..., None, None]
    ry = fy[:, rows, cols] - (offs[..., 1] // c - pad_y).to(fy.dtype)[..., None, None]
    j0, i0 = torch.floor(rx), torch.floor(ry)  # [N, T, tile_r, tile_c]
    ax, ay = rx - j0, ry - i0
    flat = patches.reshape(n, t, 1, band_x * byc)
    chans = torch.arange(c, device=patches.device)

    def tap(j, i):
        inside = (j >= 0) & (j < band_x) & (i >= 0) & (i < band_y)  # False for NaN
        j, i = torch.where(inside, j, 0).long(), torch.where(inside, i, 0).long()
        at = (j * byc + i * c).reshape(n, t, -1, 1) + chans
        val = torch.gather(flat.expand(-1, -1, at.shape[2], -1), 3, at)  # [N, T, P, C]
        return torch.where(inside.reshape(n, t, -1, 1), val, 0.0)

    wx0, wy0 = (1.0 - ax).reshape(n, t, -1, 1), (1.0 - ay).reshape(n, t, -1, 1)
    ax, ay = ax.reshape(n, t, -1, 1), ay.reshape(n, t, -1, 1)
    m0 = wx0 * tap(j0, i0) + ax * tap(j0 + 1, i0)
    m1 = wx0 * tap(j0, i0 + 1) + ax * tap(j0 + 1, i0 + 1)
    s = wy0 * m0 + ay * m1  # [N, T, P, C]
    out[:, :, rows, cols] = s.reshape(n, t, *tile, c).permute(0, 4, 1, 2, 3)
    return out


def _check_args(patches, offs, fx, fy, pad, tile, out, first_tile) -> None:
    if patches.ndim != 4 or fx.ndim != 3 or out.ndim != 4:
        raise ValueError(f"expected patches [N, T, B_x, B_y*C], fx [N, Ho, Wo], out "
                         f"[N, C, Ho, Wo], got {tuple(patches.shape)}, {tuple(fx.shape)}, "
                         f"{tuple(out.shape)}")
    n, t, _, byc = patches.shape
    _, c, ho, wo = out.shape
    tile_r, tile_c = tile
    if fy.shape != fx.shape or fx.shape != (n, ho, wo) or out.shape[0] != n:
        raise ValueError(f"fx {tuple(fx.shape)}, fy {tuple(fy.shape)} and out "
                         f"{tuple(out.shape)} do not match {n} patch sets")
    if offs.dtype != torch.int32 or offs.shape != (n, t, 2):
        raise ValueError(f"offs: expected int32 [{n}, {t}, 2], got {offs.dtype} "
                         f"{tuple(offs.shape)}")
    if byc % c or tile_r < 1 or tile_c < 1 or ho % tile_r or wo % tile_c:
        raise ValueError(f"patch rows of {byc} elements, {c} channels, tile {tile} and output "
                         f"{ho}x{wo} do not fit")
    if not 0 <= first_tile <= (ho // tile_r) * (wo // tile_c) - t:
        raise ValueError(f"tiles {first_tile}..{first_tile + t - 1} of a "
                         f"{ho // tile_r}x{wo // tile_c} tiling")
    if min(pad) < 0:
        raise ValueError(f"pad: expected (pad_y, pad_x) >= 0, got {pad}")
    for name, x in (("patches", patches), ("fx", fx), ("fy", fy), ("out", out)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {x.dtype}")


def sample_patches(patches: torch.Tensor, offs: torch.Tensor, fx: torch.Tensor,
                   fy: torch.Tensor, pad: Tuple[int, int], tile: Tuple[int, int],
                   out: torch.Tensor, first_tile: int = 0) -> torch.Tensor:
    """Write the bilinear samples of the tiles ``first_tile .. first_tile + T
    - 1`` (row-major over the output's ``tile = (tile_r, tile_c)`` tiles)
    into ``out [N, C, Ho, Wo]`` float32 and return it; its other pixels are
    left as they are.

    patches ``[N, T, B_x, B_y*C]`` float32, contiguous, as
    ``gather_patches`` cut them from the x-major texture padded by ``pad =
    (pad_y, pad_x)`` texels, at the band starts ``offs [N, T, 2]`` int32
    (x in texels, y in elements of a row: texel y times C) it was given;
    fx, fy ``[N, Ho, Wo]`` float32 texel coordinates of the unpadded texture,
    contiguous, as ``out``.  A tap outside the patch reads zero.  CPU tensors run
    :func:`sample_patches_ref`; CUDA tensors launch the kernel.  No gradient:
    raises on a tensor that requires one while autograd records.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (patches, fx, fy)):
        raise RuntimeError(
            "sample_patches has no gradient (a hand-written kernel outside autograd): "
            "differentiate through make_tiled_warp_with_adjoint (4-field tiled_bands) or "
            "through grid_sample_tiled, which takes the hat contractions under autograd")
    _check_args(patches, offs, fx, fy, pad, tile, out, first_tile)
    if any(x.device != patches.device or not x.is_contiguous()
           for x in (patches, offs, fx, fy, out)):
        raise ValueError("patches, offs, fx, fy and out must be contiguous and on one device")
    if patches.device.type == "cpu":
        return sample_patches_ref(patches, offs, fx, fy, pad, tile, out, first_tile)
    if patches.device.type != "cuda":
        raise ValueError(f"sample_patches: unsupported device {patches.device}")
    n, t, band_x, byc = patches.shape
    _, c, ho, wo = out.shape
    _build.launch("patch_sample", _ARGTYPES, patches.device,
                  patches.data_ptr(), offs.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                  out.data_ptr(), n, t, band_x, byc // c, c, ho, wo, tile[0], tile[1],
                  first_tile, pad[1], pad[0])
    return out
