"""Bilinear taps of the tile-banded warp, read from the texture itself (K10).

:func:`texture_sample` interpolates every output pixel of the tile-banded
warp from the four taps around its texel coordinate, read straight from the
texture ``[N, C, H, W]``: a tap outside its tile's band ``[origin, origin +
band)`` or outside the texture reads zero.  That is what K7
(``ops/patch_gather.py``) and K8 (``ops/patch_sample.py``) computed through a
zero-padded x-major copy of the texture and one patch a tile, in K8's
arithmetic (x first, then y, in fp32), so the result is bitwise theirs;
:func:`patch_taps` is that composition, kept as the yardstick the tests and
``chip_smoke.py`` hold K10 against.  On a CUDA tensor it launches the
hand-written kernel of ``csrc/texture_sample.cu`` (or raises); on a CPU tensor
it runs the plain version :func:`texture_sample_ref`, index gathers.  Each
kernel launch adds one to ``LAUNCHES["texture_sample"]``.

The JAX package has no such kernel (it cuts patches for the TPU's matrix
unit and contracts them with hat matrices); there is no gradient through it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from gmpi_tpu_torch.ops import _build
from gmpi_tpu_torch.ops._build import LAUNCHES  # noqa: F401  (launches by kernel; re-exported)
from gmpi_tpu_torch.ops.patch_gather import gather_patches
from gmpi_tpu_torch.ops.patch_sample import sample_patches

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 10 + [_P]  # of gmpi_texture_sample; the last is the stream
_MAX_INT = 2 ** 31 - 1


def band_origins(fx: torch.Tensor, fy: torch.Tensor, bands: Tuple[int, int],
                 tile: Tuple[int, int], h: int, w: int) -> torch.Tensor:
    """Each tile's band origin ``[N, nty * ntx, 2]`` int32 (x, y), in texels of
    an ``h x w`` texture, from the coordinates ``fx, fy [N, Ho, Wo]``
    (contiguous) cut into ``tile = (tile_r, tile_c)`` tiles: one texel before
    the tile's least coordinate, clamped so that the band lies within the
    texture padded by a band on each side (the patch start K7 was given, less
    the padding).  All tiles in one pass: the least along each tile's rows
    (contiguous), then down its columns; a NaN coordinate makes its tile's
    least NaN, as a one-step minimum does."""
    band_y, band_x = bands
    n, ho, wo = fx.shape
    tile_r, tile_c = tile

    def least(f):  # [N, nty, ntx]
        return f.reshape(n, ho // tile_r, tile_r, wo // tile_c, tile_c).amin(dim=4).amin(dim=2)

    y_lo = torch.floor(least(fy)).to(torch.int32) - 1
    x_lo = torch.floor(least(fx)).to(torch.int32) - 1
    y_o = torch.clamp(y_lo + band_y, 0, h + band_y) - band_y
    x_o = torch.clamp(x_lo + band_x, 0, w + band_x) - band_x
    return torch.stack([x_o, y_o], dim=-1).reshape(n, -1, 2)


def _tile_of_pixel(ho: int, wo: int, tile: Tuple[int, int], device) -> torch.Tensor:
    """``[Ho, Wo]``: the row-major index of each output pixel's tile."""
    tile_r, tile_c = tile
    rows = torch.arange(ho, device=device) // tile_r
    cols = torch.arange(wo, device=device) // tile_c
    return rows[:, None] * (wo // tile_c) + cols[None, :]


def texture_sample_ref(tex: torch.Tensor, origins: torch.Tensor, fx: torch.Tensor,
                       fy: torch.Tensor, bands: Tuple[int, int], tile: Tuple[int, int]
                       ) -> torch.Tensor:
    """Plain PyTorch version of K10: the four taps of each pixel by index
    gathers, in the kernel's arithmetic.  Arguments and result as
    :func:`texture_sample`."""
    n, c, h, w = tex.shape
    _, ho, wo = fx.shape
    band_y, band_x = bands
    org = origins.long()[:, _tile_of_pixel(ho, wo, tile, tex.device)]  # [N, Ho, Wo, 2]
    x_o, y_o = org[..., 0], org[..., 1]
    rx = fx - x_o.to(fx.dtype)
    ry = fy - y_o.to(fy.dtype)
    j0, i0 = torch.floor(rx), torch.floor(ry)  # [N, Ho, Wo]
    ax, ay = rx - j0, ry - i0
    flat = tex.reshape(n, c, h * w)

    def tap(j, i):
        inside = (j >= 0) & (j < band_x) & (i >= 0) & (i < band_y)  # False for NaN
        x = x_o + torch.where(inside, j, 0).long()
        y = y_o + torch.where(inside, i, 0).long()
        inside &= (x >= 0) & (x < w) & (y >= 0) & (y < h)
        at = torch.where(inside, y * w + x, 0).reshape(n, 1, -1).expand(n, c, -1)
        val = torch.gather(flat, 2, at).reshape(n, c, ho, wo)
        return torch.where(inside[:, None], val, 0.0)

    wx0, wy0 = (1.0 - ax)[:, None], (1.0 - ay)[:, None]
    ax, ay = ax[:, None], ay[:, None]
    m0 = wx0 * tap(j0, i0) + ax * tap(j0 + 1, i0)
    m1 = wx0 * tap(j0, i0 + 1) + ax * tap(j0 + 1, i0 + 1)
    return wy0 * m0 + ay * m1


def _check_args(tex, origins, fx, fy, bands, tile) -> None:
    if tex.ndim != 4 or fx.ndim != 3:
        raise ValueError(f"expected tex [N, C, H, W] and fx [N, Ho, Wo], got "
                         f"{tuple(tex.shape)}, {tuple(fx.shape)}")
    n, c, h, w = tex.shape
    _, ho, wo = fx.shape
    tile_r, tile_c = tile
    if tile_r < 1 or tile_c < 1 or ho % tile_r or wo % tile_c:
        raise ValueError(f"output {ho}x{wo} is not a multiple of the tile {tile}")
    if fx.shape[0] != n or fy.shape != fx.shape:
        raise ValueError(f"fx {tuple(fx.shape)} and fy {tuple(fy.shape)} do not match {n} "
                         f"textures")
    n_tiles = (ho // tile_r) * (wo // tile_c)
    if origins.dtype != torch.int32 or origins.shape != (n, n_tiles, 2):
        raise ValueError(f"origins: expected int32 [{n}, {n_tiles}, 2], got {origins.dtype} "
                         f"{tuple(origins.shape)}")
    if min(bands) < 1:
        raise ValueError(f"bands: expected (band_y, band_x) >= 1, got {bands}")
    if c * h * w > _MAX_INT or ho * wo > _MAX_INT:
        raise ValueError(f"a texture of {c}x{h}x{w} or an output of {ho}x{wo} reaches 2^31 "
                         f"elements")
    for name, x in (("tex", tex), ("fx", fx), ("fy", fy)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {x.dtype}")


def texture_sample(tex: torch.Tensor, origins: torch.Tensor, fx: torch.Tensor,
                   fy: torch.Tensor, bands: Tuple[int, int], tile: Tuple[int, int]
                   ) -> torch.Tensor:
    """The bilinear samples ``[N, C, Ho, Wo]`` float32 of ``tex [N, C, H, W]``
    float32 at the texel coordinates ``fx, fy [N, Ho, Wo]`` float32, each
    output ``tile = (tile_r, tile_c)`` reading taps only from its band of
    ``bands = (band_y, band_x)`` texels at ``origins [N, nty * ntx, 2]``
    int32 (x, y; :func:`band_origins`).  A tap outside the band or the
    texture reads zero.  All contiguous, on one device.  CPU tensors run
    :func:`texture_sample_ref`; CUDA tensors launch the kernel.  No gradient:
    raises on a tensor that requires one while autograd records."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (tex, fx, fy)):
        raise RuntimeError(
            "texture_sample has no gradient (a hand-written kernel outside autograd): "
            "differentiate through make_tiled_warp_with_adjoint (4-field tiled_bands) or "
            "through grid_sample_tiled, which takes the hat contractions under autograd")
    _check_args(tex, origins, fx, fy, bands, tile)
    if any(x.device != tex.device or not x.is_contiguous() for x in (tex, origins, fx, fy)):
        raise ValueError("tex, origins, fx and fy must be contiguous and on one device")
    if tex.device.type == "cpu":
        return texture_sample_ref(tex, origins, fx, fy, bands, tile)
    if tex.device.type != "cuda":
        raise ValueError(f"texture_sample: unsupported device {tex.device}")
    n, c, h, w = tex.shape
    _, ho, wo = fx.shape
    out = torch.empty((n, c, ho, wo), dtype=torch.float32, device=tex.device)
    _build.launch("texture_sample", _ARGTYPES, tex.device,
                  tex.data_ptr(), origins.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                  out.data_ptr(), n, c, h, w, ho, wo, tile[0], tile[1], bands[0], bands[1])
    return out


def patch_taps(tex: torch.Tensor, origins: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
               bands: Tuple[int, int], tile: Tuple[int, int], rows_per_step: int = 1
               ) -> torch.Tensor:
    """What :func:`texture_sample` computes, the way the tiled warp computed
    it before K10: a zero-padded x-major copy of the texture, K7's patch of
    each tile at its band (``gather_patches``), and K8's taps from them
    (``sample_patches``), ``rows_per_step`` tile rows a step (all textures at
    once).  Kernels on CUDA tensors, their plain versions on CPU tensors;
    bitwise :func:`texture_sample` on either."""
    n, c, h, w = tex.shape
    _, ho, wo = fx.shape
    band_y, band_x = bands
    ntx = wo // tile[1]
    texl = F.pad(tex.permute(0, 3, 2, 1), (0, 0, band_y, band_y, band_x, band_x)).reshape(
        n, w + 2 * band_x, (h + 2 * band_y) * c)
    offs = torch.stack([origins[..., 0] + band_x, (origins[..., 1] + band_y) * c], dim=-1)
    out = torch.empty((n, c, ho, wo), dtype=torch.float32, device=tex.device)
    for first in range(0, (ho // tile[0]) * ntx, rows_per_step * ntx):
        step = offs[:, first:first + rows_per_step * ntx].contiguous()
        pm = gather_patches(texl, step, band_x, band_y * c, validate=False)
        sample_patches(pm, step, fx, fy, bands, tile, out, first)
    return out
