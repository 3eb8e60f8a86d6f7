"""upfirdn2d — upsample, FIR filter, downsample (port of
``gmpi_tpu/ops/upfirdn2d.py``), in plain PyTorch.

Semantics of the reference's ``_upfirdn2d_ref``: insert ``up-1`` zeros after
each input pixel, pad (or crop, for negative padding) the upsampled image,
convolve depthwise with the fp32 FIR filter (flipped unless ``flip_filter``)
times ``gain``, keep every ``down``-th pixel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def _parse_scaling(s) -> Tuple[int, int]:
    if isinstance(s, int):
        return s, s
    sx, sy = s
    return int(sx), int(sy)


def _parse_padding(p) -> Tuple[int, int, int, int]:
    if isinstance(p, int):
        return p, p, p, p
    p = list(p)
    if len(p) == 2:
        px, py = p
        return px, px, py, py
    px0, px1, py0, py1 = p
    return px0, px1, py0, py1


def _as_filter(f) -> torch.Tensor:
    """A filter given as numpy, a list or a tensor (e.g. a module buffer)."""
    return f if torch.is_tensor(f) else torch.as_tensor(np.asarray(f), dtype=torch.float32)


def _filter_size(f) -> Tuple[int, int]:
    f = _as_filter(f)
    return (f.shape[0], f.shape[-1]) if f.ndim == 2 else (f.numel(), f.numel())


def setup_filter(f, normalize: bool = True, flip_filter: bool = False, gain: float = 1.0,
                 separable: Optional[bool] = None) -> np.ndarray:
    """Dense 2D float32 FIR filter (1D filters become outer products); total
    signal gain ``gain``."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[np.newaxis]
    assert f.ndim in (1, 2)
    if f.ndim == 1:
        if normalize:
            f = f / f.sum()
        f = np.outer(f, f)
    elif normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1, ::-1]
    return np.ascontiguousarray(f * gain, dtype=np.float32)


def upfirdn2d(x: torch.Tensor, f, up: Union[int, Sequence[int]] = 1,
              down: Union[int, Sequence[int]] = 1, padding: Union[int, Sequence[int]] = 0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Upsample -> pad -> FIR -> downsample ``x [N, C, H, W]``; ``f`` is a 2D
    (or 1D separable) filter, or None for identity."""
    f = torch.ones((1, 1)) if f is None else _as_filter(f).to(torch.float32)
    if f.ndim == 1:
        f = torch.outer(f, f)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    n, c, h, w = x.shape

    if upx > 1 or upy > 1:  # zero insertion, trailing zeros included
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, h * upy, w * upx)
    # F.pad crops on negative entries
    x = F.pad(x, [padx0, padx1, pady0, pady1])

    f = f * gain
    if not flip_filter:
        f = f.flip([0, 1])
    # one filter for every channel: channels fold into the batch and the conv
    # has one group.  A depthwise conv (groups=c) computes the same, but its
    # double backward (the R1 penalty differentiates D twice) loops over the
    # groups, one small convolution each.
    weight = f.to(device=x.device, dtype=x.dtype)[None, None]
    y = F.conv2d(x.reshape(n * c, 1, x.shape[2], x.shape[3]), weight, stride=(downy, downx))
    return y.reshape(n, c, y.shape[2], y.shape[3])


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    """Shape-preserving FIR filter."""
    fh, fw = _filter_size(f)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    p = (padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2, pady1 + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """Antialiased upsampling; output is ``up`` x the input, gain ``gain * up**2``."""
    upx, upy = _parse_scaling(up)
    fh, fw = _filter_size(f)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    p = (padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2)
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """Antialiased downsampling."""
    downx, downy = _parse_scaling(down)
    fh, fw = _filter_size(f)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    p = (padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2)
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
