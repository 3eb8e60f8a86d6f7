"""conv2d with fused up/down resampling (port of ``gmpi_tpu/ops/conv2d.py``).

Semantics of the reference's ``conv2d_resample``: padding applied once
w.r.t. the upsampled image, FIR-filtered zero-insert upsampling with gain
``up**2``, then the convolution, then FIR downsampling.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import precision
from benchmark.reference.upfirdn2d import _filter_size, _parse_padding, upfirdn2d


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=0, groups: int = 1,
           flip_weight: bool = True) -> torch.Tensor:
    """Grouped conv2d; ``flip_weight=True`` is cross-correlation (the
    ``F.conv2d`` convention), ``False`` a true convolution."""
    if not flip_weight:
        w = w.flip([2, 3])
    x, w = precision.conv_operands(x, w.to(x.dtype))
    px0, px1, py0, py1 = _parse_padding(padding)
    if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(py0, px0), groups=groups)
    x = F.pad(x, [px0, px1, py0, py1])
    return F.conv2d(x, w.to(x.dtype), stride=stride, groups=groups)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Optional[np.ndarray] = None,
                    up: int = 1, down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True, flip_filter: bool = False) -> torch.Tensor:
    """2D convolution with optional FIR up/downsampling; ``padding`` is w.r.t.
    the upsampled image."""
    assert up >= 1 and down >= 1
    fh, fw = (1, 1) if f is None else _filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if up > 1:
        x = upfirdn2d(x, f, up=up, padding=(px0, px1, py0, py1), gain=up * up,
                      flip_filter=flip_filter)
        x = conv2d(x, w, groups=groups, flip_weight=flip_weight)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x
    if down > 1:
        x = upfirdn2d(x, f, padding=(px0, px1, py0, py1), flip_filter=flip_filter)
        return conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)
    return conv2d(x, w, padding=(px0, px1, py0, py1), groups=groups, flip_weight=flip_weight)
