"""Style-modulated convolution, scale-activations form (port of
``gmpi_tpu/ops/modulated_conv.py``).

Modulate the input channels, run one shared-weight conv, demodulate the
output channels — the same math as the reference's per-sample grouped conv.
Demodulation coefficients are the per-sample modulated-weight L2 over
``[in, kh, kw]`` (eps 1e-8), including the fp16-era pre-normalization guard,
kept for bfloat16.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from benchmark.reference.conv2d import conv2d_resample


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                     padding: int = 0, resample_filter: Optional[np.ndarray] = None,
                     demodulate: bool = True, flip_weight: bool = True) -> torch.Tensor:
    """x ``[N, Cin, H, W]``, weight ``[Cout, Cin, kh, kw]``, styles ``[N, Cin]``."""
    batch = x.shape[0]
    out_ch, in_ch, kh, kw = weight.shape

    # bf16 overflow guard (the reference's fp16 pre-normalization)
    if x.dtype == torch.bfloat16 and demodulate:
        wmax = torch.amax(torch.abs(weight), dim=(1, 2, 3), keepdim=True)
        weight = weight * (1.0 / np.sqrt(in_ch * kh * kw) / wmax)
        styles = styles / torch.amax(torch.abs(styles), dim=1, keepdim=True)

    dcoefs = None
    if demodulate:
        w = weight[None] * styles.reshape(batch, 1, in_ch, 1, 1)
        dcoefs = torch.rsqrt(torch.sum(torch.square(w), dim=(2, 3, 4)) + 1e-8)  # [N, O]

    x = x * styles.to(x.dtype).reshape(batch, in_ch, 1, 1)
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype).reshape(batch, out_ch, 1, 1)
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
