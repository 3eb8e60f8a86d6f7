"""Bias + activation + gain + clamp (port of ``gmpi_tpu/ops/bias_act.py``).

Plain PyTorch: the JAX package leaves this to one XLA fusion, and here it is
a handful of elementwise ops in the input dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class _ActSpec(NamedTuple):
    fn: object
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": _ActSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": _ActSpec(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2.0)),
    "lrelu": _ActSpec(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, math.sqrt(2.0)),
    "tanh": _ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": _ActSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": _ActSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": _ActSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": _ActSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2.0)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, axis: int = 1,
             act: str = "linear", alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """Add ``b`` along ``axis``, apply ``act``, scale by ``gain``, clamp to
    ``[-clamp, clamp]``; kept in the dtype of ``x`` throughout."""
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)
    if b is not None:
        assert b.ndim == 1 and b.shape[0] == x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.fn(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        assert clamp >= 0
        x = torch.clamp(x, -clamp, clamp)
    return x
