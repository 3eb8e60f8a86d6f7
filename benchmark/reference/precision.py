"""The precision the reference computes in.

By default every operation of the reference is float32 with TF32 off (the
caller sets ``torch.backends.{cuda.matmul,cudnn}.allow_tf32 = False``).  Two
other modes, each entered with :func:`mode`:

* ``stated``: the blocks that the configuration states in bfloat16 compute in
  bfloat16, as the program does.  Used on meta tensors, to count each
  operation's FLOPs under the precision it is stated in (``yardstick.flops``).
* ``control``: the reference one step below the stated precision, the
  comparison's control.  Every value is rounded as it is made: in the
  blocks stated in bfloat16, to float8 e4m3 (with a per-tensor scale); the
  other convolutions (TF32 in the program, cuDNN's default) to bfloat16;
  every other float32 value (TF32 off) to TF32's 10-bit mantissa.  That
  holds for the operands of convolutions and matrix products (rounded
  straight through, so gradients pass), for the result of every operation
  (``_Rounding``, a dispatch mode that sees the backward's operations too:
  those run outside any block, and round as float32 or convolutions there
  do), and for the MPI the renderer reads (TF32).

``block(use_bf16)`` marks the layers that run inside a bfloat16 block.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@dataclasses.dataclass
class _Mode:
    stated: bool = False
    control: bool = False
    lowp: bool = False  # inside a block the configuration states in bfloat16


MODE = _Mode()


@contextlib.contextmanager
def mode(stated: bool = False, control: bool = False):
    saved = dataclasses.replace(MODE)
    MODE.stated, MODE.control = stated, control
    try:
        if control:
            with _Rounding():
                yield
        else:
            yield
    finally:
        MODE.stated, MODE.control, MODE.lowp = saved.stated, saved.control, saved.lowp


_CONV = ("convolution", "_convolution", "convolution_backward", "cudnn_convolution")


class _Rounding(TorchDispatchMode):
    """Rounds, in place, the float32 result of every operation that makes a
    new tensor (no views, no in-place updates, nothing that shares an
    operand's storage) to the control's precision."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func._schema.is_mutable:
            return out
        if MODE.lowp:
            rnd = _fp8_
        elif func._overloadpacket.__name__ in _CONV:
            rnd = _bf16_
        else:
            rnd = _tf32_
        inputs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(o, torch.Tensor) and o.dtype == torch.float32 and o.numel()
                    and o.untyped_storage().data_ptr() not in inputs):
                rnd(o)
        return out


def _tf32_(x: torch.Tensor) -> None:
    x.view(torch.int32).add_(0x1000).bitwise_and_(~0x1FFF)


def _bf16_(x: torch.Tensor) -> None:
    x.copy_(x.to(torch.bfloat16))


def _fp8_(x: torch.Tensor) -> None:
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    x.div_(scale)
    x.copy_(x.to(torch.float8_e4m3fn))
    x.mul_(scale)


@contextlib.contextmanager
def block(use_bf16: bool):
    saved = MODE.lowp
    MODE.lowp = use_bf16
    try:
        yield
    finally:
        MODE.lowp = saved


def block_dtype(use_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if (MODE.stated and use_bf16) else torch.float32


def _straight_through(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 explicit mantissa bits (nearest, ties away)."""
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return _straight_through(x, q)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return _straight_through(x, x.detach().to(torch.bfloat16).to(x.dtype))


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale for the tensor (its largest magnitude maps
    to the format's largest finite value)."""
    xd = x.detach()
    scale = xd.abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (xd / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return _straight_through(x, q)


def conv_operands(x: torch.Tensor, w: torch.Tensor):
    if not MODE.control:
        return x, w
    rnd = round_fp8 if MODE.lowp else round_bf16
    return rnd(x), rnd(w)


def mm_operands(x: torch.Tensor, w: torch.Tensor):
    if not MODE.control:
        return x, w
    return round_tf32(x), round_tf32(w)


def render_input(rgba: torch.Tensor) -> torch.Tensor:
    return round_tf32(rgba) if MODE.control else rgba
