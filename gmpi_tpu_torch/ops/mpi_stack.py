"""One synthesis block's update of the generator's MPI skip stack (K9).

``SynthesisBlock.forward`` (``models/generator.py``) carries the MPI of the
blocks so far, ``[B, L * 4, H, W]`` float32, and each block adds its heads to
the stack's 2x FIR upsample::

    stack_out = upsample2d(stack_in, resample_filter) + heads

The heads, at the block's resolution R: the plane-shared RGB ``torgb`` on the
foreground planes (the background RGB on plane L - 1 where the block
synthesizes a separate background), and on the alpha channel the
``toalpha`` output at alpha resolutions, zero above them.  At the last block
``Generator.synthesize``'s final activation follows (``final_act``: ``none``,
``sigmoid`` or ``tanh``), and with ``alpha_full`` plane L - 1's alpha is set
to 1, so the finished MPI is written once.

:func:`mpi_stack` picks its route from its inputs: on a CUDA tensor, where
autograd records nothing through the stack or the heads, the hand-written
kernel of ``csrc/mpi_stack.cu`` (one launch a block, counted in
``LAUNCHES["mpi_stack"]``; inputs it cannot take raise); everywhere else :func:`mpi_stack_ref`, the chain
of library ops the generator ran before the kernel (``upsample2d``, the
concatenations, the add, the activation), which stays differentiable.  The
per-plane ``torgba`` head (``only_alpha=False``) takes :func:`add_to_stack`,
the chain's second half.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gmpi_tpu_torch.ops import _build
from gmpi_tpu_torch.ops._build import LAUNCHES  # noqa: F401  (launches by kernel; re-exported)
from gmpi_tpu_torch.ops.upfirdn2d import upsample2d

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P]  # of gmpi_mpi_stack; the last is the stream
ACTS = {None: -1, "none": 0, "sigmoid": 1, "tanh": 2}  # the kernel's codes
# threads (a pair of rows and four columns of one channel each) below which
# the kernel cuts the planes into chunks: enough loads in flight to keep the
# card's memory busy (132 SMs x 2,048 resident threads, twice over)
CHUNK_THREADS = 1 << 19


def finish(img: torch.Tensor, final_act: str, alpha_full: bool) -> torch.Tensor:
    """``Generator.synthesize``'s final activation of the raw stack ``[B, L *
    4, R, R]``, then plane L - 1's alpha set to 1 where ``alpha_full``."""
    if final_act == "none":
        img = (torch.clamp(img, -1.0, 1.0) + 1.0) / 2.0
    elif final_act == "sigmoid":
        img = torch.sigmoid(img)
    elif final_act == "tanh":
        img = (torch.tanh(img) + 1.0) / 2.0
    else:
        raise ValueError(final_act)
    if alpha_full:
        ones = torch.ones_like(img[:, :1])
        img = torch.cat([img[:, :-1], ones], dim=1)
    return img


def plane_heads(rgb: torch.Tensor, background: Optional[torch.Tensor],
                alpha: Optional[torch.Tensor], n_planes: int) -> torch.Tensor:
    """The heads as one ``[B, L * 4, R, R]`` float32 tensor: the RGB expanded
    to the planes (and concatenated with the background's), the alpha (zero
    without one) cast to the RGB's dtype, concatenated, then float32."""
    bs, _, res, _ = rgb.shape
    if background is not None:
        fg = rgb[:, None].expand(bs, n_planes - 1, 3, res, res)
        cur_rgb = torch.cat([fg.to(background.dtype), background[:, None]], dim=1)
    else:
        cur_rgb = rgb[:, None].expand(bs, n_planes, 3, res, res)
    cur_rgb = cur_rgb.reshape(bs * n_planes, 3, res, res)
    if alpha is None:
        alpha = torch.zeros((bs * n_planes, 1, res, res), dtype=cur_rgb.dtype,
                            device=cur_rgb.device)
    y = torch.cat([cur_rgb, alpha.to(cur_rgb.dtype)], dim=1)
    return y.reshape(bs, n_planes * 4, res, res).to(torch.float32)


def _check_finish(final_act, alpha_full) -> None:
    if final_act not in ACTS:
        raise ValueError(final_act)
    if alpha_full and final_act is None:
        raise ValueError("alpha_full finishes the MPI at the last block: it needs a final_act")


def add_to_stack(stack: Optional[torch.Tensor], y: torch.Tensor, resample_filter: torch.Tensor,
                 final_act: Optional[str] = None, alpha_full: bool = False) -> torch.Tensor:
    """``upsample2d(stack) + y`` (``y`` alone without a stack), finished at
    the last block (``final_act`` not None): plain PyTorch."""
    _check_finish(final_act, alpha_full)
    img = upsample2d(stack, resample_filter) + y if stack is not None else y
    return img if final_act is None else finish(img, final_act, alpha_full)


def mpi_stack_ref(stack: Optional[torch.Tensor], rgb: torch.Tensor,
                  background: Optional[torch.Tensor], alpha: Optional[torch.Tensor],
                  resample_filter: torch.Tensor, n_planes: int, final_act: Optional[str] = None,
                  alpha_full: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`mpi_stack` (arguments and result as
    there): the library chain, differentiable."""
    return add_to_stack(stack, plane_heads(rgb, background, alpha, n_planes), resample_filter,
                        final_act, alpha_full)


def _check_args(stack, rgb, background, alpha, n_planes, final_act, alpha_full) -> None:
    if rgb.ndim != 4 or rgb.shape[1] != 3 or rgb.shape[2] != rgb.shape[3]:
        raise ValueError(f"rgb: expected [B, 3, R, R], got {tuple(rgb.shape)}")
    bs, _, res, _ = rgb.shape
    if background is not None and background.shape != rgb.shape:
        raise ValueError(f"background {tuple(background.shape)} is not rgb's {tuple(rgb.shape)}")
    if alpha is not None and alpha.shape != (bs * n_planes, 1, res, res):
        raise ValueError(f"alpha: expected {(bs * n_planes, 1, res, res)}, got "
                         f"{tuple(alpha.shape)}")
    if stack is not None and stack.shape != (bs, n_planes * 4, res // 2, res // 2):
        raise ValueError(f"stack: expected {(bs, n_planes * 4, res // 2, res // 2)}, got "
                         f"{tuple(stack.shape)}")
    _check_finish(final_act, alpha_full)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def takes_kernel(stack, rgb, background, alpha) -> bool:
    """Whether :func:`mpi_stack` launches the kernel on these inputs: on a
    card, where autograd records nothing through them (the kernel has no
    backward)."""
    inputs = [t for t in (stack, rgb, background, alpha) if t is not None]
    return _on_card(rgb) and not (torch.is_grad_enabled()
                                  and any(t.requires_grad for t in inputs))


def _check_kernel_args(stack, rgb, background, alpha, resample_filter) -> None:
    """What the kernel takes: a 4 x 4 filter, a resolution in fours, a
    float32 stack and float32 or bf16 heads.  Anything else raises on the
    card rather than falling back to the plain form."""
    if tuple(resample_filter.shape) != (4, 4):
        raise ValueError(f"mpi_stack on a card: resample_filter must be 4 x 4, got "
                         f"{tuple(resample_filter.shape)}")
    if rgb.shape[-1] % 4:
        raise ValueError(f"mpi_stack on a card: the resolution must be a multiple of 4, got "
                         f"{rgb.shape[-1]}")
    if stack is not None and stack.dtype != torch.float32:
        raise ValueError(f"mpi_stack on a card: stack must be float32, got {stack.dtype}")
    for name, t in (("rgb", rgb), ("background", background), ("alpha", alpha)):
        if t is not None and t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"mpi_stack on a card: {name} must be float32 or bfloat16, got "
                             f"{t.dtype}")


def plane_chunk(batch: int, n_planes: int, res: int) -> int:
    """The planes one kernel thread walks: all, unless the pixels give fewer
    than ``CHUNK_THREADS`` threads."""
    threads = batch * 4 * (res // 2) * (res // 4)
    chunks = min(n_planes, -(-CHUNK_THREADS // threads))
    return -(-n_planes // chunks)


def _launch(stack, rgb, background, alpha, resample_filter, n_planes, final_act, alpha_full):
    # the chain casts the foreground RGB to the background's dtype and the
    # alpha to the RGB's before widening all to float32: where that narrows
    # to bf16, round here; a widening is exact and the kernel does it
    narrow = (background if background is not None else rgb).dtype
    if narrow == torch.bfloat16:
        rgb = rgb.to(narrow)
        alpha = alpha.to(narrow) if alpha is not None else None
    bs, _, res, _ = rgb.shape
    tensors = [t.contiguous() if t is not None else None
               for t in (stack, resample_filter, rgb, background, alpha)]
    stack, f, rgb, background, alpha = tensors
    if any(t is not None and t.device != rgb.device for t in tensors):
        raise ValueError("mpi_stack: the stack, the heads and the filter must share a device")
    f = f.to(torch.float32)
    out = torch.empty((bs, n_planes * 4, res, res), dtype=torch.float32, device=rgb.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    def bf16(t):
        return int(t is not None and t.dtype == torch.bfloat16)

    _build.launch("mpi_stack", _ARGTYPES, rgb.device, ptr(stack),
                  ptr(f) if stack is not None else None, ptr(rgb), ptr(background), ptr(alpha),
                  out.data_ptr(), bs, n_planes, res, plane_chunk(bs, n_planes, res), bf16(rgb),
                  bf16(background), bf16(alpha), ACTS[final_act], int(alpha_full))
    return out


def mpi_stack(stack: Optional[torch.Tensor], rgb: torch.Tensor,
              background: Optional[torch.Tensor], alpha: Optional[torch.Tensor],
              resample_filter: torch.Tensor, n_planes: int, final_act: Optional[str] = None,
              alpha_full: bool = False) -> torch.Tensor:
    """One block's new MPI stack ``[B, L * 4, R, R]`` float32.

    stack ``[B, L * 4, R/2, R/2]`` float32, the blocks' stack so far (None at
    the first block); rgb ``[B, 3, R, R]`` the plane-shared RGB head;
    background ``[B, 3, R, R]`` the background plane's RGB (None: every plane
    is foreground); alpha ``[B * L, 1, R, R]`` (None: zero); resample_filter
    the block's 2-D FIR filter (``setup_filter``), upsampling by 2 with gain
    4; final_act None for a block before the last, else the generator's
    ``final_img_act``; alpha_full (only with a final_act) sets plane L - 1's
    alpha to 1 after it.  The kernel where :func:`takes_kernel` says so (on
    inputs it cannot take, a ValueError), else :func:`mpi_stack_ref`."""
    _check_args(stack, rgb, background, alpha, n_planes, final_act, alpha_full)
    if takes_kernel(stack, rgb, background, alpha):
        _check_kernel_args(stack, rgb, background, alpha, resample_filter)
        return _launch(stack, rgb, background, alpha, resample_filter, n_planes, final_act,
                       alpha_full)
    return mpi_stack_ref(stack, rgb, background, alpha, resample_filter, n_planes, final_act,
                         alpha_full)
