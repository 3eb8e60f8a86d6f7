"""Fused MPI warp+composite renderer: forward, backward and the autograd
Function around them (port of the TPU kernels behind ``make_fused_renderer``
in ``gmpi_tpu/ops/pallas_warp.py``).

Four wrappers, each with its hand-written CUDA kernel and, beside it, a plain
PyTorch version that repeats the kernel's arithmetic:

* :func:`warp_composite_fwd` -> ``csrc/fused_fwd.cu`` (``_fwd_kernel``): warp
  every plane into the view and over-composite front to back; in its training
  form it also returns the VJP residual and, with ``early_out="grad"``, the
  per-pixel count of live planes.  Views may share texture stacks in groups
  (view ``v`` reads stack ``v // k``).  Its textures are f32 or, in the
  bf16-texture form (the TPU kernel's ``compute_dtype``), bf16;
* :func:`composite_bwd` -> ``csrc/composite_bwd.cu`` (``_composite_bwd_fat_kernel``
  and ``_composite_bwd_kernel``): cotangents of the composited outputs back
  onto the warped samples;
* :func:`warp_splat` -> ``csrc/splat.cu`` (``_splat_plane_kernel`` and
  ``_splat_kernel``): the warp's transpose, sample cotangents onto texels,
  scattered pixel by pixel: a tile's taps summed in its texel box in shared
  memory, the box added into ``d_tex`` with 16-byte reductions;
* :func:`warp_adjoint` -> ``csrc/adjoint.cu`` (``_adj_kernel``): the same
  transpose gathered texel by texel; no atomics, bitwise repeatable.

A CUDA tensor goes to the kernel or the call raises; a CPU tensor goes to the
plain version (``*_ref``), which is what the CPU tests and the on-card
comparison run.  Each kernel launch adds one to its entry of ``LAUNCHES``.
:class:`FusedRender` ties them into one differentiable function of the plane
RGBA: forward, composite backward, then the splat or, given adjoint bands,
the adjoint.

Layout is the port's public ``[V, C, H, W]``: the TPU kernels' subtile-flat
pixel layout, DMA bands, forward and splat band planning and per-plane
liveness bitmap have no counterpart.  What holds the two gathers back on an
H100 is instruction issue and the latency of dependent loads from device
memory, not its bytes, so both work from shared memory: a block of the
forward finds, from its pixel tile's extreme rays, each plane's box of texels
and copies it in asynchronously, a group of planes ahead of the compositing;
a block of the adjoint owns a tile of texels, finds that tile's box of pixels
with a few cooperative searches of the ray fields, stages it the same way,
and each thread sums its two texels' pixels from there.  Neither needs a plan
made on the host: :func:`plan_adjoint` only checks, once per pose range, that
the ray fields are monotone as the adjoint's search assumes, and measures the
windows that :class:`AdjointBands` reports.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from gmpi_tpu_torch.ops import _build
from gmpi_tpu_torch.ops._build import LAUNCHES  # noqa: F401  (launches by kernel; re-exported)

EPS = 1e-10          # composite epsilon (the reference's ``gmpi/core/mpi.py:421``)
EARLY_OUT_T = 1e-6   # inference: a pixel stops once its transmittance falls below this
# Grad-safe occlusion threshold: a pixel's planes are skipped once S / M < tau,
# S the product and M the minimum of the factors max(1 - a, 0) + eps so far.
# Every gradient path out of a plane divides by at most one such factor, and
# S / M removes exactly the smallest, so what is dropped is O(tau) absolute.
GRAD_TAU = 1e-7
MAX_PLANES = 2048    # the per-plane tables are staged in shared memory (40 B a plane)


def plane_affine(dhw: torch.Tensor, eye_pos: torch.Tensor, tex_h: int, tex_w: int
                 ) -> torch.Tensor:
    """Per-plane affine split of the homography's texel coordinates,
    ``fx = Ax * rx + Bx``, ``fy = Ay * ry + By`` with ``r = ray / ray_z``
    (align_corners=True).

    dhw ``[L, 3]``, eye_pos ``[3]`` or ``[V, 3]`` -> scal ``[L, 6]`` or
    ``[V, L, 6]`` f32: ``(Ax, Bx, Ay, By, dscale, 0)``, ``dscale = d - eye_z``.
    """
    eye = eye_pos[..., None, :]  # broadcast over planes
    d, h, w = dhw[:, 0], dhw[:, 1], dhw[:, 2]
    dscale = d - eye[..., 2]
    ax = (tex_w - 1.0) * dscale / w
    bx = (tex_w - 1.0) * (eye[..., 0] / w + 0.5)
    ay = (tex_h - 1.0) * dscale / h
    by = (tex_h - 1.0) * (eye[..., 1] / h + 0.5)
    ax, bx, ay, by, dscale = torch.broadcast_tensors(ax, bx, ay, by, dscale)
    return torch.stack([ax, bx, ay, by, dscale, torch.zeros_like(dscale)],
                       dim=-1).to(torch.float32)


def ray_fields(ray_dir: torch.Tensor, z_dir: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plane-independent per-pixel ray fields ``(rx, ry, q)`` ``[V, H, W]``:
    ``r{x,y} = ray_{x,y} / ray_z`` and ``q = (ray . z_dir) / ray_z``, so that
    the depth of plane l is ``dscale_l * q``."""
    rz = ray_dir[:, 2]
    q = torch.einsum("vchw,vc->vhw", ray_dir, z_dir) / rz
    return ray_dir[:, 0] / rz, ray_dir[:, 1] / rz, q


def sample_bilinear(tex_l: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``tex_l [S, 4, Th, Tw]`` at texel coordinates
    ``fx, fy [V, H, W]``, zeros outside: ``[V, 4, H, W]`` in ``fx``'s dtype.  ``V`` is a
    multiple of ``S``: view ``v`` samples texture ``v // (V // S)``.

    A float32 texture takes the weights ``(1 - wx, wx)``, ``(1 - wy, wy)``.  A
    bfloat16 texture takes those of the JAX kernel's bf16 form
    (``pallas_warp.py:683-741`` under its ``bf16x3`` contraction): the x-hats
    computed in fp32 and rounded to bf16, ``bf16(1 - wx)`` and ``bf16(1 - (1 -
    wx))`` as ``1 - |fx - i|`` gives them, so each x product is exact; the
    y-hats ``1 - wy`` and ``1 - (1 - wy)`` in fp32; every product and sum
    rounded to fp32 in that order."""
    v, h, w = fx.shape
    th, tw = tex_l.shape[-2:]
    flat = tex_l.reshape(tex_l.shape[0], 4, th * tw)
    if flat.shape[0] not in (1, v):
        flat = flat.repeat_interleave(_views_per_stack(flat.shape[0], v), dim=0)
    flat = flat.expand(v, 4, th * tw)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]

    def tap(yy, xx):
        valid = (xx >= 0) & (xx <= tw - 1) & (yy >= 0) & (yy <= th - 1)
        idx = (yy.clamp(0, th - 1) * tw + xx.clamp(0, tw - 1)).nan_to_num(0.0).long()
        vals = torch.gather(flat, 2, idx.reshape(v, 1, h * w).expand(v, 4, h * w))
        return torch.where(valid[:, None], vals.reshape(v, 4, h, w).to(fx.dtype), 0.0)

    if tex_l.dtype == torch.bfloat16:
        r = 1.0 - wx
        hx0, hx1 = (r.to(torch.bfloat16).to(r.dtype),
                    (1.0 - r).to(torch.bfloat16).to(r.dtype))
        hy0 = 1.0 - wy
        hy1 = 1.0 - hy0
    else:
        hx0, hx1, hy0, hy1 = 1.0 - wx, wx, 1.0 - wy, wy
    top = tap(y0, x0) * hx0 + tap(y0, x0 + 1) * hx1
    bot = tap(y0 + 1, x0) * hx0 + tap(y0 + 1, x0 + 1) * hx1
    return top * hy0 + bot * hy1


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as the kernels' ``fmaf`` (and
    the JAX kernel's fused multiply-add) computes it: the product of two
    float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _views_per_stack(n_stacks: int, n_views: int) -> int:
    """``k`` of the grouping "view ``v`` reads stack ``v // k``"."""
    if n_stacks < 1 or n_views % n_stacks:
        raise ValueError(f"tex: {n_views} views are not a multiple of {n_stacks} texture stacks")
    return n_views // n_stacks


def _factor(alpha: torch.Tensor, eps: float) -> torch.Tensor:
    """Composite factor ``max(1 - a, 0) + eps`` of the gradient path (equal to
    ``1 - a + eps`` for ``a <= 1``; never 0)."""
    return torch.clamp(1.0 - alpha, min=0.0) + eps


def warp_composite_fwd_ref(tex: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                           q: torch.Tensor, scal: torch.Tensor,
                           early_out: Union[bool, str] = True, with_disp: bool = True,
                           eps: float = EPS, with_warped: bool = False
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward kernel, the same arithmetic: per
    plane an index+gather bilinear sample (a bf16 ``tex`` with the bf16 form's
    weights, :func:`sample_bilinear`), then a sequential over-composite in the
    rays' dtype; a pixel stops updating under the ``early_out`` rule.  Residual slots of planes a pixel did not reach hold NaN (the kernel
    leaves them unwritten), so a consumer that reads one shows.  Arguments and
    results as :func:`warp_composite_fwd`."""
    v = rx.shape[0]
    _views_per_stack(tex.shape[0], v)
    n_l = scal.shape[1]
    grad_rule = early_out == "grad"
    zeros = torch.zeros_like(rx)
    color = torch.zeros((v, 3) + rx.shape[1:], dtype=rx.dtype, device=rx.device)
    acc_d, acc_p, t = zeros, zeros, torch.ones_like(rx)
    s_clamped, m_min = torch.ones_like(rx), torch.ones_like(rx)
    n_live = torch.zeros(rx.shape, dtype=torch.int32, device=rx.device)
    alive = torch.ones(rx.shape, dtype=torch.bool, device=rx.device)
    warped = []
    qinv = 1.0 / q
    for l in range(n_l):
        s = scal[:, l, :, None, None]  # [V, 6, 1, 1]
        smp = sample_bilinear(tex[:, l], _fma(s[:, 0], rx, s[:, 1]), _fma(s[:, 2], ry, s[:, 3]))
        a = smp[:, 3]
        w = a * t
        new = (color + w[:, None] * smp[:, :3], acc_d + w * (s[:, 4] * q),
               acc_p + w * ((1.0 / s[:, 4]) * qinv) if with_disp else acc_p,
               t * ((1.0 - a) + eps))
        if early_out:
            alive = alive & ((s_clamped / m_min >= GRAD_TAU) if grad_rule
                             else (t >= EARLY_OUT_T))
            new = (torch.where(alive[:, None], new[0], color),) + tuple(
                torch.where(alive, n, o) for n, o in zip(new[1:], (acc_d, acc_p, t)))
            if with_warped:
                smp = torch.where(alive[:, None], smp, float("nan"))
        if grad_rule:
            one_m = _factor(a, eps)
            s_clamped = torch.where(alive, s_clamped * one_m, s_clamped)
            m_min = torch.where(alive, torch.minimum(m_min, one_m), m_min)
        n_live = n_live + alive.to(torch.int32)
        warped.append(smp)
        color, acc_d, acc_p, t = new
    outs = (color, acc_d[:, None]) + ((acc_p[:, None],) if with_disp else ())
    outs = outs + (t[:, None],)
    if with_warped:
        outs = outs + (torch.stack(warped, dim=1),)
    return outs + ((n_live,) if grad_rule else ())


def _check(name: str, x: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # of the C entry point gmpi_<name> of csrc/<name>.cu; the last is the stream
    # ..., early_out, with_disp, tex_bf16 (1: tex is bfloat16), eps, stream
    "fused_fwd": [_P, ctypes.c_longlong] + [_P] * 10 + [_I] * 10 + [_F, _P],
    "composite_bwd": [_P] * 9 + [_I] * 4 + [_F, _I, _F, _P],
    "splat": [_P] * 6 + [_I] * 7 + [_P],
    "adjoint": [_P] * 5 + [_I] * 6 + [_P],
}


def _launch(name: str, dev: torch.device, *args) -> None:
    _build.launch(name, _ARGTYPES[name], dev, *args)


def warp_composite_fwd(tex: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                       q: torch.Tensor, scal: torch.Tensor,
                       early_out: Union[bool, str] = True, with_disp: bool = True,
                       eps: float = EPS, with_warped: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """Warp + over-composite all planes of each view, front to back.

    tex ``[S, L, 4, Th, Tw]`` f32 or bf16 RGBA planes (plane 0 nearest; bf16:
    the kernel's bf16-texture form, fp32 weights and sums as
    :func:`sample_bilinear` says, half the texture bytes): ``S`` texture
    stacks for ``V = S * k`` views, view ``v`` reading stack ``v // k`` (``k =
    1``: a stack per view; ``S = 1``: one stack for every view; in between:
    each stack rendered into ``k`` consecutive views, read from device memory
    once).  An ``expand`` of one stack over the views (``[V, ...]``, stride 0)
    is read as ``S = 1``.  rx, ry, q ``[V, H, W]`` from :func:`ray_fields`;
    scal ``[V, L, 6]`` from :func:`plane_affine`.

    ``early_out``: ``True`` stops a pixel once its transmittance is below
    ``EARLY_OUT_T`` (inference); ``"grad"`` stops it by the grad-safe rule
    ``S / M < GRAD_TAU`` (training; see ``GRAD_TAU``); ``False`` never.

    Returns premultiplied ``(color [V,3,H,W], depth [V,1,H,W], [disp
    [V,1,H,W] with with_disp,] trans [V,1,H,W])``; then, with ``with_warped``,
    the VJP residual ``warped [V, L, 4, H, W]`` (the sample of every plane a
    pixel reached; other slots unwritten); then, with ``early_out="grad"``,
    ``n_live [V, H, W]`` int32, the number of planes each pixel reached.  CPU
    tensors run :func:`warp_composite_fwd_ref`; CUDA tensors launch the kernel.
    """
    if early_out not in (False, True, "grad"):
        raise ValueError(f"early_out: expected False, True or 'grad', got {early_out!r}")
    if tex.device.type == "cpu":
        return warp_composite_fwd_ref(tex, rx, ry, q, scal, early_out, with_disp, eps,
                                      with_warped)
    if tex.device.type != "cuda":
        raise ValueError(f"warp_composite_fwd: unsupported device {tex.device}")
    if tex.ndim != 5 or tex.shape[2] != 4:
        raise ValueError(f"tex: expected [S, L, 4, Th, Tw], got {tuple(tex.shape)}")
    v, h, w = rx.shape
    n_stacks, n_l, th, tw = tex.shape[0], tex.shape[1], tex.shape[3], tex.shape[4]
    if tex.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tex: expected float32 or bfloat16, got {tex.dtype}")
    if n_stacks > 1 and tex.stride(0) == 0:
        n_stacks = 1  # one stack expanded over the views
    k = _views_per_stack(n_stacks, v)
    if not tex[0].is_contiguous():
        raise ValueError("tex: expected contiguous [L, 4, Th, Tw] stacks")
    stack_stride = tex.stride(0) if n_stacks > 1 else 0  # packed, or a slab's parent
    if n_stacks > 1 and stack_stride < n_l * 4 * th * tw:
        raise ValueError(f"tex: view stride {stack_stride} is neither 0 (one stack expanded over "
                         f"the views) nor at least one stack ({n_l * 4 * th * tw})")
    if not 1 <= n_l <= MAX_PLANES:
        raise ValueError(f"tex: {n_l} planes, supported 1..{MAX_PLANES}")
    dev = tex.device
    for name, x in (("rx", rx), ("ry", ry), ("q", q)):
        _check(name, x, (v, h, w), dev)
    _check("scal", scal, (v, n_l, 6), dev)

    grad_rule = early_out == "grad"
    color = torch.empty((v, 3, h, w), dtype=torch.float32, device=dev)
    depth, trans = (torch.empty((v, 1, h, w), dtype=torch.float32, device=dev)
                    for _ in range(2))
    disp = torch.empty((v, 1, h, w), dtype=torch.float32, device=dev) if with_disp else None
    warped = (torch.empty((v, n_l, 4, h, w), dtype=torch.float32, device=dev)
              if with_warped else None)
    n_live = torch.empty((v, h, w), dtype=torch.int32, device=dev) if grad_rule else None
    _launch("fused_fwd", dev,
            tex.data_ptr(), stack_stride, rx.data_ptr(), ry.data_ptr(), q.data_ptr(),
            scal.data_ptr(), color.data_ptr(), depth.data_ptr(), _ptr(disp), trans.data_ptr(),
            _ptr(warped), _ptr(n_live), v, n_l, th, tw, h, w, k,
            2 if grad_rule else int(bool(early_out)), int(bool(with_disp)),
            int(tex.dtype == torch.bfloat16), eps)
    outs = (color, depth) + ((disp,) if with_disp else ()) + (trans,)
    return outs + ((warped,) if with_warped else ()) + ((n_live,) if grad_rule else ())


def composite_bwd_ref(warped: torch.Tensor, q: torch.Tensor, scal: torch.Tensor,
                      g_color: torch.Tensor, g_depth: Optional[torch.Tensor] = None,
                      g_disp: Optional[torch.Tensor] = None,
                      g_trans: Optional[torch.Tensor] = None,
                      n_live: Optional[torch.Tensor] = None,
                      grad_tau: Optional[float] = None, eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch version of the composite backward kernel: the same two
    passes over the planes (exclusive transmittance and running minimum factor
    front to back; cotangents back to front with the suffix sum added to after
    use), masked with selects so that NaN in a dead residual slot gives exact
    zeros.  Arguments and result as :func:`composite_bwd`."""
    n_l = warped.shape[1]
    zero = torch.zeros_like(q)
    reached = [None if n_live is None else (l < n_live) for l in range(n_l)]
    t, m = torch.ones_like(q), torch.ones_like(q)
    t_excl, m_excl = [], []
    for l in range(n_l):
        t_excl.append(t)
        m_excl.append(m)
        one_m = _factor(warped[:, l, 3], eps)
        if n_live is not None:
            one_m = torch.where(reached[l], one_m, 1.0)
        t, m = t * one_m, torch.minimum(m, one_m)
    gt_term = None if g_trans is None else g_trans * t
    qinv = None if g_disp is None else 1.0 / q
    u = zero
    out = [None] * n_l
    for l in range(n_l - 1, -1, -1):
        rgb, a = warped[:, l, :3], warped[:, l, 3]
        dsc = scal[:, l, 4, None, None]
        e = g_color[:, 0] * rgb[:, 0] + g_color[:, 1] * rgb[:, 1] + g_color[:, 2] * rgb[:, 2]
        if g_depth is not None:
            e = e + g_depth * (dsc * q)
        if g_disp is not None:
            e = e + g_disp * ((1.0 / dsc) * qinv)
        one_m = _factor(a, eps)
        w = a * t_excl[l]
        d_alpha = t_excl[l] * e - u / one_m
        if g_trans is not None:
            d_alpha = d_alpha - gt_term / one_m
        live = reached[l]
        if grad_tau is not None:
            live_px = (t_excl[l] / m_excl[l]) >= grad_tau
            live = live_px if live is None else live & live_px
        if live is not None:
            e = torch.where(live, e, zero)
            w = torch.where(live, w, zero)
            d_alpha = torch.where(live, d_alpha, zero)
        out[l] = torch.cat([w[:, None] * g_color, d_alpha[:, None]], dim=1)
        u = u + w * e
    return torch.stack(out, dim=1)


def composite_bwd(warped: torch.Tensor, q: torch.Tensor, scal: torch.Tensor,
                  g_color: torch.Tensor, g_depth: Optional[torch.Tensor] = None,
                  g_disp: Optional[torch.Tensor] = None,
                  g_trans: Optional[torch.Tensor] = None,
                  n_live: Optional[torch.Tensor] = None,
                  grad_tau: Optional[float] = None, eps: float = EPS) -> torch.Tensor:
    """Backward of the over-composite: cotangents of the composited outputs
    onto the warped per-plane samples.

    warped ``[V, L, 4, H, W]`` f32, the forward's residual; q ``[V, H, W]``;
    scal ``[V, L, 6]``; g_color ``[V, 3, H, W]``; g_depth, g_disp, g_trans
    ``[V, H, W]`` or None (cotangents of the premultiplied depth, disparity
    and transmittance outputs).  With ``T_l`` the exclusive transmittance
    over factors ``f = max(1 - a, 0) + eps``, ``w_l = a_l T_l``, ``e_l =
    g_color . rgb_l + g_depth dsc_l q + g_disp / (dsc_l q)`` and ``u_l =
    sum_{m>l} w_m e_m``::

        d rgb_l = w_l g_color
        d a_l   = T_l e_l - (u_l + g_trans T_total) / f_l

    ``n_live [V, H, W]`` int32 (needs ``grad_tau``): planes ``l >= n_live``
    of a pixel were never reached, their slots are not read and get exact
    zeros.  ``grad_tau``: planes with ``T_l / M_l < grad_tau`` (``M_l`` the
    minimum factor in front) get exact zeros too.  Returns ``d_samp
    [V, L, 4, H, W]``.  CPU tensors run :func:`composite_bwd_ref`; CUDA
    tensors launch the kernel.
    """
    if n_live is not None and grad_tau is None:
        raise ValueError("composite_bwd: n_live masking requires grad_tau")
    if warped.device.type == "cpu":
        return composite_bwd_ref(warped, q, scal, g_color, g_depth, g_disp, g_trans, n_live,
                                 grad_tau, eps)
    if warped.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {warped.device}")
    if warped.ndim != 5 or warped.shape[2] != 4:
        raise ValueError(f"warped: expected [V, L, 4, H, W], got {tuple(warped.shape)}")
    v, n_l, _, h, w = warped.shape
    if not 1 <= n_l <= MAX_PLANES:
        raise ValueError(f"warped: {n_l} planes, supported 1..{MAX_PLANES}")
    dev = warped.device
    _check("warped", warped, (v, n_l, 4, h, w), dev)
    _check("q", q, (v, h, w), dev)
    _check("scal", scal, (v, n_l, 6), dev)
    _check("g_color", g_color, (v, 3, h, w), dev)
    for name, x in (("g_depth", g_depth), ("g_disp", g_disp), ("g_trans", g_trans)):
        if x is not None:
            _check(name, x, (v, h, w), dev)
    if n_live is not None:
        _check("n_live", n_live, (v, h, w), dev, torch.int32)
    d_samp = torch.empty_like(warped)
    _launch("composite_bwd", dev,
            warped.data_ptr(), q.data_ptr(), scal.data_ptr(), g_color.data_ptr(),
            _ptr(g_depth), _ptr(g_disp), _ptr(g_trans), _ptr(n_live), d_samp.data_ptr(),
            v, n_l, h, w, eps, int(grad_tau is not None), grad_tau or 0.0)
    return d_samp


def warp_splat_ref(d_samp: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                   scal: torch.Tensor, tex_h: int, tex_w: int,
                   n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the splat kernel: per plane and tap, one
    ``index_add_`` of weight times cotangent at the texel index the forward
    read (the taps it read as zeros keep weight 0).  Arguments and result as
    :func:`warp_splat`."""
    v, n_l, _, h, w = d_samp.shape
    base = (torch.arange(v, device=d_samp.device) * (tex_h * tex_w)).reshape(v, 1, 1)
    planes = []
    for l in range(n_l):
        g = d_samp[:, l]
        if n_live is not None:
            g = torch.where((l < n_live)[:, None], g, 0.0)
        s = scal[:, l, :, None, None]
        fx, fy = _fma(s[:, 0], rx, s[:, 1]), _fma(s[:, 2], ry, s[:, 3])
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = fx - x0, fy - y0
        acc = torch.zeros((4, v * tex_h * tex_w), dtype=d_samp.dtype, device=d_samp.device)
        for yy, wgt_y in ((y0, 1.0 - wy), (y0 + 1, wy)):
            for xx, wgt_x in ((x0, 1.0 - wx), (x0 + 1, wx)):
                valid = (xx >= 0) & (xx <= tex_w - 1) & (yy >= 0) & (yy <= tex_h - 1)
                wgt = torch.where(valid, wgt_y * wgt_x, 0.0).nan_to_num(0.0)
                idx = (yy.clamp(0, tex_h - 1) * tex_w + xx.clamp(0, tex_w - 1)).nan_to_num(0.0)
                vals = (wgt[:, None] * g).permute(1, 0, 2, 3).reshape(4, -1)
                acc.index_add_(1, (idx.long() + base).reshape(-1), vals)
        planes.append(acc.reshape(4, v, tex_h, tex_w).permute(1, 0, 2, 3))
    return torch.stack(planes, dim=1)


def _launch_splat(d_samp, rx, ry, scal, n_live, tex_h: int, tex_w: int,
                  boxed: bool = True) -> torch.Tensor:
    """Launch the splat kernel on checked CUDA tensors into a zeroed ``d_tex``.
    ``boxed=False`` makes every block add its taps into ``d_tex`` directly, the
    kernel's path for a texel box beyond its shared memory (tests and timing)."""
    v, n_l, _, h, w = d_samp.shape
    d_tex = torch.zeros((v, n_l, 4, tex_h, tex_w), dtype=torch.float32, device=d_samp.device)
    _launch("splat", d_samp.device,
            d_samp.data_ptr(), rx.data_ptr(), ry.data_ptr(), scal.data_ptr(), _ptr(n_live),
            d_tex.data_ptr(), v, n_l, tex_h, tex_w, h, w, int(boxed))
    return d_tex


def warp_splat(d_samp: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor, scal: torch.Tensor,
               tex_h: int, tex_w: int, n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact transpose of the forward's bilinear warp: sample cotangents
    ``d_samp [V, L, 4, H, W]`` f32 -> texel cotangents ``d_tex [V, L, 4, tex_h,
    tex_w]``, with the forward's coordinates ``fx = Ax rx + Bx``, ``fy = Ay ry
    + By`` and bounds.  rx, ry ``[V, H, W]``; scal ``[V, L, 6]``; ``n_live
    [V, H, W]`` int32 or None: planes ``l >= n_live`` of a pixel are skipped
    unread.  CPU tensors run :func:`warp_splat_ref`; CUDA tensors launch the
    kernel: a block sums the taps of a 32 x 32 pixel tile in its box of texels
    in shared memory and adds the box into a zeroed ``d_tex``; its fp32 sums
    are repeatable to rounding only, not bitwise."""
    if d_samp.device.type == "cpu":
        return warp_splat_ref(d_samp, rx, ry, scal, tex_h, tex_w, n_live)
    if d_samp.device.type != "cuda":
        raise ValueError(f"warp_splat: unsupported device {d_samp.device}")
    if d_samp.ndim != 5 or d_samp.shape[2] != 4:
        raise ValueError(f"d_samp: expected [V, L, 4, H, W], got {tuple(d_samp.shape)}")
    v, n_l, _, h, w = d_samp.shape
    if not 1 <= n_l <= MAX_PLANES:
        raise ValueError(f"d_samp: {n_l} planes, supported 1..{MAX_PLANES}")
    dev = d_samp.device
    _check("d_samp", d_samp, (v, n_l, 4, h, w), dev)
    _check("rx", rx, (v, h, w), dev)
    _check("ry", ry, (v, h, w), dev)
    _check("scal", scal, (v, n_l, 6), dev)
    if n_live is not None:
        _check("n_live", n_live, (v, h, w), dev, torch.int32)
    return _launch_splat(d_samp, rx, ry, scal, n_live, tex_h, tex_w)


class AdjointBands(NamedTuple):
    """Windows of the texture-space adjoint, measured on the host
    (:func:`plan_adjoint`) for a pose range; holding one is the caller's word
    that the range's ray fields passed :func:`plan_adjoint`'s checks.

    The numbers are plain pixel counts: ``d_u`` is how many image rows can
    hold a pixel whose ``fy`` lies within one texel of a given texel row, the
    worst case over texel rows, planes and planned poses, plus the margin;
    ``d_v`` the same for image columns and ``fx``.  (The TPU kernel's fields
    of the same names count tap offsets along a 16-row strip's rebased
    diagonal and carry a third, DMA-row field; neither notion exists here.)
    They say how large a texel tile's box of pixels gets; the kernel does not
    read them: each block finds its own box, of whatever size, on the card.
    """
    d_u: int
    d_v: int


def _line_extrema(rx, ry, scal, rows: bool, largest: bool = True) -> torch.Tensor:
    """The largest (or smallest) ``fy`` of each image row (``rows``: ``[V, L,
    H]``) or ``fx`` of each image column (``[V, L, W]``), per (view, plane).
    ``Ax, Ay > 0`` (planes in front of the eye, which :func:`plan_adjoint`
    checks), so the extremum of the ray field is the coordinate's."""
    pick = torch.amax if largest else torch.amin
    field, dim, a, b = (ry, 2, 2, 3) if rows else (rx, 1, 0, 1)
    return scal[..., a, None] * pick(field, dim=dim)[:, None] + scal[..., b, None]


def _monotone_either_way(field: torch.Tensor, dim: int, tol: float = 1e-6) -> bool:
    """Every line of ``field [V, H, W]`` along ``dim`` rises or falls
    throughout (to ``tol``), each line in its own direction."""
    d = torch.diff(field, dim=dim)
    return bool(((d >= -tol).all(dim=dim) | (d <= tol).all(dim=dim)).all())


def plan_adjoint(scal, rx, ry, tex_h: int, tex_w: int, margin: int = 2) -> AdjointBands:
    """Check the ray fields of the poses given for the adjoint kernel and
    measure its windows (host work on concrete tensors; plan at the corners of
    the pose range so the result covers every pose in it).  scal ``[V, L, 6]``
    (or ``[L, 6]``), rx, ry ``[V, H, W]``.  Raises ``ValueError`` where the
    warp is not monotone: the kernel searches ``fx`` along image rows and
    ``fy`` along image columns for a texel tile's box, and takes the box's
    extent over an interval of rows (columns) from the interval's two ends,
    which holds when ``fx`` is monotone along columns and ``fy`` along rows as
    well: the ray field of a pinhole camera is."""
    scal = torch.as_tensor(scal, dtype=torch.float32).cpu()
    rx = torch.as_tensor(rx, dtype=torch.float32).cpu()
    ry = torch.as_tensor(ry, dtype=torch.float32).cpu()
    if scal.ndim == 2:
        scal = scal[None].expand(rx.shape[0], -1, -1)
    if bool((scal[..., 0] <= 0).any()) or bool((scal[..., 2] <= 0).any()):
        raise ValueError("plan_adjoint: a plane at or behind the eye (Ax, Ay must be positive)")
    if bool((torch.diff(rx, dim=2) < -1e-6).any()) or bool((torch.diff(ry, dim=1) < -1e-6).any()):
        raise ValueError("plan_adjoint: the warp is not monotone along image rows and columns "
                         "(fx must not decrease along a row, fy along a column); the adjoint "
                         "kernel cannot serve these poses, use the splat route")
    if not (_monotone_either_way(rx, 1) and _monotone_either_way(ry, 2)):
        raise ValueError("plan_adjoint: the warp is not monotone across image rows and columns "
                         "(fx must rise or fall throughout along a column, fy along a row, as a "
                         "pinhole camera's do); the adjoint kernel cannot serve these poses, use "
                         "the splat route")
    spans = []
    for rows, n_tex in ((True, tex_h), (False, tex_w)):
        f_max = _line_extrema(rx, ry, scal, rows).numpy()
        f_min = _line_extrema(rx, ry, scal, rows, largest=False).numpy()
        t = np.arange(n_tex, dtype=np.float32)
        span = 1
        for vi in range(f_max.shape[0]):
            for li in range(f_max.shape[1]):
                first = np.searchsorted(f_max[vi, li], t - 1.0, side="right")
                last = np.searchsorted(f_min[vi, li], t + 1.0, side="left") - 1
                span = max(span, int((last - first + 1).max()))
        spans.append(span + 1 + margin)
    return AdjointBands(d_u=spans[0], d_v=spans[1])


def warp_adjoint_ref(d_samp: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                     scal: torch.Tensor, tex_h: int, tex_w: int) -> torch.Tensor:
    """Plain PyTorch version of the adjoint kernel: the same hat weights
    ``max(0, 1 - |fx - x|) max(0, 1 - |fy - u|)`` on the (at most four) real
    texels within one texel of each pixel's coordinates, summed per texel
    (one ``index_add_`` per plane and tap; the kernel sums in a fixed order
    instead).  Needs no bands.  Arguments and result as :func:`warp_adjoint`."""
    v, n_l, _, h, w = d_samp.shape
    base = (torch.arange(v, device=d_samp.device) * (tex_h * tex_w)).reshape(v, 1, 1)
    planes = []
    for l in range(n_l):
        s = scal[:, l, :, None, None]
        fx, fy = _fma(s[:, 0], rx, s[:, 1]), _fma(s[:, 2], ry, s[:, 3])
        x0, y0 = torch.floor(fx), torch.floor(fy)
        acc = torch.zeros((4, v * tex_h * tex_w), dtype=d_samp.dtype, device=d_samp.device)
        for yy in (y0, y0 + 1):
            hat_y = torch.clamp(1.0 - torch.abs(fy - yy), min=0.0)
            for xx in (x0, x0 + 1):
                hat_x = torch.clamp(1.0 - torch.abs(fx - xx), min=0.0)
                real = (xx >= 0) & (xx <= tex_w - 1) & (yy >= 0) & (yy <= tex_h - 1)
                wgt = torch.where(real, hat_y * hat_x, 0.0).nan_to_num(0.0)
                idx = (yy.clamp(0, tex_h - 1) * tex_w + xx.clamp(0, tex_w - 1)).nan_to_num(0.0)
                vals = torch.where(wgt[:, None] > 0, wgt[:, None] * d_samp[:, l], 0.0)
                acc.index_add_(1, (idx.long() + base).reshape(-1),
                               vals.permute(1, 0, 2, 3).reshape(4, -1))
        planes.append(acc.reshape(4, v, tex_h, tex_w).permute(1, 0, 2, 3))
    return torch.stack(planes, dim=1)


def warp_adjoint(d_samp: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor, scal: torch.Tensor,
                 bands: AdjointBands, tex_h: int, tex_w: int) -> torch.Tensor:
    """Exact transpose of the forward's bilinear warp, texel by texel:
    ``d_tex[u, x] = sum over pixels of max(0, 1 - |fy - u|) max(0, 1 - |fx -
    x|) d_samp`` with the forward's coordinates ``fx = Ax rx + Bx``, ``fy = Ay
    ry + By``; only real texels accumulate, so a tap the forward read as zero
    padding gets no gradient, and a pixel whose coordinate is NaN has weight 0.

    d_samp ``[V, L, 4, H, W]`` f32 (exact zeros where a pixel never reached a
    plane, as :func:`composite_bwd` writes them); rx, ry ``[V, H, W]``; scal
    ``[V, L, 6]``; ``bands`` from :func:`plan_adjoint` for a pose range that
    holds these poses (the kernel relies on what it checked, not on its
    numbers).  Returns ``d_tex [V, L, 4, tex_h, tex_w]``.  A block owns a tile
    of texels and finds that tile's pixels itself; every texel is owned by one
    thread that visits its pixels in a fixed order and writes once: no
    atomics, no zero fill, no work before the launch, bitwise repeatable
    (unlike :func:`warp_splat`).  CPU tensors run :func:`warp_adjoint_ref`;
    CUDA tensors launch the kernel."""
    if not isinstance(bands, AdjointBands) or min(bands) < 1:
        raise ValueError(f"bands: expected AdjointBands of positive windows, got {bands!r}")
    if d_samp.device.type == "cpu":
        return warp_adjoint_ref(d_samp, rx, ry, scal, tex_h, tex_w)
    if d_samp.device.type != "cuda":
        raise ValueError(f"warp_adjoint: unsupported device {d_samp.device}")
    if d_samp.ndim != 5 or d_samp.shape[2] != 4:
        raise ValueError(f"d_samp: expected [V, L, 4, H, W], got {tuple(d_samp.shape)}")
    v, n_l, _, h, w = d_samp.shape
    dev = d_samp.device
    _check("d_samp", d_samp, (v, n_l, 4, h, w), dev)
    _check("rx", rx, (v, h, w), dev)
    _check("ry", ry, (v, h, w), dev)
    _check("scal", scal, (v, n_l, 6), dev)
    d_tex = torch.empty((v, n_l, 4, tex_h, tex_w), dtype=torch.float32, device=dev)
    _launch("adjoint", dev,
            d_samp.data_ptr(), rx.data_ptr(), ry.data_ptr(), scal.data_ptr(), d_tex.data_ptr(),
            v, n_l, tex_h, tex_w, h, w)
    return d_tex


def cast_texture(tex: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``tex`` in ``dtype`` (None: as it is) for :func:`warp_composite_fwd`:
    one stack expanded over the views (stride 0) is cast once and expanded
    again, not materialized per view."""
    if dtype is None or tex.dtype == dtype:
        return tex
    if tex.shape[0] > 1 and tex.stride(0) == 0:
        return tex[:1].to(dtype).expand(tex.shape)
    return tex.to(dtype)


class FusedRender(torch.autograd.Function):
    """The fused renderer as one differentiable function of the plane RGBA:
    forward = :func:`warp_composite_fwd` in its training form, backward =
    :func:`composite_bwd` then the warp's transpose: :func:`warp_splat`, or,
    given ``adjoint_bands``, :func:`warp_adjoint` (the texture-space route;
    the composite backward has already zeroed what no pixel reached).

    ``FusedRender.apply(tex, rx, ry, q, scal, with_disp, grad_sparsity[,
    adjoint_bands[, compute_dtype]])`` -> ``(color, depth, [disp,] trans)``,
    premultiplied partials as the forward returns them.  ``compute_dtype=
    torch.bfloat16`` renders the forward from a bf16 copy of ``tex`` (the
    kernel's bf16-texture form); the backward stays fp32 (composite backward
    and splat on the fp32 residual), as in the JAX package, and the gradient
    reaches ``tex`` in its own dtype.  The gradient reaches ``tex`` only
    (rays and plane geometry are constants of the render, as in the gather
    renderer); each output's
    cotangent is optional.  First order only.  ``grad_sparsity`` renders with
    the grad-safe early-out and masks by ``n_live`` and ``GRAD_TAU``; without
    it every plane is processed (the slab form, whose transmittance in front
    is unknown).
    """

    @staticmethod
    def forward(ctx, tex, rx, ry, q, scal, with_disp: bool, grad_sparsity: bool,
                adjoint_bands: Optional[AdjointBands] = None,
                compute_dtype: Optional[torch.dtype] = None):
        if tex.shape[0] != rx.shape[0]:
            raise ValueError(f"FusedRender: {tex.shape[0]} texture stacks for {rx.shape[0]} "
                             f"views; stacks shared by groups of views render without a "
                             f"gradient only (expand the stacks over their views instead)")
        outs = warp_composite_fwd(cast_texture(tex, compute_dtype), rx, ry, q, scal,
                                  early_out="grad" if grad_sparsity else False,
                                  with_disp=with_disp, with_warped=True)
        n_base = 4 if with_disp else 3
        n_live = outs[n_base + 1] if grad_sparsity else None
        ctx.save_for_backward(outs[n_base], n_live, rx, ry, q, scal)
        ctx.with_disp = with_disp
        ctx.adjoint_bands = adjoint_bands
        ctx.tex_hw = tuple(tex.shape[-2:])
        ctx.set_materialize_grads(False)
        return outs[:n_base]

    @staticmethod
    @once_differentiable
    def backward(ctx, *cot):
        warped, n_live, rx, ry, q, scal = ctx.saved_tensors
        none = (None,) * 8
        if all(g is None for g in cot):
            return (None,) + none
        g_color = cot[0]
        g_depth, g_trans = cot[1], cot[-1]
        g_disp = cot[2] if ctx.with_disp else None
        if g_color is None:
            g_color = torch.zeros((rx.shape[0], 3) + rx.shape[1:], dtype=warped.dtype,
                                  device=warped.device)
        field = lambda g: None if g is None else g[:, 0].to(warped.dtype).contiguous()  # noqa: E731
        d_samp = composite_bwd(warped, q, scal, g_color.to(warped.dtype).contiguous(),
                               field(g_depth), field(g_disp), field(g_trans), n_live,
                               GRAD_TAU if n_live is not None else None)
        if ctx.adjoint_bands is not None:
            return (warp_adjoint(d_samp, rx, ry, scal, ctx.adjoint_bands, *ctx.tex_hw),) + none
        return (warp_splat(d_samp, rx, ry, scal, *ctx.tex_hw, n_live=n_live),) + none
