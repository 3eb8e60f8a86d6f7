"""Fused MPI warp+composite renderer: forward, backward and the autograd
Function around them (port of the TPU kernels behind ``make_fused_renderer``
in ``gmpi_tpu/ops/pallas_warp.py``).

Three wrappers, each with its hand-written CUDA kernel and, beside it, a plain
PyTorch version that repeats the kernel's arithmetic:

* :func:`warp_composite_fwd` -> ``csrc/fused_fwd.cu`` (``_fwd_kernel``): warp
  every plane into the view and over-composite front to back; in its training
  form it also returns the VJP residual and, with ``early_out="grad"``, the
  per-pixel count of live planes;
* :func:`composite_bwd` -> ``csrc/composite_bwd.cu`` (``_composite_bwd_fat_kernel``
  and ``_composite_bwd_kernel``): cotangents of the composited outputs back
  onto the warped samples;
* :func:`warp_splat` -> ``csrc/splat.cu`` (``_splat_plane_kernel`` and
  ``_splat_kernel``): the warp's transpose, sample cotangents onto texels.

A CUDA tensor goes to the kernel or the call raises; a CPU tensor goes to the
plain version (``*_ref``), which is what the CPU tests and the on-card
comparison run.  Each kernel launch adds one to its entry of ``LAUNCHES``.
:class:`FusedRender` ties the three into one differentiable function of the
plane RGBA.

Layout is the port's public ``[V, C, H, W]``: the TPU kernels' subtile-flat
pixel layout, DMA bands, band planning and per-plane liveness bitmap have no
counterpart, because a thread per pixel gathers, scatters and skips on its
own.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

EPS = 1e-10          # composite epsilon (the reference's ``gmpi/core/mpi.py:421``)
EARLY_OUT_T = 1e-6   # inference: a pixel stops once its transmittance falls below this
# Grad-safe occlusion threshold: a pixel's planes are skipped once S / M < tau,
# S the product and M the minimum of the factors max(1 - a, 0) + eps so far.
# Every gradient path out of a plane divides by at most one such factor, and
# S / M removes exactly the smallest, so what is dropped is O(tau) absolute.
GRAD_TAU = 1e-7
LAUNCHES = {"fused_fwd": 0, "composite_bwd": 0, "splat": 0}  # kernel launches, by kernel
MAX_PLANES = 2048    # the [L, 6] affine table is staged in 48 KB of shared memory


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
    """Bilinear sample of ``tex_l [V, 4, Th, Tw]`` at texel coordinates
    ``fx, fy [V, H, W]``, zeros outside: ``[V, 4, H, W]``."""
    v, h, w = fx.shape
    th, tw = tex_l.shape[-2:]
    flat = tex_l.reshape(tex_l.shape[0], 4, th * tw).expand(v, 4, th * tw)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0

    def tap(yy, xx):
        valid = (xx >= 0) & (xx <= tw - 1) & (yy >= 0) & (yy <= th - 1)
        idx = (yy.clamp(0, th - 1) * tw + xx.clamp(0, tw - 1)).nan_to_num(0.0).long()
        vals = torch.gather(flat, 2, idx.reshape(v, 1, h * w).expand(v, 4, h * w))
        return torch.where(valid[:, None], vals.reshape(v, 4, h, w), 0.0)

    wx, wy = wx[:, None], wy[:, None]
    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def _factor(alpha: torch.Tensor, eps: float) -> torch.Tensor:
    """Composite factor ``max(1 - a, 0) + eps`` of the gradient path (equal to
    ``1 - a + eps`` for ``a <= 1``; never 0)."""
    return torch.clamp(1.0 - alpha, min=0.0) + eps


def warp_composite_fwd_ref(tex: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                           q: torch.Tensor, scal: torch.Tensor,
                           early_out: Union[bool, str] = True, with_disp: bool = True,
                           eps: float = EPS, with_warped: bool = False
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward kernel, the same arithmetic in the
    inputs' dtype: per plane an index+gather bilinear sample, then a
    sequential over-composite; a pixel stops updating under the ``early_out``
    rule.  Residual slots of planes a pixel did not reach hold NaN (the kernel
    leaves them unwritten), so a consumer that reads one shows.  Arguments and
    results as :func:`warp_composite_fwd`."""
    v = rx.shape[0]
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
        smp = sample_bilinear(tex[:, l], s[:, 0] * rx + s[:, 1], s[:, 2] * ry + s[:, 3])
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
    "fused_fwd": [_P, ctypes.c_longlong] + [_P] * 10 + [_I] * 8 + [_F, _P],
    "composite_bwd": [_P] * 9 + [_I] * 4 + [_F, _I, _F, _P],
    "splat": [_P] * 6 + [_I] * 6 + [_P],
}


def _launch(name: str, dev: torch.device, *args) -> None:
    """Launch the kernel of ``csrc/<name>.cu`` (built at first use) on the
    current stream of ``dev``; raise if the launch is refused, count it
    otherwise."""
    from gmpi_tpu_torch.ops import _build

    fn = getattr(_build.load(name), "gmpi_" + name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def warp_composite_fwd(tex: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                       q: torch.Tensor, scal: torch.Tensor,
                       early_out: Union[bool, str] = True, with_disp: bool = True,
                       eps: float = EPS, with_warped: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """Warp + over-composite all planes of each view, front to back.

    tex ``[V, L, 4, Th, Tw]`` f32 RGBA planes (plane 0 nearest); its view
    dimension may be an ``expand`` of one stack (stride 0), which all views
    then read.  rx, ry, q ``[V, H, W]`` from :func:`ray_fields`; scal
    ``[V, L, 6]`` from :func:`plane_affine`.

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
        raise ValueError(f"tex: expected [V, L, 4, Th, Tw], got {tuple(tex.shape)}")
    v, h, w = rx.shape
    n_l, th, tw = tex.shape[1], tex.shape[3], tex.shape[4]
    if tex.dtype != torch.float32:
        raise TypeError(f"tex: expected float32, got {tex.dtype}")
    if tex.shape[0] != v or not tex[0].is_contiguous():
        raise ValueError(f"tex: expected {v} views of contiguous [L, 4, Th, Tw] stacks")
    view_stride = tex.stride(0) if v > 1 else 0  # 0 (expanded), packed, or a slab's parent
    if view_stride != 0 and view_stride < n_l * 4 * th * tw:
        raise ValueError(f"tex: view stride {view_stride} is neither 0 (one stack expanded over "
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
            tex.data_ptr(), view_stride, rx.data_ptr(), ry.data_ptr(), q.data_ptr(),
            scal.data_ptr(), color.data_ptr(), depth.data_ptr(), _ptr(disp), trans.data_ptr(),
            _ptr(warped), _ptr(n_live), v, n_l, th, tw, h, w,
            2 if grad_rule else int(bool(early_out)), int(bool(with_disp)), eps)
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
        fx, fy = s[:, 0] * rx + s[:, 1], s[:, 2] * ry + s[:, 3]
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


def warp_splat(d_samp: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor, scal: torch.Tensor,
               tex_h: int, tex_w: int, n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact transpose of the forward's bilinear warp: sample cotangents
    ``d_samp [V, L, 4, H, W]`` f32 -> texel cotangents ``d_tex [V, L, 4, tex_h,
    tex_w]``, with the forward's coordinates ``fx = Ax rx + Bx``, ``fy = Ay ry
    + By`` and bounds.  rx, ry ``[V, H, W]``; scal ``[V, L, 6]``; ``n_live
    [V, H, W]`` int32 or None: planes ``l >= n_live`` of a pixel are skipped
    unread.  CPU tensors run :func:`warp_splat_ref`; CUDA tensors launch the
    kernel, which scatters with fp32 atomics, so its sums are repeatable to
    rounding only, not bitwise."""
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
    d_tex = torch.zeros((v, n_l, 4, tex_h, tex_w), dtype=torch.float32, device=dev)
    _launch("splat", dev,
            d_samp.data_ptr(), rx.data_ptr(), ry.data_ptr(), scal.data_ptr(), _ptr(n_live),
            d_tex.data_ptr(), v, n_l, tex_h, tex_w, h, w)
    return d_tex


class FusedRender(torch.autograd.Function):
    """The fused renderer as one differentiable function of the plane RGBA:
    forward = :func:`warp_composite_fwd` in its training form, backward =
    :func:`composite_bwd` then :func:`warp_splat`.

    ``FusedRender.apply(tex, rx, ry, q, scal, with_disp, grad_sparsity)`` ->
    ``(color, depth, [disp,] trans)``, premultiplied partials as the forward
    returns them.  The gradient reaches ``tex`` only (rays and plane geometry
    are constants of the render, as in the gather renderer); each output's
    cotangent is optional.  First order only.  ``grad_sparsity`` renders with
    the grad-safe early-out and masks by ``n_live`` and ``GRAD_TAU``; without
    it every plane is processed (the slab form, whose transmittance in front
    is unknown).
    """

    @staticmethod
    def forward(ctx, tex, rx, ry, q, scal, with_disp: bool, grad_sparsity: bool):
        outs = warp_composite_fwd(tex, rx, ry, q, scal,
                                  early_out="grad" if grad_sparsity else False,
                                  with_disp=with_disp, with_warped=True)
        n_base = 4 if with_disp else 3
        n_live = outs[n_base + 1] if grad_sparsity else None
        ctx.save_for_backward(outs[n_base], n_live, rx, ry, q, scal)
        ctx.with_disp = with_disp
        ctx.tex_hw = tuple(tex.shape[-2:])
        ctx.set_materialize_grads(False)
        return outs[:n_base]

    @staticmethod
    @once_differentiable
    def backward(ctx, *cot):
        warped, n_live, rx, ry, q, scal = ctx.saved_tensors
        none = (None,) * 6
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
        return (warp_splat(d_samp, rx, ry, scal, *ctx.tex_hw, n_live=n_live),) + none
