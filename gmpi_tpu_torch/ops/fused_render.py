"""Fused MPI warp+composite forward (port of the TPU kernel
``gmpi_tpu/ops/pallas_warp.py:_fwd_kernel`` behind ``warp_composite_fwd``).

``warp_composite_fwd`` is the wrapper: a CUDA tensor goes to the hand-written
kernel ``csrc/fused_fwd.cu`` (or the call raises), a CPU tensor goes to the
plain PyTorch version ``warp_composite_fwd_ref``, which repeats the kernel's
arithmetic and is what the CPU tests and the on-card comparison run.  Each
kernel launch adds one to ``LAUNCHES``.

Layout is the port's public ``[V, C, H, W]``: the TPU kernel's subtile-flat
pixel layout, DMA bands and band planning have no counterpart, because a
per-pixel CUDA gather needs none of them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

EPS = 1e-10          # composite epsilon (the reference's ``gmpi/core/mpi.py:421``)
EARLY_OUT_T = 1e-6   # a pixel stops once its transmittance falls below this
LAUNCHES = 0         # kernel launches made by warp_composite_fwd
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


def warp_composite_fwd_ref(tex: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                           q: torch.Tensor, scal: torch.Tensor, early_out: bool = True,
                           with_disp: bool = True, eps: float = EPS) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel, the same fp32 arithmetic: per
    plane an index+gather bilinear sample, then a sequential over-composite;
    with ``early_out`` a pixel stops updating once its transmittance is below
    ``EARLY_OUT_T``.  Arguments and results as :func:`warp_composite_fwd`."""
    v = rx.shape[0]
    n_l = scal.shape[1]
    zeros = torch.zeros_like(rx)
    color = torch.zeros((v, 3) + rx.shape[1:], dtype=torch.float32, device=rx.device)
    acc_d, acc_p, t = zeros, zeros, torch.ones_like(rx)
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
            live = t >= EARLY_OUT_T
            new = (torch.where(live[:, None], new[0], color),) + tuple(
                torch.where(live, n, o) for n, o in zip(new[1:], (acc_d, acc_p, t)))
        color, acc_d, acc_p, t = new
    outs = (color, acc_d[:, None]) + ((acc_p[:, None],) if with_disp else ())
    return outs + (t[:, None],)


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _lib() -> ctypes.CDLL:
    from gmpi_tpu_torch.ops import _build

    lib = _build.load("fused_fwd")
    fn = lib.gmpi_fused_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong] + [p] * 8 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def warp_composite_fwd(tex: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
                       q: torch.Tensor, scal: torch.Tensor, early_out: bool = True,
                       with_disp: bool = True, eps: float = EPS) -> Tuple[torch.Tensor, ...]:
    """Warp + over-composite all planes of each view, front to back.

    tex ``[V, L, 4, Th, Tw]`` f32 RGBA planes (plane 0 nearest); its view
    dimension may be an ``expand`` of one stack (stride 0), which all views
    then read.  rx, ry, q ``[V, H, W]`` from :func:`ray_fields`; scal
    ``[V, L, 6]`` from :func:`plane_affine`.

    Returns premultiplied ``(color [V,3,H,W], depth [V,1,H,W], [disp
    [V,1,H,W] with with_disp,] trans [V,1,H,W])``.  CPU tensors run
    :func:`warp_composite_fwd_ref`; CUDA tensors launch the kernel.
    """
    if tex.device.type == "cpu":
        return warp_composite_fwd_ref(tex, rx, ry, q, scal, early_out, with_disp, eps)
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
    view_stride = tex.stride(0) if v > 1 else 0
    if view_stride not in (0, n_l * 4 * th * tw):
        raise ValueError(f"tex: view stride {view_stride} is neither 0 nor a packed stack")
    if not 1 <= n_l <= MAX_PLANES:
        raise ValueError(f"tex: {n_l} planes, supported 1..{MAX_PLANES}")
    dev = tex.device
    for name, x in (("rx", rx), ("ry", ry), ("q", q)):
        _check(name, x, (v, h, w), dev)
    _check("scal", scal, (v, n_l, 6), dev)

    color = torch.empty((v, 3, h, w), dtype=torch.float32, device=dev)
    depth, trans = (torch.empty((v, 1, h, w), dtype=torch.float32, device=dev)
                    for _ in range(2))
    disp = torch.empty((v, 1, h, w), dtype=torch.float32, device=dev) if with_disp else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gmpi_fused_fwd(
            tex.data_ptr(), view_stride, rx.data_ptr(), ry.data_ptr(), q.data_ptr(),
            scal.data_ptr(), color.data_ptr(), depth.data_ptr(),
            disp.data_ptr() if with_disp else None, trans.data_ptr(),
            v, n_l, th, tw, h, w, int(bool(early_out)), int(bool(with_disp)), eps, stream)
    if err != 0:
        raise RuntimeError(f"fused_fwd kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return (color, depth) + ((disp,) if with_disp else ()) + (trans,)
