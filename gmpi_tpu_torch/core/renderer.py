"""MPI renderer (port of ``gmpi_tpu/core/renderer.py``).

Two paths with the reference renderer's semantics:

* the gather path, :func:`render_mpi`: per-(view, plane) homography, bilinear
  ``F.grid_sample`` with zeros padding (and the 0.95 narrow-scale rule for
  ``align_corners=False``), then a vectorized front-to-back over-composite
  with weights ``alpha * cumprod(1 - alpha + 1e-10)``;
* the fused path, :func:`render_mpi_fused`: the warp+composite kernel of
  ``gmpi_tpu_torch.ops.fused_render`` and, under autograd, its backward
  kernels (composite backward, then splat) behind ``FusedRender``;
  :func:`render_mpi_fused_remat` renders slab by slab under
  ``torch.utils.checkpoint`` so that only one slab's residual is alive.

Both are float32; the UV grid and per-pixel depth carry no gradient (the
reference computes them under ``no_grad``), so gradients reach plane RGBA
only, on either path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gmpi_tpu_torch.ops import fused_render

ALIGN_CORNERS_FALSE_NARROW_SCALE = 0.95
COMPOSITE_EPS = 1e-10


class RenderOutput(NamedTuple):
    color: torch.Tensor                  # [V, 3, H, W] in [0, 1]
    depth: torch.Tensor                  # [V, 1, H, W]
    disp: Optional[torch.Tensor] = None  # [V, 1, H, W] expected disparity


def homography_grid(dhw: torch.Tensor, eye_pos: torch.Tensor, ray_dir: torch.Tensor,
                    z_dir: torch.Tensor, align_corners: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UV grid ``[N, H, W, 2]`` in [-1, 1] and plane depth ``[N, 1, H, W]``
    for (plane, camera) pairs: dhw/eye_pos/z_dir ``[N, 3]``, ray_dir
    ``[N, 3, H, W]``."""
    n, _, h, w = ray_dir.shape
    scale = (dhw[:, 0:1] - eye_pos[:, 2:3]).reshape(n, 1, 1) / ray_dir[:, 2]
    x = eye_pos[:, 0].reshape(n, 1, 1) + ray_dir[:, 0] * scale
    y = eye_pos[:, 1].reshape(n, 1, 1) + ray_dir[:, 1] * scale
    u = 2.0 * x / dhw[:, 2].reshape(n, 1, 1)
    v = 2.0 * y / dhw[:, 1].reshape(n, 1, 1)
    if not align_corners:
        u = torch.where((u >= -1.0) & (u <= 1.0), u * ALIGN_CORNERS_FALSE_NARROW_SCALE, u)
        v = torch.where((v >= -1.0) & (v <= 1.0), v * ALIGN_CORNERS_FALSE_NARROW_SCALE, v)
    grid = torch.stack([u, v], dim=-1)
    dist2depth = torch.einsum("nchw,nc->nhw", ray_dir, z_dir)
    return grid, (scale * dist2depth).reshape(n, 1, h, w)


def warp_planes(rgba: torch.Tensor, dhw: torch.Tensor, eye_pos: torch.Tensor,
                ray_dir: torch.Tensor, z_dir: torch.Tensor, align_corners: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse-warp flattened planes ``rgba [N, 4, Th, Tw]`` into their
    cameras: ``(rgb [N,3,H,W], disp [N,1,H,W], alpha [N,1,H,W])``."""
    with torch.no_grad():
        grid, depth = homography_grid(dhw, eye_pos, ray_dir, z_dir, align_corners)
    sampled = F.grid_sample(rgba, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=align_corners)
    return sampled[:, :3], 1.0 / depth, sampled[:, 3:4]


def composite(rgb: torch.Tensor, alpha: torch.Tensor, depth: torch.Tensor,
              disp: Optional[torch.Tensor] = None):
    """Front-to-back over-composite along the plane axis (plane 0 nearest):
    rgb ``[V, L, 3, H, W]``, alpha/depth/disp ``[V, L, 1, H, W]`` ->
    ``(color, depth[, disp])``."""
    shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + COMPOSITE_EPS], dim=1)
    weights = alpha * torch.cumprod(shifted, dim=1)[:, :-1]
    color = torch.sum(weights * rgb, dim=1)
    depth_out = torch.sum(weights * depth, dim=1)
    if disp is None:
        return color, depth_out
    return color, depth_out, torch.sum(weights * disp, dim=1)


def composite_partial(rgb, alpha, depth, disp=None):
    """Composite one plane slab to premultiplied partials plus the slab's
    transmittance ``prod(1 - a + eps)`` (last element)."""
    trans = torch.prod(1.0 - alpha + COMPOSITE_EPS, dim=1)
    return composite(rgb, alpha, depth, disp) + (trans,)


def combine_segments(front, back):
    """Over-combine two adjacent slab partials (front first):
    ``(x_f + T_f * x_b ..., T_f * T_b)``."""
    tf_, tb = front[-1], back[-1]
    return tuple(f + tf_ * b for f, b in zip(front[:-1], back[:-1])) + (tf_ * tb,)


def _flatten_views(rgba, dhw, ray_dir, eye_pos, z_dir):
    """Broadcast per-view cameras over planes: ``V x L`` flat pairs."""
    v, n_l = rgba.shape[0], rgba.shape[1]
    h, w = ray_dir.shape[2], ray_dir.shape[3]
    if dhw.ndim == 2:
        dhw = dhw[None].expand(v, n_l, 3)
    flat_rgba = rgba.to(torch.float32).reshape(v * n_l, 4, *rgba.shape[3:])
    flat_dhw = dhw.reshape(v * n_l, 3).to(torch.float32)
    flat_ray = ray_dir[:, None].expand(v, n_l, 3, h, w).reshape(v * n_l, 3, h, w)
    flat_eye = eye_pos[:, None].expand(v, n_l, 3).reshape(v * n_l, 3)
    flat_z = z_dir[:, None].expand(v, n_l, 3).reshape(v * n_l, 3)
    return flat_rgba, flat_dhw, flat_ray.float(), flat_eye.float(), flat_z.float()


def render_mpi(rgba: torch.Tensor, dhw: torch.Tensor, ray_dir: torch.Tensor,
               eye_pos: torch.Tensor, z_dir: torch.Tensor, align_corners: bool = True
               ) -> RenderOutput:
    """Render ``rgba [V, L, 4, Th, Tw]`` (RGB and alpha in [0, 1], plane 0
    nearest) into one camera per view: dhw ``[L, 3]`` or ``[V, L, 3]``,
    ray_dir ``[V, 3, H, W]``, eye_pos / z_dir ``[V, 3]``."""
    v, n_l = rgba.shape[0], rgba.shape[1]
    h, w = ray_dir.shape[2], ray_dir.shape[3]
    flat_rgba, flat_dhw, flat_ray, flat_eye, flat_z = _flatten_views(
        rgba, dhw, ray_dir, eye_pos, z_dir)
    with torch.no_grad():
        grid, depth = homography_grid(flat_dhw, flat_eye, flat_ray, flat_z, align_corners)
    sampled = F.grid_sample(flat_rgba, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=align_corners)
    # the reference's fp order: disp = 1/depth, then depth = 1/disp
    disp = 1.0 / depth
    depth = 1.0 / disp
    color, depth_out, disp_out = composite(
        sampled[:, :3].reshape(v, n_l, 3, h, w), sampled[:, 3:4].reshape(v, n_l, 1, h, w),
        depth.reshape(v, n_l, 1, h, w), disp.reshape(v, n_l, 1, h, w))
    return RenderOutput(color=color, depth=depth_out, disp=disp_out)


def render_slab_partial(rgba, dhw, ray_dir, eye_pos, z_dir, align_corners: bool = True,
                        with_disp: bool = False):
    """Warp + partially composite one plane slab; partials for
    :func:`combine_segments` (a 4-tuple with disparity when ``with_disp``)."""
    v, n_l = rgba.shape[0], rgba.shape[1]
    h, w = ray_dir.shape[2], ray_dir.shape[3]
    flat_rgba, flat_dhw, flat_ray, flat_eye, flat_z = _flatten_views(
        rgba, dhw, ray_dir, eye_pos, z_dir)
    rgb, disp, alpha = warp_planes(flat_rgba, flat_dhw, flat_eye, flat_ray, flat_z,
                                   align_corners)
    depth = (1.0 / disp).reshape(v, n_l, 1, h, w)
    rgb = rgb.reshape(v, n_l, 3, h, w)
    alpha = alpha.reshape(v, n_l, 1, h, w)
    disp = disp.reshape(v, n_l, 1, h, w) if with_disp else None
    return composite_partial(rgb, alpha, depth, disp)


def _fused_inputs(rgba, dhw, ray_dir, eye_pos, z_dir):
    """float32 texture stack and the kernels' contiguous ray and plane tables."""
    if rgba.dtype != torch.float32:
        rgba = rgba.float()
    tex_h, tex_w = rgba.shape[-2], rgba.shape[-1]
    with torch.no_grad():
        scal = fused_render.plane_affine(dhw.float(), eye_pos.float(), tex_h, tex_w).contiguous()
        rx, ry, q = (x.contiguous()
                     for x in fused_render.ray_fields(ray_dir.float(), z_dir.float()))
    return rgba, rx, ry, q, scal


def _fused_partials(rgba, dhw, ray_dir, eye_pos, z_dir, early_out: bool, with_disp: bool,
                    grad_sparsity: bool) -> Tuple[torch.Tensor, ...]:
    """``(color, depth[, disp], trans)`` premultiplied partials: through
    ``FusedRender`` when a gradient is wanted, else the inference form of the
    forward kernel (no residual)."""
    wants_grad = torch.is_grad_enabled() and rgba.requires_grad
    rgba, rx, ry, q, scal = _fused_inputs(rgba, dhw, ray_dir, eye_pos, z_dir)
    if wants_grad:
        return fused_render.FusedRender.apply(rgba, rx, ry, q, scal, with_disp, grad_sparsity)
    return fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, early_out=early_out,
                                           with_disp=with_disp)


def render_mpi_fused(rgba: torch.Tensor, dhw: torch.Tensor, ray_dir: torch.Tensor,
                     eye_pos: torch.Tensor, z_dir: torch.Tensor, plans=None,
                     early_out: bool = True, with_disp: bool = True) -> RenderOutput:
    """Render through the fused warp+composite kernels, differentiable in
    ``rgba``.

    Same semantics as :func:`render_mpi` with align_corners=True, float32
    throughout (a bf16 ``rgba`` is cast on the way in and its gradient back on
    the way out); the gradient reaches ``rgba`` only.  ``rgba [V, L, 4, Th,
    Tw]`` may be an ``expand`` of one MPI over views.  Without a gradient to
    compute (``torch.no_grad()``, or ``rgba`` not requiring one) the forward
    kernel runs in its inference form: no residual, ``early_out`` on the
    transmittance.  With one, it keeps the residual and stops a pixel by the
    grad-safe rule (``fused_render.GRAD_TAU``) whatever ``early_out`` says:
    the transmittance rule would corrupt an occluder's alpha gradient.
    ``plans`` is accepted for the JAX signature and unused: a per-pixel CUDA
    gather needs no static bands.  ``with_disp=False`` leaves ``disp`` None.
    """
    del plans
    outs = _fused_partials(rgba, dhw, ray_dir, eye_pos, z_dir, early_out, with_disp,
                           grad_sparsity=True)
    return RenderOutput(color=outs[0], depth=outs[1], disp=outs[2] if with_disp else None)


def make_fused_slab_renderer(with_disp: bool = False):
    """The fused renderer for one plane slab: ``fn(rgba_slab, dhw_slab,
    ray_dir, eye_pos, z_dir) -> (color_pre, depth_pre[, disp_pre], trans)``,
    the partials of :func:`render_slab_partial` for :func:`combine_segments`,
    differentiable in ``rgba_slab`` (``trans`` included).  Under autograd a
    slab processes every plane: what stands in front of it is not known to
    it, so no occlusion rule applies, with or without autograd.  The JAX
    factory's band and splat plans have no counterpart here."""

    def fn(rgba, dhw, ray_dir, eye_pos, z_dir):
        return _fused_partials(rgba, dhw, ray_dir, eye_pos, z_dir, False, with_disp,
                               grad_sparsity=False)

    return fn


def render_mpi_fused_remat(rgba: torch.Tensor, dhw: torch.Tensor, ray_dir: torch.Tensor,
                           eye_pos: torch.Tensor, z_dir: torch.Tensor, plans=None,
                           plane_chunk: int = 8, with_disp: bool = True) -> RenderOutput:
    """Memory-rematerialized fused render: slabs of ``plane_chunk`` planes
    render through the slab renderer under ``torch.utils.checkpoint`` and
    their partials combine front to back, so the backward holds one slab's
    residual and cotangents at a time; each slab's forward runs twice.
    Semantics of :func:`render_mpi_fused`; ``plans`` accepted and unused
    (``plane_chunk`` takes the place of the plan's chunks)."""
    del plans
    if plane_chunk < 1:
        raise ValueError(f"plane_chunk: expected >= 1, got {plane_chunk}")
    slab = make_fused_slab_renderer(with_disp=with_disp)
    carry = None
    for lo in range(0, rgba.shape[1], plane_chunk):
        hi = lo + plane_chunk
        part = checkpoint(slab, rgba[:, lo:hi], dhw[lo:hi], ray_dir, eye_pos, z_dir,
                          use_reentrant=False)
        carry = part if carry is None else combine_segments(carry, part)
    return RenderOutput(color=carry[0], depth=carry[1], disp=carry[2] if with_disp else None)
