"""MPI renderer (port of ``gmpi_tpu/core/renderer.py``).

Three paths with the reference renderer's semantics:

* the gather path, :func:`render_mpi`: per-(view, plane) homography, bilinear
  ``F.grid_sample`` with zeros padding (and the 0.95 narrow-scale rule for
  ``align_corners=False``), then a vectorized front-to-back over-composite
  with weights ``alpha * cumprod(1 - alpha + 1e-10)``;
* the banded path, :func:`render_mpi` / :func:`render_mpi_chunked` with
  ``tiled_bands``: the same render with the sampling done by the tile-banded
  warp of ``gmpi_tpu_torch.ops.tiled_warp``, which picks its tiling and its
  route itself (the patch-gather and tap kernels where autograd records
  nothing through it, the hat contractions where it does); 4-field bands add
  the scatter-free tiled adjoint as the warp's backward;
* the fused path, :func:`render_mpi_fused`: the warp+composite kernel of
  ``gmpi_tpu_torch.ops.fused_render`` and, under autograd, its backward
  kernels behind ``FusedRender`` (composite backward, then the splat or,
  given adjoint bands in ``plans``, the texture-space adjoint);
  :func:`render_mpi_fused_remat` renders slab by slab under
  ``torch.utils.checkpoint`` so that only one slab's residual is alive.

All are float32, except that the fused path's forward may read bf16 textures
(``compute_dtype=torch.bfloat16``); the UV grid and per-pixel depth carry no gradient (the
reference computes them under ``no_grad``), so gradients reach plane RGBA
only, on every path, unless :func:`render_mpi` is asked for
``stop_pose_grad=False``.

Each render is a ``torch.profiler`` span named for its path:
``render.fused``, ``render.banded`` or ``render.gather`` (the fused and
tiled backwards open ``render.backward``); inside the banded and gather
spans, the over-composite that follows the warp is ``render.composite``,
once a :func:`render_mpi` call and once a slab of :func:`render_mpi_chunked`
(the slab's partials and their combine with the slabs in front).  Without a
profiler they do nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from gmpi_tpu_torch.ops import fused_render
from gmpi_tpu_torch.ops.grid_sample import grid_sample_bilinear
from gmpi_tpu_torch.utils.inspect import profile_scope

ALIGN_CORNERS_FALSE_NARROW_SCALE = 0.95
COMPOSITE_EPS = 1e-10
# what one step of the banded warp's hats and of its tiled adjoint holds (a served MPI of 96
# planes in 4 views holds ~45 GB of hats and mixed products at 256^2); the taps hold nothing
# but their output
TILED_STEP_BYTES = 4 * 2 ** 30


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


def _sample(rgba, grid, align_corners, tiled_bands):
    """Warp dispatch: the per-pixel gather (``F.grid_sample``), or the
    tile-banded warp when ``tiled_bands = (band_y, band_x[, adj_rows,
    adj_cols])`` is given, in the warp's own tiling (``tiled_warp.tiling``);
    with the two adjoint fields its backward is the scatter-free tiled
    adjoint."""
    if tiled_bands is None:
        return grid_sample_bilinear(rgba, grid, align_corners=align_corners)
    from gmpi_tpu_torch.ops.tiled_warp import grid_sample_tiled, make_tiled_warp_with_adjoint

    band_y, band_x = tiled_bands[0], tiled_bands[1]
    if len(tiled_bands) == 4:
        fn = make_tiled_warp_with_adjoint(band_y, band_x, (tiled_bands[2], tiled_bands[3]),
                                          align_corners=align_corners,
                                          step_bytes=TILED_STEP_BYTES)
        return fn(rgba, grid)
    return grid_sample_tiled(rgba, grid, band_y, band_x, align_corners=align_corners,
                             step_bytes=TILED_STEP_BYTES)


def warp_planes(rgba: torch.Tensor, dhw: torch.Tensor, eye_pos: torch.Tensor,
                ray_dir: torch.Tensor, z_dir: torch.Tensor, align_corners: bool = True,
                tiled_bands: Optional[Tuple[int, ...]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse-warp flattened planes ``rgba [N, 4, Th, Tw]`` into their
    cameras: ``(rgb [N,3,H,W], disp [N,1,H,W], alpha [N,1,H,W])``."""
    with torch.no_grad():
        grid, depth = homography_grid(dhw, eye_pos, ray_dir, z_dir, align_corners)
    sampled = _sample(rgba, grid, align_corners, tiled_bands)
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


def composite_sequential(rgb: torch.Tensor, alpha: torch.Tensor, depth: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-to-front sequential over-compositing, ``out = rgb_l a_l + out (1 -
    a_l + eps)`` from the farthest plane in: the same function as
    :func:`composite` up to fp reassociation, kept as a cross-check."""
    color = torch.zeros_like(rgb[:, 0])
    depth_out = torch.zeros_like(depth[:, 0])
    for i in range(rgb.shape[1] - 1, -1, -1):
        a = alpha[:, i]
        color = rgb[:, i] * a + color * (1.0 - a + COMPOSITE_EPS)
        depth_out = depth[:, i] * a + depth_out * (1.0 - a + COMPOSITE_EPS)
    return color, depth_out


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


def _span_of(tiled_bands) -> str:
    """The span of a render through :func:`render_mpi` or
    :func:`render_mpi_chunked`: banded with tile bands, else the gather."""
    return "render.gather" if tiled_bands is None else "render.banded"


def render_mpi(rgba: torch.Tensor, dhw: torch.Tensor, ray_dir: torch.Tensor,
               eye_pos: torch.Tensor, z_dir: torch.Tensor, align_corners: bool = True,
               tiled_bands: Optional[Tuple[int, ...]] = None, stop_pose_grad: bool = True
               ) -> RenderOutput:
    """Render ``rgba [V, L, 4, Th, Tw]`` (RGB and alpha in [0, 1], plane 0
    nearest) into one camera per view: dhw ``[L, 3]`` or ``[V, L, 3]``,
    ray_dir ``[V, 3, H, W]``, eye_pos / z_dir ``[V, 3]``.

    ``tiled_bands`` (from ``core.bands``) samples through the tile-banded warp
    instead of the per-pixel gather.  ``stop_pose_grad=False`` is the
    differentiable-pose mode: the sampling grid and the per-pixel depth keep
    their graph to ``dhw`` / ``ray_dir`` / ``eye_pos`` / ``z_dir``; it samples
    through plain autograd (2-field bands, so the warp takes the hats), since
    the custom adjoint cuts grid gradients."""
    with profile_scope(_span_of(tiled_bands)):
        v, n_l = rgba.shape[0], rgba.shape[1]
        h, w = ray_dir.shape[2], ray_dir.shape[3]
        flat_rgba, flat_dhw, flat_ray, flat_eye, flat_z = _flatten_views(
            rgba, dhw, ray_dir, eye_pos, z_dir)
        if stop_pose_grad:
            with torch.no_grad():
                grid, depth = homography_grid(flat_dhw, flat_eye, flat_ray, flat_z, align_corners)
            sampled = _sample(flat_rgba, grid, align_corners, tiled_bands)
        else:
            grid, depth = homography_grid(flat_dhw, flat_eye, flat_ray, flat_z, align_corners)
            bands2 = tuple(tiled_bands[:2]) if tiled_bands is not None else None
            sampled = _sample(flat_rgba, grid, align_corners, bands2)
        # the reference's fp order: disp = 1/depth, then depth = 1/disp
        disp = 1.0 / depth
        depth = 1.0 / disp
        with profile_scope("render.composite"):
            color, depth_out, disp_out = composite(
                sampled[:, :3].reshape(v, n_l, 3, h, w), sampled[:, 3:4].reshape(v, n_l, 1, h, w),
                depth.reshape(v, n_l, 1, h, w), disp.reshape(v, n_l, 1, h, w))
        return RenderOutput(color=color, depth=depth_out, disp=disp_out)


def render_slab_partial(rgba, dhw, ray_dir, eye_pos, z_dir, align_corners: bool = True,
                        tiled_bands: Optional[Tuple[int, ...]] = None, with_disp: bool = False,
                        front=None):
    """Warp + partially composite one plane slab; partials for
    :func:`combine_segments` (a 4-tuple with disparity when ``with_disp``),
    combined behind ``front``, the partials of the slabs in front, if given."""
    v, n_l = rgba.shape[0], rgba.shape[1]
    h, w = ray_dir.shape[2], ray_dir.shape[3]
    flat_rgba, flat_dhw, flat_ray, flat_eye, flat_z = _flatten_views(
        rgba, dhw, ray_dir, eye_pos, z_dir)
    rgb, disp, alpha = warp_planes(flat_rgba, flat_dhw, flat_eye, flat_ray, flat_z,
                                   align_corners, tiled_bands)
    depth = (1.0 / disp).reshape(v, n_l, 1, h, w)
    rgb = rgb.reshape(v, n_l, 3, h, w)
    alpha = alpha.reshape(v, n_l, 1, h, w)
    disp = disp.reshape(v, n_l, 1, h, w) if with_disp else None
    with profile_scope("render.composite"):
        part = composite_partial(rgb, alpha, depth, disp)
        return part if front is None else combine_segments(front, part)


def render_mpi_chunked(rgba: torch.Tensor, dhw: torch.Tensor, ray_dir: torch.Tensor,
                       eye_pos: torch.Tensor, z_dir: torch.Tensor, plane_chunk: int,
                       align_corners: bool = True, remat: bool = False,
                       tiled_bands: Optional[Sequence] = None, with_disp: bool = True
                       ) -> RenderOutput:
    """Memory-bounded render: planes go through in contiguous front-to-back
    slabs of ``plane_chunk`` (a loop) and their partials combine by segment
    compositing, so the peak footprint is one slab's warped planes, not all
    ``L``.  ``remat=True`` also rematerializes each slab's warp in the
    backward pass (``torch.utils.checkpoint``) instead of keeping its
    residuals.  ``tiled_bands`` is one band tuple for all slabs or a sequence
    of one tuple per slab (plane extents grow front to back, so near slabs
    get by with smaller bands)."""
    v, n_l = rgba.shape[0], rgba.shape[1]
    if plane_chunk < 1 or n_l % plane_chunk:
        raise ValueError(f"plane_chunk {plane_chunk} does not divide {n_l} planes")
    n_chunks = n_l // plane_chunk
    if dhw.ndim == 2:
        dhw = dhw[None].expand(v, n_l, 3)
    per_chunk = (tiled_bands is not None and len(tiled_bands) > 0
                 and isinstance(tiled_bands[0], (tuple, list)))
    if per_chunk and len(tiled_bands) != n_chunks:
        raise ValueError(f"{len(tiled_bands)} band tuples for {n_chunks} slabs")

    with profile_scope(_span_of(tiled_bands)):
        carry = None
        for k in range(n_chunks):
            bands = tuple(tiled_bands[k]) if per_chunk else tiled_bands

            def slab(r, d, front, bands=bands):
                return render_slab_partial(r, d, ray_dir, eye_pos, z_dir, align_corners, bands,
                                           with_disp=with_disp, front=front)

            sl = slice(k * plane_chunk, (k + 1) * plane_chunk)
            if remat:
                carry = checkpoint(slab, rgba[:, sl], dhw[:, sl], carry, use_reentrant=False)
            else:
                carry = slab(rgba[:, sl], dhw[:, sl], carry)
    return RenderOutput(color=carry[0], depth=carry[1], disp=carry[2] if with_disp else None)


def _compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """The fused forward's texture dtype: None (float32) or torch.bfloat16."""
    if compute_dtype in (None, torch.float32):
        return None
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype: expected None, torch.float32 or torch.bfloat16, "
                         f"got {compute_dtype!r}")
    return compute_dtype


def _fused_inputs(rgba, dhw, ray_dir, eye_pos, z_dir, tex_dtype=torch.float32):
    """The texture stack in ``tex_dtype`` and the kernels' contiguous ray and
    plane tables."""
    rgba = fused_render.cast_texture(rgba, tex_dtype)
    tex_h, tex_w = rgba.shape[-2], rgba.shape[-1]
    with torch.no_grad():
        scal = fused_render.plane_affine(dhw.float(), eye_pos.float(), tex_h, tex_w).contiguous()
        rx, ry, q = (x.contiguous()
                     for x in fused_render.ray_fields(ray_dir.float(), z_dir.float()))
    return rgba, rx, ry, q, scal


def _fused_partials(rgba, dhw, ray_dir, eye_pos, z_dir, early_out: bool, with_disp: bool,
                    grad_sparsity: bool, adjoint_bands=None, compute_dtype=None
                    ) -> Tuple[torch.Tensor, ...]:
    """``(color, depth[, disp], trans)`` premultiplied partials: through
    ``FusedRender`` when a gradient is wanted (its backward's last stage the
    splat, or the texture-space adjoint given ``adjoint_bands``), else the
    inference form of the forward kernel (no residual).  ``compute_dtype=
    torch.bfloat16``: the forward reads a bf16 copy of the stack (one cast a
    call); the gradient stays fp32."""
    compute_dtype = _compute_dtype(compute_dtype)
    wants_grad = torch.is_grad_enabled() and rgba.requires_grad
    tex_dtype = torch.float32 if wants_grad or compute_dtype is None else compute_dtype
    rgba, rx, ry, q, scal = _fused_inputs(rgba, dhw, ray_dir, eye_pos, z_dir, tex_dtype)
    if wants_grad:
        return fused_render.FusedRender.apply(rgba, rx, ry, q, scal, with_disp, grad_sparsity,
                                              adjoint_bands, compute_dtype)
    return fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, early_out=early_out,
                                           with_disp=with_disp)


def plan_fused(dhw: torch.Tensor, ray_dir: torch.Tensor, eye_pos: torch.Tensor,
               z_dir: torch.Tensor, tex_h: int, tex_w: int):
    """Host-side planning of the fused renderer's texture-space adjoint
    route: the ``plans`` pair for :func:`render_mpi_fused`, ``(None,
    (AdjointBands,))``, whose second half selects the adjoint as the
    backward's last stage in place of the splat.  No kernel reads a plan:
    the forward and the splat are tile kernels that find each tile's texel
    box on the card, and so does the adjoint for each texel tile's box of
    pixels; the first half is therefore None.  What ``plans`` carries is
    ``fused_render.plan_adjoint``'s word that the poses passed its checks:
    every plane in front of the eye, and ``fx`` and ``fy`` monotone along and
    across image rows and columns, which the adjoint's search needs.  Call it
    with concrete poses at the corners of the pose range (for training, the
    truncation corners), so the check covers every pose the sampler can draw.
    Raises where the warp is not monotone."""
    with torch.no_grad():
        scal = fused_render.plane_affine(dhw.float().cpu(), eye_pos.float().cpu(), tex_h, tex_w)
        rx, ry, _ = fused_render.ray_fields(ray_dir.float().cpu(), z_dir.float().cpu())
    return None, (fused_render.plan_adjoint(scal, rx, ry),)


def _adjoint_bands_of(plans):
    """The adjoint bands of a ``plans`` pair, or None for the splat route
    (``plans=None``, or a pair whose second half holds no ``AdjointBands``)."""
    if plans is None:
        return None
    _, adj_plan = plans
    if not adj_plan or not isinstance(adj_plan[0], fused_render.AdjointBands):
        return None
    if len(adj_plan) != 1:
        raise ValueError(f"plans: one AdjointBands covers the whole stack here, got "
                         f"{len(adj_plan)} (the per-chunk band sets of the TPU plan have no "
                         f"counterpart)")
    return adj_plan[0]


def render_mpi_fused(rgba: torch.Tensor, dhw: torch.Tensor, ray_dir: torch.Tensor,
                     eye_pos: torch.Tensor, z_dir: torch.Tensor, plans=None,
                     early_out: bool = True, with_disp: bool = True,
                     compute_dtype: Optional[torch.dtype] = None) -> RenderOutput:
    """Render through the fused warp+composite kernels, differentiable in
    ``rgba``.

    Same semantics as :func:`render_mpi` with align_corners=True.  Float32
    unless ``compute_dtype=torch.bfloat16``: then the forward kernel reads a
    bf16 copy of the textures (``rgba.to(torch.bfloat16)``, one cast a call)
    with fp32 weights, sums and outputs, as the JAX package's ``compute_dtype``
    does (~2e-3 of the fp32 render); the backward stays fp32 and the gradient
    reaches ``rgba`` in its own dtype.  A bf16 ``rgba`` with the default is
    cast to fp32 on the way in and its gradient back on the way out.  The
    gradient reaches ``rgba`` only.  ``rgba [V, L, 4, Th,
    Tw]`` may be an ``expand`` of one MPI over views; without a gradient it
    may also hold ``S`` MPIs for ``V = S * k`` views, MPI ``n`` rendered into
    views ``n * k ... (n + 1) * k - 1`` and read once for all of them (with a
    gradient this raises: expand the MPIs instead).  Without a gradient to
    compute (``torch.no_grad()``, or ``rgba`` not requiring one) the forward
    kernel runs in its inference form: no residual, ``early_out`` on the
    transmittance.  With one, it keeps the residual and stops a pixel by the
    grad-safe rule (``fused_render.GRAD_TAU``) whatever ``early_out`` says:
    the transmittance rule would corrupt an occluder's alpha gradient.

    ``plans`` selects the backward's last stage, as in the JAX package: a
    ``(plan, adj_plan)`` pair whose ``adj_plan`` holds ``AdjointBands`` (from
    :func:`plan_fused`) takes the texture-space adjoint kernel, deterministic
    and atomic-free; ``None``, or any other plan, takes the splat.  The
    forward needs no plan (a per-pixel CUDA gather has no static bands).
    ``with_disp=False`` leaves ``disp`` None.
    """
    with profile_scope("render.fused"):
        outs = _fused_partials(rgba, dhw, ray_dir, eye_pos, z_dir, early_out, with_disp,
                               grad_sparsity=True, adjoint_bands=_adjoint_bands_of(plans),
                               compute_dtype=compute_dtype)
    return RenderOutput(color=outs[0], depth=outs[1], disp=outs[2] if with_disp else None)


def make_fused_slab_renderer(with_disp: bool = False,
                             compute_dtype: Optional[torch.dtype] = None):
    """The fused renderer for one plane slab: ``fn(rgba_slab, dhw_slab,
    ray_dir, eye_pos, z_dir) -> (color_pre, depth_pre[, disp_pre], trans)``,
    the partials of :func:`render_slab_partial` for :func:`combine_segments`,
    differentiable in ``rgba_slab`` (``trans`` included).  Under autograd a
    slab processes every plane: what stands in front of it is not known to
    it, so no occlusion rule applies, with or without autograd.
    ``compute_dtype`` as in :func:`render_mpi_fused`.  The JAX factory's band
    and splat plans have no counterpart here."""
    compute_dtype = _compute_dtype(compute_dtype)

    def fn(rgba, dhw, ray_dir, eye_pos, z_dir):
        return _fused_partials(rgba, dhw, ray_dir, eye_pos, z_dir, False, with_disp,
                               grad_sparsity=False, compute_dtype=compute_dtype)

    return fn


def render_mpi_fused_remat(rgba: torch.Tensor, dhw: torch.Tensor, ray_dir: torch.Tensor,
                           eye_pos: torch.Tensor, z_dir: torch.Tensor, plane_chunk: int = 8,
                           with_disp: bool = True,
                           compute_dtype: Optional[torch.dtype] = None) -> RenderOutput:
    """Memory-rematerialized fused render: slabs of ``plane_chunk`` planes
    render through the slab renderer under ``torch.utils.checkpoint`` and
    their partials combine front to back, so the backward holds one slab's
    residual and cotangents at a time; each slab's forward runs twice.
    Semantics of :func:`render_mpi_fused` (``compute_dtype`` included);
    ``plane_chunk`` takes the place of the JAX package's plan chunks."""
    if plane_chunk < 1:
        raise ValueError(f"plane_chunk: expected >= 1, got {plane_chunk}")
    slab = make_fused_slab_renderer(with_disp=with_disp, compute_dtype=compute_dtype)
    carry = None
    with profile_scope("render.fused"):
        for lo in range(0, rgba.shape[1], plane_chunk):
            hi = lo + plane_chunk
            part = checkpoint(slab, rgba[:, lo:hi], dhw[lo:hi], ray_dir, eye_pos, z_dir,
                              use_reentrant=False)
            carry = part if carry is None else combine_segments(carry, part)
    return RenderOutput(color=carry[0], depth=carry[1], disp=carry[2] if with_disp else None)


def ray_coverage_ok(dhw_last: torch.Tensor, eye_pos: torch.Tensor, ray_dir: torch.Tensor,
                    z_dir: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """0-dim bool tensor: True iff every ray of every view intersects the
    *last* plane inside its extent (the reference checks this on every
    forward).  dhw_last ``[3]`` or ``[V, 3]``, eye_pos / z_dir ``[V, 3]``,
    ray_dir ``[V, 3, H, W]``.  No host synchronization."""
    v = ray_dir.shape[0]
    dl = torch.as_tensor(dhw_last, dtype=torch.float32, device=ray_dir.device)
    if dl.ndim == 1:
        dl = dl[None].expand(v, 3)
    grid, _ = homography_grid(dl, eye_pos.float(), ray_dir.float(), z_dir.float(), align_corners)
    return torch.all(torch.abs(grid) <= 1.0)


def poison_if_rays_escape(color: torch.Tensor, dhw_last: torch.Tensor, eye_pos: torch.Tensor,
                          ray_dir: torch.Tensor, z_dir: torch.Tensor,
                          align_corners: bool = True) -> torch.Tensor:
    """Debug-mode analogue of the reference's ``assert_not_out_of_last_plane``:
    NaN-poison the rendered color when any ray leaves the last plane's extent,
    so that a bad (pose, volume) combination shows at the consumer instead of
    silently compositing zeros padding (``TrainHparams.debug_ray_check``)."""
    ok = ray_coverage_ok(dhw_last, eye_pos, ray_dir, z_dir, align_corners)
    return torch.where(ok, color, float("nan"))


def check_rays_hit_last_plane(dhw_last: torch.Tensor, eye_pos: torch.Tensor,
                              ray_dir: torch.Tensor, z_dir: torch.Tensor,
                              align_corners: bool = True) -> bool:
    """Eager check that every ray intersects the last plane inside its extent
    (a Python bool; synchronizes).  dhw_last ``[V, 3]``."""
    grid, _ = homography_grid(dhw_last, eye_pos, ray_dir, z_dir, align_corners)
    return bool(torch.all((grid >= -1) & (grid <= 1)))
