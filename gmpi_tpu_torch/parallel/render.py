"""Multi-card MPI rendering over ``torch.distributed`` (port of
``gmpi_tpu/parallel/render.py``).

The same functions under the same names and arguments as the JAX package's,
with a :class:`~gmpi_tpu_torch.parallel.mesh.Mesh` and an axis name that
selects the process group in place of the mesh axis.  Every rank calls them
with the same full (replicated) inputs and gets the same full outputs; each
renders only its share:

* **Tile sharding** — output pixel rows split over the ``tile`` group; each
  rank warps and composites every plane for its rows, and the row blocks are
  gathered.
* **Plane sharding** — the plane axis split into contiguous slabs over the
  ``plane`` group; each rank composites its slab into premultiplied partials
  ``(color_pre, depth_pre[, disp_pre], trans)`` and the partials combine in
  plane order, front shard first, ``(c_f + T_f * c_b, ..., T_f * T_b)``:
  gathered and folded on every rank, whatever the group's size.  Exact:
  over-compositing is associative over contiguous slabs.

Gradients.  Every rank computes the same loss on the same full image, so the
gathered results from other ranks enter as constants and this rank's own
share keeps its graph (``mesh.gather_own_live``): the gradient with respect
to its own partial or rows is then exact where it is, and no cotangent
travels back through the exchange (an all-gather whose backward summed the
ranks' cotangents would count the loss once per rank).  What does travel is
the gradient of the input stack: the slice of this rank's planes gathers
every rank's slab cotangent in its backward (``mesh.shard_planes``), and the
stack that each tile rank reads whole sums the ranks' cotangents
(``mesh.replicated_input``), so that the stack's gradient, and everything
upstream of it, is complete and the same on every rank.

``slab_fn`` / ``render_fn`` plug in the fused renderer (``core.renderer.
make_fused_slab_renderer`` / ``render_mpi_fused``); the default route is
``render_slab_partial`` / ``render_mpi`` with ``tiled_bands``, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from gmpi_tpu_torch.core.renderer import (RenderOutput, combine_segments, render_mpi,
                                          render_slab_partial)
from gmpi_tpu_torch.parallel import mesh as mesh_mod
from gmpi_tpu_torch.parallel.mesh import Mesh


def _pack(part: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in part])


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    return tuple(x.view_as(t) for x, t in zip(flat.split([t.numel() for t in like]), like))


def _fold(part: Tuple[torch.Tensor, ...], slots: Sequence[torch.Tensor],
          own: int) -> Tuple[torch.Tensor, ...]:
    """Fold every rank's packed partials front to back, this rank's slot
    ``own`` being ``part`` itself (its graph kept)."""
    carry = None
    for i, flat in enumerate(slots):
        p = part if i == own else _unpack(flat, part)
        carry = p if carry is None else combine_segments(carry, p)
    return carry


def ordered_allcombine(part: Sequence[torch.Tensor], group) -> Tuple[torch.Tensor, ...]:
    """Ordered combine of every rank's slab partials over ``group`` (group
    rank order = plane order): the partials are all-gathered and every rank
    folds them front to back, so every rank holds the whole composite.  The
    other ranks' partials enter as constants (see the module doc).  Any group
    size; each rank receives ``n - 1`` partials (the JAX package's butterfly
    for power-of-two groups receives ``log2(n)``: the same at ``n = 2``)."""
    part = tuple(part)
    return _fold(part, mesh_mod.all_gather(_pack(part), group), mesh_mod.group_rank(group))


def _rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of rows (dim 2) of ``x [V, C, H, W]``."""
    n, i = mesh_mod.group_size(group), mesh_mod.group_rank(group)
    h = x.shape[2]
    if h % n:
        raise ValueError(f"{h} rows do not split over {n} tile ranks")
    return x[:, :, i * (h // n):(i + 1) * (h // n)]


def _gather_rows(x: Optional[torch.Tensor], group) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.cat(mesh_mod.gather_own_live(x.contiguous(), group), dim=2)


def _slab_partial(rgba_slab, dhw_slab, ray_dir, eye_pos, z_dir, align_corners, tiled_bands,
                  slab_fn, with_disp):
    if slab_fn is not None:
        part = slab_fn(rgba_slab, dhw_slab, ray_dir, eye_pos, z_dir)
        if len(part) != (4 if with_disp else 3):
            raise ValueError(f"slab_fn returned {len(part)} partials, with_disp={with_disp}")
        return part
    v = rgba_slab.shape[0]
    slab_dhw = dhw_slab[None].expand(v, dhw_slab.shape[0], 3)
    return render_slab_partial(rgba_slab, slab_dhw, ray_dir, eye_pos, z_dir, align_corners,
                               tiled_bands=tiled_bands, with_disp=with_disp)


def _output(outs, with_disp: bool) -> RenderOutput:
    return RenderOutput(color=outs[0], depth=outs[1], disp=outs[2] if with_disp else None)


def _check_planes(n_planes: int, n: int) -> None:
    if n_planes % n:
        raise ValueError(f"{n_planes} planes do not split over {n} plane ranks")


def render_mpi_tile_sharded(mesh: Mesh, rgba: torch.Tensor, dhw: torch.Tensor,
                            ray_dir: torch.Tensor, eye_pos: torch.Tensor, z_dir: torch.Tensor,
                            axis: str = "tile", align_corners: bool = True,
                            tiled_bands: Optional[Tuple[int, ...]] = None,
                            render_fn: Optional[Callable] = None, with_disp: bool = False
                            ) -> RenderOutput:
    """Render with output pixel rows split over ``mesh.group(axis)``: each
    rank renders every plane of ``rgba [V, L, 4, Th, Tw]`` for its block of
    the rows of ``ray_dir [V, 3, H, W]``, and the blocks are gathered, so
    every rank returns the whole image.  ``render_fn(rgba, dhw, rays, eye, z)
    -> RenderOutput`` plugs in any single-card renderer (``render_mpi_fused``);
    else ``render_mpi`` with ``tiled_bands``.  ``with_disp`` also returns the expected disparity."""
    group = mesh.group(axis)
    rgba = mesh_mod.replicated_input(rgba, group)
    rays = _rows(ray_dir, group)
    if render_fn is not None:
        out = render_fn(rgba, dhw, rays, eye_pos, z_dir)
    else:
        out = render_mpi(rgba, dhw, rays, eye_pos, z_dir, align_corners,
                         tiled_bands=tiled_bands)
    if with_disp and out.disp is None:
        raise ValueError("render_fn must populate disp when with_disp is set")
    return RenderOutput(color=_gather_rows(out.color, group), depth=_gather_rows(out.depth, group),
                        disp=_gather_rows(out.disp, group) if with_disp else None)


def render_mpi_plane_sharded(mesh: Mesh, rgba: torch.Tensor, dhw: torch.Tensor,
                             ray_dir: torch.Tensor, eye_pos: torch.Tensor, z_dir: torch.Tensor,
                             axis: str = "plane", align_corners: bool = True,
                             tiled_bands: Optional[Tuple[int, ...]] = None,
                             slab_fn: Optional[Callable] = None, with_disp: bool = False
                             ) -> RenderOutput:
    """Render with the plane axis split over ``mesh.group(axis)``: rank *i*
    renders planes ``[i L/n, (i+1) L/n)`` (front to back) into slab partials
    and the partials combine in plane order on every rank.  ``dhw [L, 3]``.
    ``slab_fn(rgba_slab, dhw_slab [c, 3], rays, eye, z) -> (color_pre,
    depth_pre[, disp_pre], trans)`` plugs in the fused slab renderer (with a
    matching ``with_disp``); else ``render_slab_partial`` with
    ``tiled_bands``."""
    group = mesh.group(axis)
    n = mesh_mod.group_size(group)
    _check_planes(rgba.shape[1], n)
    c = rgba.shape[1] // n
    i = mesh_mod.group_rank(group)
    part = _slab_partial(mesh_mod.shard_planes(rgba, group), dhw[i * c:(i + 1) * c], ray_dir,
                         eye_pos, z_dir, align_corners, tiled_bands, slab_fn, with_disp)
    return _output(ordered_allcombine(part, group), with_disp)


def render_mpi_plane_sharded_pipelined(mesh: Mesh, rgba: torch.Tensor, dhw: torch.Tensor,
                                       ray_dir: torch.Tensor, eye_pos: torch.Tensor,
                                       z_dir: torch.Tensor, n_sub: int = 2,
                                       axis: str = "plane", align_corners: bool = True,
                                       tiled_bands: Optional[Tuple[int, ...]] = None,
                                       slab_fn: Optional[Callable] = None,
                                       with_disp: bool = False) -> RenderOutput:
    """Plane-sharded render whose exchange overlaps the warp.  The plane
    axis is cut into ``n_sub`` front-to-back super-slabs, each split over the
    group (global plane ``k (n c) + i c + j`` is rank *i*'s plane *j* of
    super-slab *k*), so every rank renders a piece of every super-slab.  The
    gather of super-slab *k*'s partials is started asynchronously
    (``async_op=True``) and runs while super-slab *k + 1* is rendered; then
    it is folded in plane order.  The exchanged partials are whole images
    whatever the slab size, so the bytes grow ``n_sub``-fold over
    :func:`render_mpi_plane_sharded`."""
    group = mesh.group(axis)
    n = mesh_mod.group_size(group)
    _check_planes(rgba.shape[1], n * n_sub)
    c = rgba.shape[1] // (n * n_sub)
    i = mesh_mod.group_rank(group)
    mine = mesh_mod.shard_planes(rgba, group, n_sub)   # [V, n_sub * c, ...]
    dhw_r = dhw.reshape(n_sub, n, c, 3)[:, i]           # [n_sub, c, 3]

    def sub_partial(k):
        return _slab_partial(mine[:, k * c:(k + 1) * c], dhw_r[k], ray_dir, eye_pos, z_dir,
                             align_corners, tiled_bands, slab_fn, with_disp)

    acc = None
    part = sub_partial(0)
    for k in range(n_sub):
        pending = mesh_mod.AsyncGather(_pack(part), group)
        nxt = sub_partial(k + 1) if k + 1 < n_sub else None  # the warp of k + 1 ...
        combined = _fold(part, pending.wait(), i)           # ... while k is on the wire
        acc = combined if acc is None else combine_segments(acc, combined)
        part = nxt
    return _output(acc, with_disp)


def render_mpi_plane_tile_sharded(mesh: Mesh, rgba: torch.Tensor, dhw: torch.Tensor,
                                  ray_dir: torch.Tensor, eye_pos: torch.Tensor,
                                  z_dir: torch.Tensor, plane_axis: str = "plane",
                                  tile_axis: str = "tile", align_corners: bool = True,
                                  tiled_bands: Optional[Tuple[int, ...]] = None,
                                  slab_fn: Optional[Callable] = None, with_disp: bool = False
                                  ) -> RenderOutput:
    """Planes over ``plane_axis`` x pixel rows over ``tile_axis``: each rank
    renders its slab for its rows; the partials combine over the plane group
    and the row blocks are gathered over the tile group."""
    pg, tg = mesh.group(plane_axis), mesh.group(tile_axis)
    n = mesh_mod.group_size(pg)
    _check_planes(rgba.shape[1], n)
    c = rgba.shape[1] // n
    i = mesh_mod.group_rank(pg)
    slab = mesh_mod.replicated_input(mesh_mod.shard_planes(rgba, pg), tg)
    part = _slab_partial(slab, dhw[i * c:(i + 1) * c], _rows(ray_dir, tg), eye_pos, z_dir,
                         align_corners, tiled_bands, slab_fn, with_disp)
    outs = ordered_allcombine(part, pg)[:-1]
    return _output(tuple(_gather_rows(x, tg) for x in outs), with_disp)
