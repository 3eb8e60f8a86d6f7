"""Process meshes over ``torch.distributed`` (port of ``gmpi_tpu/parallel/mesh.py``).

The JAX package splits its devices into a ``jax.sharding.Mesh`` with named
axes; here one process drives one card and the world of processes is split
the same way:

* ``data``  — the batch is split over the ranks of this axis; gradients are
  averaged over them (the reference's DDP all-reduce);
* ``plane`` — the renderer's plane axis is split into contiguous slabs;
* ``tile``  — the renderer's output pixel rows are split into blocks.

Ranks are laid out row-major over the axes (the last axis varies fastest,
as the JAX mesh reshapes its device list), and every axis gets one process
group per line of ranks along it (``dist.new_group``, created by every rank
in the same order).  :class:`Mesh` holds this rank's coordinate and group on
each axis and its device: ``cuda:LOCAL_RANK`` unless the caller names one.

The collectives below are the one place where the transport is chosen: a
group whose backend is ``gloo`` moves CUDA tensors through host memory (gloo
reduces and broadcasts CUDA tensors but gathers only host ones); any other
backend (NCCL) moves device tensors directly.  Each counts the bytes this
rank hands to it in ``COLLECTIVE_BYTES``.  A group of None (a
mesh axis of size 1 without a process group) is a world of one: every
collective is the identity.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

# payload bytes this rank handed to collectives (all-gather: its own tensor;
# all-reduce and broadcast: the tensor)
COLLECTIVE_BYTES = {"bytes": 0}


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` in group-rank order (same shape on every rank), on
    ``t``'s device; no gradient."""
    if group is None:
        return [t]
    COLLECTIVE_BYTES["bytes"] += t.numel() * t.element_size()
    src = t.detach().contiguous()
    if _staged(src, group):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


class AsyncGather:
    """:func:`all_gather` started now and finished by :meth:`wait` (the
    collective runs while the caller computes)."""

    def __init__(self, t: torch.Tensor, group):
        self.device, self.work = t.device, None
        if group is None:
            self.out = [t.detach()]
            return
        COLLECTIVE_BYTES["bytes"] += t.numel() * t.element_size()
        src = t.detach().contiguous()
        if _staged(src, group):
            src = src.cpu()
        self.out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        self.work = dist.all_gather(self.out, src, group=group, async_op=True)

    def wait(self) -> List[torch.Tensor]:
        if self.work is not None:
            self.work.wait()
        return [o.to(self.device) for o in self.out]


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if group is None:
        return t
    COLLECTIVE_BYTES["bytes"] += t.numel() * t.element_size()
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """In-place broadcast of group rank ``src``'s ``t``; returns ``t``."""
    if group is None:
        return t
    COLLECTIVE_BYTES["bytes"] += t.numel() * t.element_size()
    root = dist.get_global_rank(group, src)
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src=root, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=root, group=group)
    return t


# -- autograd across ranks -------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its adjoint is the same sum, so it is
    differentiable to any order."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class _GatherBatch(torch.autograd.Function):
    """Concatenate every rank's ``x`` along dim 0 (rank order).  The ranks'
    losses downstream differ, so the adjoint sums every rank's cotangent of
    this rank's rows (a reduce-scatter, here an all-reduce and a slice),
    differentiable again for a double backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return torch.cat(all_gather(x, group), dim=0)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return _AllReduceSum.apply(g, ctx.group)[r * ctx.n:(r + 1) * ctx.n], None


def gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's batch ``x`` concatenated in rank order, differentiable to
    any order, for a computation that couples samples across ranks (the
    discriminator's minibatch standard deviation)."""
    if group is None:
        return x
    return _GatherBatch.apply(x, group)


class _ReplicatedInput(torch.autograd.Function):
    """Identity on a tensor replicated over ``group`` whose ranks each use a
    part of it (their pixel rows): the adjoint sums their cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; in the backward the cotangent is summed over
    ``group`` (every rank of it holds ``x`` and uses its own part)."""
    if group is None:
        return x
    return _ReplicatedInput.apply(x, group)


class _ShardPlanes(torch.autograd.Function):
    """This rank's share of the plane axis (dim 1) of a replicated stack: the
    planes ``[V, L, ...]`` as ``[V, n_sub, n, c, ...]`` (``c = L / (n *
    n_sub)``), index ``rank`` of the ``n`` axis -> ``[V, n_sub * c, ...]``.
    The adjoint gathers every rank's share of the cotangent into the whole
    stack's, so the replicated computation upstream gets its full gradient
    on every rank."""

    @staticmethod
    def forward(ctx, x, group, n_sub):
        n, r = group_size(group), group_rank(group)
        v, n_l = x.shape[0], x.shape[1]
        c = n_l // (n * n_sub)
        ctx.group, ctx.shape, ctx.n_sub, ctx.c = group, x.shape, n_sub, c
        parts = x.reshape(v, n_sub, n, c, *x.shape[2:])[:, :, r]
        return parts.reshape(v, n_sub * c, *x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        v, rest = ctx.shape[0], ctx.shape[2:]
        shares = [s.reshape(v, ctx.n_sub, ctx.c, *rest) for s in all_gather(g, ctx.group)]
        return torch.stack(shares, dim=2).reshape(ctx.shape), None, None


def shard_planes(x: torch.Tensor, group, n_sub: int = 1) -> torch.Tensor:
    """This rank's planes of ``x [V, L, ...]``: contiguous slab ``rank`` for
    ``n_sub = 1``; for ``n_sub`` super-slabs, slab ``rank`` of each,
    concatenated.  Differentiable: the backward all-gathers the shares."""
    n = group_size(group)
    if x.shape[1] % (n * n_sub):
        raise ValueError(f"{x.shape[1]} planes do not split into {n_sub} x {n} shards")
    if group is None:
        return x
    return _ShardPlanes.apply(x, group, n_sub)


def gather_own_live(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` in rank order, this rank's slot being ``t`` itself
    (its graph kept) and the others received constants.  For results that
    every rank folds identically into a loss they all compute (a replicated
    loss): the gradient of that loss with respect to this rank's ``t`` is then
    exact on this rank, and no cotangent needs to travel."""
    out = all_gather(t, group)
    out[group_rank(group)] = t
    return out


# -- the mesh ---------------------------------------------------------------------


def local_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda:LOCAL_RANK`` (0 without the variable)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


class Mesh:
    """The world of processes split into named axes (see the module doc).

    ``Mesh(axis_sizes, axis_names, device)``: the product of ``axis_sizes``
    must equal the world size of the default process group; a mesh of more
    than one rank without an initialized process group raises.  ``shape``
    maps axis -> size, ``coords`` axis -> this rank's index, ``group(axis)``
    the process group of this rank's line along the axis (None for a size-1
    axis), ``world`` the default group (None in a world of one)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str] = ("data",),
                 device=None):
        sizes = tuple(int(s) for s in axis_sizes)
        names = tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names) or min(sizes) < 1:
            raise ValueError(f"mesh: axis sizes {sizes} and names {names} do not match")
        n = int(np.prod(sizes))
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        if n != world:
            raise ValueError(f"mesh {dict(zip(names, sizes))} needs {n} ranks, the world has "
                             f"{world}" + ("" if initialized else
                                           " (no torch.distributed process group)"))
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.rank = dist.get_rank() if initialized else 0
        self.coords: Dict[str, int] = dict(zip(names, (int(c) for c in np.unravel_index(
            self.rank, sizes))))
        self.device = local_device(device)
        self.world = dist.group.WORLD if initialized and world > 1 else None
        self._groups: Dict[str, object] = {}
        grid = np.arange(n).reshape(sizes)
        for ax, name in enumerate(names):
            if sizes[ax] == 1:
                self._groups[name] = None
                continue
            lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
            for line in lines:  # every rank creates every group, in one order
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = g

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), device=None) -> Mesh:
    """A mesh over the world; ``axis_sizes=None`` puts every rank on the
    first axis."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = [world] + [1] * (len(axis_names) - 1)
    return Mesh(axis_sizes, axis_names, device)


def batch_share(mesh: Optional[Mesh], n: int, axis: str = "data") -> slice:
    """The rows of a global batch of ``n`` that this rank holds on ``axis``;
    raises unless the axis divides ``n``."""
    k = 1 if mesh is None else mesh.size(axis)
    if n % k:
        raise ValueError(f"a batch of {n} does not split evenly over {k} {axis} ranks")
    i = 0 if mesh is None else mesh.index(axis)
    return slice(i * (n // k), (i + 1) * (n // k))


def replicate(mesh: Mesh, obj: Union[torch.nn.Module, Dict[str, torch.Tensor],
                                     Sequence[torch.Tensor]], src: int = 0):
    """Overwrite every rank's parameters and buffers of a module (or the
    tensors of a dict or sequence) with rank ``src``'s, in place; returns
    ``obj``."""
    if mesh.world is None:
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = itertools.chain(obj.parameters(), obj.buffers())
    elif isinstance(obj, dict):
        tensors = obj.values()
    else:
        tensors = obj
    with torch.no_grad():
        for t in tensors:
            broadcast_(t.data, mesh.world, src)
    return obj


def average_gradients(params: Sequence[torch.nn.Parameter], group) -> None:
    """Average the gradients of ``params`` over ``group`` in place with one
    flat all-reduce (StyleGAN2-ADA's loop; DDP's hooks would not survive the
    R1 double backward).  Parameters without a gradient are left out; the
    ranks must agree on which those are."""
    n = group_size(group)
    grads = [p.grad for p in params if p.grad is not None]
    if n == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group).div_(n)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def all_reduce_mean_dict(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The mean over ``group`` of each 0-dim tensor of ``values``."""
    n = group_size(group)
    if n == 1 or not values:
        return values
    keys = sorted(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    all_reduce_(flat, group).div_(n)
    return {k: flat[i] for i, k in enumerate(keys)}
