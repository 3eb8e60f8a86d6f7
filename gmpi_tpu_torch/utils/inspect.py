"""Model and runtime introspection (port of ``gmpi_tpu/utils/inspect.py``;
the reference's ``misc`` toolbox, ``gmpi/models/torch_utils/misc.py``):

* :func:`assert_shape` -- ``misc.assert_shape`` (``misc.py:83-96``);
* :func:`param_summary` / :func:`print_param_summary` -- the module table
  (``misc.print_module_summary``, ``misc.py:196-264``);
* :func:`profile_scope` -- a named ``torch.profiler`` span
  (``misc.profiled_function``), the port's one span helper, and
  :func:`thread_scope`, the same for worker threads;
* :func:`check_replica_consistency` -- replicated tensors equal on every rank
  (``misc.check_ddp_consistency``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler
import torch.distributed as dist
from torch.profiler import record_function


def assert_shape(x, shape: Sequence[Optional[int]]) -> None:
    """Assert ``x``'s rank and every dimension of ``shape`` that is not None."""
    assert x.ndim == len(shape), f"rank {x.ndim} != {len(shape)}"
    for i, (got, want) in enumerate(zip(x.shape, shape)):
        if want is not None:
            assert got == want, f"dim {i}: {got} != {want} (shape {tuple(x.shape)})"


def param_summary(tree: Union[torch.nn.Module, Mapping], prefix: str = "") -> Tuple[list, int]:
    """``(rows, total)``: a ``(path, shape, count)`` row per parameter and the
    total count.  ``tree`` is a module (its parameters), a flat state dict
    with dotted keys, or nested mappings of tensors; rows are ordered as the
    JAX function orders a nested tree (sorted level by level)."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (str(k),))
            else:
                flat[path + tuple(str(k).split("."))] = v

    walk(tree, (prefix,) if prefix else ())
    rows, total = [], 0
    for path in sorted(flat):
        shape = tuple(flat[path].shape)
        n = 1
        for s in shape:
            n *= int(s)
        rows.append((".".join(path), shape, n))
        total += n
    return rows, total


def print_param_summary(tree: Union[torch.nn.Module, Mapping], prefix: str = "",
                        max_rows: int = 0) -> int:
    """Print :func:`param_summary`'s rows (the first ``max_rows`` when > 0)
    and the total; returns the total."""
    rows, total = param_summary(tree, prefix)
    shown = rows if max_rows <= 0 else rows[:max_rows]
    width = max((len(r[0]) for r in shown), default=10)
    for name, shape, n in shown:
        print(f"{name:<{width}}  {str(shape):<20} {n:>12,}")
    if max_rows > 0 and len(rows) > max_rows:
        print(f"... {len(rows) - max_rows} more entries")
    print(f"{'TOTAL':<{width}}  {'':<20} {total:>12,}")
    return total


# what a span is while no profiler runs: one shared context that does nothing
_NO_SPAN = contextlib.nullcontext()


def profile_scope(name: str):
    """A span named ``name`` in ``torch.profiler`` traces (a
    ``record_function``, on the profiler's clock with the device's kernels);
    while no profiler runs, a shared context that does nothing, so a span
    costs one flag read (the flag ``torch.autograd.profiler`` keeps for the
    whole process while a profiler runs, so a span opened on autograd's
    thread is seen too).  ``with profile_scope("layer.part"): ...``"""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return record_function(name)


# spans of worker threads, kept while a profiler runs: ``(name, start_ns,
# end_ns, thread id)`` on ``time.time_ns``, the profiler's clock
KEPT_SPANS: collections.deque = collections.deque(maxlen=1 << 16)


class _KeptSpan:
    __slots__ = ("name", "inner", "t0")

    def __init__(self, name: str):
        self.name = name
        self.inner = record_function(name)

    def __enter__(self):
        self.inner.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.inner.__exit__(*exc)
        KEPT_SPANS.append((self.name, self.t0, t1, threading.get_ident()))
        return False


def thread_scope(name: str):
    """:func:`profile_scope` for code that runs on worker threads (the
    loader's).  ``torch.profiler`` records the spans of the thread that
    started it, and of the threads PyTorch hands that thread's state to
    (autograd's), but not those of a thread pool of Python's; so while a
    profiler runs the span is also appended to :data:`KEPT_SPANS`.  Without
    a profiler it is the same shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _KeptSpan(name)


def check_replica_consistency(tensors_or_module: Union[torch.nn.Module, Mapping, Sequence],
                              group=None, atol: float = 0.0) -> None:
    """Assert that every rank of ``group`` (the default group when None)
    holds the same values as its rank 0: DDP's broadcast-and-compare
    (``misc.check_ddp_consistency``), the counterpart of the JAX function's
    comparison of a replicated array's shards.  ``tensors_or_module``: a
    module (its state dict), a mapping of names to tensors, or a sequence of
    tensors.  Rank 0's values are broadcast (one flat buffer a dtype) and
    each rank's largest absolute difference per tensor is reduced over the
    group, so every rank raises alike on divergence, naming the tensor with
    the largest difference beyond ``atol``.  Without a process group, or in
    a group of one, it does nothing."""
    from gmpi_tpu_torch.parallel import mesh as mesh_mod

    if not (dist.is_available() and dist.is_initialized()):
        return
    group = group if group is not None else dist.group.WORLD
    if dist.get_world_size(group) == 1:
        return
    if isinstance(tensors_or_module, torch.nn.Module):
        named = tensors_or_module.state_dict()
    elif isinstance(tensors_or_module, Mapping):
        named = dict(tensors_or_module)
    else:
        named = {str(i): t for i, t in enumerate(tensors_or_module)}
    names = sorted(named)
    if not names:
        return
    # one device for the buffers (an optimizer's step counts live on the host)
    dev = next((t.device for t in named.values() if t.device.type != "cpu"),
               torch.device("cpu"))
    diffs = torch.zeros(len(names), dtype=torch.float64)
    for dtype in sorted({named[k].dtype for k in names}, key=str):
        idx = [i for i, k in enumerate(names) if named[k].dtype == dtype]
        mine = torch.cat([named[names[i]].detach().reshape(-1).to(dev) for i in idx])
        ref = mesh_mod.broadcast_(mine.clone(), group, 0)
        for i, a, b in zip(idx, mine.split([named[names[i]].numel() for i in idx]),
                           ref.split([named[names[i]].numel() for i in idx])):
            if a.numel():
                d = (a.double() - b.double()).abs()
                # NaN against NaN is a match; NaN against a number is not
                d = torch.where(torch.isnan(a.double()) & torch.isnan(b.double()), 0.0, d)
                diffs[i] = float(d.nan_to_num(float("inf")).max())
    if dist.get_backend(group) != "gloo":  # NCCL reduces device tensors only
        diffs = diffs.to(dev)
    mesh_mod.all_reduce_(diffs, group, op=dist.ReduceOp.MAX)
    diffs = diffs.cpu()
    if float(diffs.max()) > atol:
        worst = int(diffs.argmax())
        raise AssertionError(
            f"replica divergence at {names[worst]}: max abs diff {float(diffs[worst])} from "
            f"rank 0 ({int((diffs > atol).sum())} of {len(names)} tensors beyond atol {atol})")
