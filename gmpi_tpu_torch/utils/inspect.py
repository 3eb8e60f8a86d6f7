"""Model introspection (port of ``param_summary`` from
``gmpi_tpu/utils/inspect.py``; the reference's ``misc.print_module_summary``,
``gmpi/models/torch_utils/misc.py:196-264``)."""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch


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
