"""Weight carry-across and warm start (port of ``gmpi_tpu/models/converter.py``).

The JAX param and buffer trees use the reference's state-dict nesting, so a
leaf at ``params["synthesis"]["b64"]["conv0"]["affine"]["bias"]`` is the torch
key ``synthesis.b64.conv0.affine.bias`` and ``buffers["mapping"]["w_avg"]``
is ``mapping.w_avg``; the discriminator's tree (``b256.conv0.weight``,
``mapping.bias``, ``b4.fc.weight``) maps the same way and has no buffers.
Values arrive as numpy arrays (the caller converts the JAX trees with
``np.asarray``); the result loads with ``Generator.load_state_dict(sd,
strict=True)`` or ``Discriminator.load_state_dict``.  ``resample_filter`` is a
constant, non-persistent buffer on the torch side and is never carried.

The warm-start half works on reference-named state dicts, the form of the
released GMPI checkpoints and of StyleGAN2 pickles converted by the
reference's ``legacy.py``.  On this side a "tree" is a flat state dict keyed
by those names: :func:`convert_state_dict` splits one into parameters and
buffers (``noise_const``, ``w_avg``, ``*_left_append``) as the JAX package
does, and :func:`merge_converted` fills a module's initial state from it.
With ``require_all=False`` (the warm start, ``misc.copy_params_and_buffers
(require_all=False)``, ``gmpi/models/torch_utils/misc.py:156-164``,
``gmpi/train.py:197-230``) a key missing from the file keeps its initial
value (the new alpha and depth-embedding heads), a key with no counterpart in
the module is ignored, and a shape mismatch raises under ``strict_shapes``.
A bare ``load_state_dict(strict=False)`` does none of the last two: it raises
on any shape mismatch and reports no copied keys.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def params_from_jax(params_np: Mapping, buffers_np: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """Nested (params, buffers) trees of numpy arrays -> a torch state dict of
    float32 CPU tensors keyed by dotted paths."""
    sd = {}
    for tree in (params_np, buffers_np or {}):
        for path, v in _flatten(tree).items():
            key = ".".join(path)
            if key in sd:
                raise ValueError(f"{key} appears in both params and buffers")
            sd[key] = torch.as_tensor(np.array(v, dtype=np.float32))
    return sd


SKIP_SUFFIXES = ("resample_filter",)
Tree = Dict[str, torch.Tensor]  # a flat state dict


def torch_key_to_path(key: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """Map a state-dict key to ``("params"|"buffers", path)``, or None for a
    constant that is not stored."""
    parts = tuple(key.split("."))
    if parts[-1] in SKIP_SUFFIXES:
        return None
    if parts[-1] in ("noise_const", "w_avg") or parts[-1].endswith("_left_append"):
        return "buffers", parts
    return "params", parts


def convert_state_dict(sd: Mapping[str, object]) -> Tuple[Tree, Tree]:
    """A reference-named state dict (numpy or torch values) -> ``(params,
    buffers)``, flat dicts of float32 CPU tensors.  Works for G and D."""
    params: Tree = {}
    buffers: Tree = {}
    for key, val in sd.items():
        dest = torch_key_to_path(key)
        if dest is None:
            continue
        t = val.detach().cpu() if isinstance(val, torch.Tensor) else torch.from_numpy(
            np.array(val))
        (params if dest[0] == "params" else buffers)[key] = t.to(torch.float32)
    return params, buffers


def tree_to_state_dict(params: Mapping, buffers: Optional[Mapping] = None
                       ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_state_dict`: flat (or nested) trees of tensors
    -> one reference-named state dict of numpy arrays."""
    sd = {}
    for tree in (params, buffers or {}):
        for path, v in _flatten(tree).items():
            sd[".".join(path)] = v.detach().cpu().numpy() if isinstance(
                v, torch.Tensor) else np.asarray(v)
    return sd


def module_trees(module: torch.nn.Module) -> Tuple[Tree, Tree]:
    """A module's state as ``(params, buffers)`` flat dicts (persistent
    buffers only), detached, on the module's device."""
    params = {k: p.detach() for k, p in module.named_parameters()}
    buffers = {k: v.detach() for k, v in module.state_dict().items() if k not in params}
    return params, buffers


def merge_converted(init_tree: Mapping[str, torch.Tensor], converted: Mapping[str, torch.Tensor],
                    *, require_all: bool = True, strict_shapes: bool = True
                    ) -> Tuple[Tree, List[str]]:
    """Fill ``init_tree`` with the entries of ``converted`` (both flat).

    ``require_all=False`` is the reference's warm start: keys missing from
    ``converted`` keep their initial values, keys of ``converted`` with no
    counterpart in ``init_tree`` are ignored.  A shape mismatch raises under
    ``strict_shapes``, else keeps the initial value.  Returns ``(merged,
    missing keys)``; the merged values take the initial ones' dtype."""
    missing = [k for k in init_tree if k not in converted]
    if require_all and missing:
        raise KeyError(f"missing {len(missing)} entries, e.g. {missing[:5]}")
    merged: Tree = {}
    for key, init_val in init_tree.items():
        val = converted.get(key)
        if val is None:
            merged[key] = init_val
            continue
        if tuple(val.shape) != tuple(init_val.shape):
            if strict_shapes:
                raise ValueError(f"{key}: {tuple(val.shape)} != {tuple(init_val.shape)}")
            val = init_val
        merged[key] = torch.as_tensor(val, dtype=init_val.dtype).reshape(init_val.shape)
    return merged, missing


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a ``.pth`` state dict (tensors only, ``weights_only``) as numpy
    values.  Accepts a bare state dict or the reference's training layout
    with the state dict under ``"state_dict"``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and all(isinstance(v, torch.Tensor) for v in obj.values()):
        sd = obj
    elif isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
    else:
        raise ValueError(f"unrecognized checkpoint layout: {type(obj)}")
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def convert_generator_checkpoint(sd: Mapping[str, object], gen_cfg, *, warm_start: bool = False,
                                 generator: Optional[torch.Generator] = None
                                 ) -> Tuple[Tree, Tree]:
    """State dict -> ``(params, buffers)`` shaped exactly like a
    ``Generator(gen_cfg)``, whose initial values (drawn from ``generator`` on
    the CPU) fill what the file lacks under ``warm_start`` (vanilla StyleGAN2
    -> MPI generator).  Load the result with ``G.load_state_dict({**params,
    **buffers}, strict=True)``."""
    from gmpi_tpu_torch.models.generator import Generator

    params0, buffers0 = module_trees(Generator(gen_cfg, generator=generator))
    conv_p, conv_b = convert_state_dict(sd)
    params, _ = merge_converted(params0, conv_p, require_all=not warm_start)
    buffers, _ = merge_converted(buffers0, conv_b, require_all=not warm_start)
    return params, buffers


def convert_discriminator_checkpoint(sd: Mapping[str, object], disc_cfg, *,
                                     warm_start: bool = False,
                                     generator: Optional[torch.Generator] = None) -> Tree:
    """As :func:`convert_generator_checkpoint` for a ``Discriminator(disc_cfg)``
    (parameters only: it has no persistent buffers)."""
    from gmpi_tpu_torch.models.discriminator import Discriminator

    params0, _ = module_trees(Discriminator(disc_cfg, generator=generator))
    conv_p, _ = convert_state_dict(sd)
    params, _ = merge_converted(params0, conv_p, require_all=not warm_start)
    return params
