"""Weight carry-across from the JAX package (port of the name walk in
``gmpi_tpu/models/converter.py``).

The JAX param and buffer trees use the reference's state-dict nesting, so a
leaf at ``params["synthesis"]["b64"]["conv0"]["affine"]["bias"]`` is the torch
key ``synthesis.b64.conv0.affine.bias`` and ``buffers["mapping"]["w_avg"]``
is ``mapping.w_avg``; the discriminator's tree (``b256.conv0.weight``,
``mapping.bias``, ``b4.fc.weight``) maps the same way and has no buffers.
Values arrive as numpy arrays (the caller converts the JAX trees with
``np.asarray``); the result loads with ``Generator.load_state_dict(sd,
strict=True)`` or ``Discriminator.load_state_dict``.  ``resample_filter`` is a
constant, non-persistent buffer on the torch side and is never carried.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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
