"""Seeded weights of a configuration, made on the card in a few large calls.

StyleGAN2's initialisation, as the port's constructors draw it: every
weight and learned constant (and the fixed noise maps) a standard normal,
stored divided by the layer's learning-rate multiplier; biases at their
initial value (1 for the style affines, else 0); the pose projection of D
uniform in ±1/sqrt(fan_in).  The noise strengths, 0 at initialisation, are
set to 0.1, so that synthesis noise reaches the images as it does in a
trained model.  Keys are ``G.<state-dict key>`` and ``D.<state-dict key>``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

NOISE_STRENGTH = 0.1


def _specs(exp: dict):
    """(key, shape, kind, scale) of every state-dict entry of G and D."""
    from benchmark.reference import gmpi
    from benchmark.reference.layers import FullyConnected

    with torch.device("meta"):
        models = {"G": gmpi.Generator(gmpi.generator_cfg(exp)),
                  "D": gmpi.Discriminator(gmpi.discriminator_cfg(exp))}
    out = []
    for tag, model in models.items():
        lr_mult = {name: m.lr_multiplier for name, m in model.named_modules()
                   if isinstance(m, FullyConnected)}
        for key, t in model.state_dict().items():
            owner, _, leaf = key.rpartition(".")
            shape = tuple(t.shape)
            if owner == "mapping" and tag == "D":  # nn.Linear: uniform
                out.append((f"{tag}.{key}", shape, "uniform",
                            1.0 / np.sqrt(exp["train"]["d_cond_pose_dim"])))
            elif leaf.startswith("bias"):
                init = 1.0 if owner.rpartition(".")[2].startswith("affine") else 0.0
                out.append((f"{tag}.{key}", shape, "const", init))
            elif leaf == "noise_strength":
                out.append((f"{tag}.{key}", shape, "const", NOISE_STRENGTH))
            elif leaf == "w_avg":
                out.append((f"{tag}.{key}", shape, "const", 0.0))
            else:  # weights, learned constants, fixed noise maps
                out.append((f"{tag}.{key}", shape, "normal", 1.0 / lr_mult.get(owner, 1.0)))
    return out


def make(exp: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed``: one normal and one uniform draw from a
    generator on ``device``, cut into the leaves."""
    specs = _specs(exp)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(int(np.prod(s)) for _, s, k, _ in specs if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2.0 - 1.0}
    offsets = {"normal": 0, "uniform": 0}
    out = {}
    for key, shape, kind, scale in specs:
        n = int(np.prod(shape))
        if kind == "const":
            out[key] = torch.full(shape, scale, device=device)
            continue
        o = offsets[kind]
        out[key] = pools[kind][o:o + n].reshape(shape) * scale
        offsets[kind] = o + n
    return out


def split(weights: Dict[str, torch.Tensor], tag: str) -> Dict[str, torch.Tensor]:
    """The entries of one model (``"G"`` or ``"D"``), without the tag."""
    return {k[len(tag) + 1:]: v for k, v in weights.items() if k.startswith(tag + ".")}
