"""Synthetic TF-era StyleGAN2 pickles: the variable names and shapes of
NVIDIA's TensorFlow releases, filled with seeded random values.

No real StyleGAN2 pickle ships with this repository; tests and
``chip_smoke.py`` write one of these and run ``convert_checkpoint_torch.py``
on it.  :func:`tf_generator_vars` and :func:`tf_discriminator_vars` build the
``{tf_name: array}`` dicts that ``models/legacy_tf.py`` maps (skip-generator,
resnet-discriminator, channels ``min(channel_base // res, channel_max)``:
NVIDIA's FFHQ 256^2 ``paper256`` release is ``channel_base=16384``,
``channel_max=512``, 8 mapping layers of 512); :func:`write_tf_pickle`
pickles them as ``(G, D, Gs)`` of ``dnnlib.tflib.network.Network`` objects,
as the releases are, without TensorFlow or ``dnnlib``.
"""

from __future__ import annotations

import pickle
import sys
import types
from typing import Dict

import numpy as np


def _channels(channel_base: int, channel_max: int):
    return lambda res: min(channel_base // res, channel_max)


def tf_generator_vars(resolution: int = 256, channel_base: int = 16384, channel_max: int = 512,
                      z_dim: int = 512, w_dim: int = 512, mapping_layers: int = 8,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """The variables of a TF StyleGAN2 generator (``G`` / ``Gs``): the
    mapping's ``Dense{i}``, ``dlatent_avg``, and per resolution the convs
    (``Const``/``Conv`` at 4^2, ``Conv0_up``/``Conv1`` above), ``ToRGB`` and
    the noise inputs ``noise{k}``."""
    rng = np.random.default_rng(seed)
    ch = _channels(channel_base, channel_max)

    def arr(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    tf = {"dlatent_avg": arr(w_dim)}
    for i in range(mapping_layers):
        tf[f"mapping/Dense{i}/weight"] = arr(z_dim if i == 0 else w_dim, w_dim)
        tf[f"mapping/Dense{i}/bias"] = arr(w_dim)

    def modulated(pre, cin, cout, k):
        tf[f"{pre}/weight"] = arr(k, k, cin, cout)
        tf[f"{pre}/bias"] = arr(cout)
        tf[f"{pre}/mod_weight"] = arr(w_dim, cin)
        tf[f"{pre}/mod_bias"] = arr(cin)

    c4 = ch(4)
    tf["synthesis/4x4/Const/const"] = arr(1, c4, 4, 4)
    modulated("synthesis/4x4/Conv", c4, c4, 3)
    tf["synthesis/4x4/Conv/noise_strength"] = arr()
    tf["synthesis/noise0"] = arr(1, 1, 4, 4)
    modulated("synthesis/4x4/ToRGB", c4, 3, 1)
    r = 8
    while r <= resolution:
        lg = int(np.log2(r))
        for conv, cin, k in (("Conv0_up", ch(r // 2), 2 * lg - 5), ("Conv1", ch(r), 2 * lg - 4)):
            modulated(f"synthesis/{r}x{r}/{conv}", cin, ch(r), 3)
            tf[f"synthesis/{r}x{r}/{conv}/noise_strength"] = arr()
            tf[f"synthesis/noise{k}"] = arr(1, 1, r, r)
        modulated(f"synthesis/{r}x{r}/ToRGB", ch(r), 3, 1)
        r *= 2
    return tf


def tf_discriminator_vars(resolution: int = 256, channel_base: int = 16384,
                          channel_max: int = 512, seed: int = 1) -> Dict[str, np.ndarray]:
    """The variables of a TF StyleGAN2 resnet discriminator (unconditional):
    ``FromRGB`` at the top resolution, ``Conv0``/``Conv1_down``/``Skip`` per
    resolution, the 4^2 epilogue and ``Output``."""
    rng = np.random.default_rng(seed)
    ch = _channels(channel_base, channel_max)

    def arr(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    top = f"{resolution}x{resolution}"
    tf = {f"{top}/FromRGB/weight": arr(1, 1, 3, ch(resolution)),
          f"{top}/FromRGB/bias": arr(ch(resolution))}
    r = resolution
    while r >= 8:
        tf[f"{r}x{r}/Conv0/weight"] = arr(3, 3, ch(r), ch(r))
        tf[f"{r}x{r}/Conv0/bias"] = arr(ch(r))
        tf[f"{r}x{r}/Conv1_down/weight"] = arr(3, 3, ch(r), ch(r // 2))
        tf[f"{r}x{r}/Conv1_down/bias"] = arr(ch(r // 2))
        tf[f"{r}x{r}/Skip/weight"] = arr(1, 1, ch(r), ch(r // 2))
        r //= 2
    c4 = ch(4)
    tf["4x4/Conv/weight"] = arr(3, 3, c4 + 1, c4)
    tf["4x4/Conv/bias"] = arr(c4)
    tf["4x4/Dense0/weight"] = arr(c4 * 16, c4)
    tf["4x4/Dense0/bias"] = arr(c4)
    tf["Output/weight"] = arr(c4, 1)
    tf["Output/bias"] = arr(1)
    return tf


def write_tf_pickle(path: str, g_vars: Dict[str, np.ndarray], d_vars: Dict[str, np.ndarray],
                    resolution: int) -> None:
    """Pickle ``(G, D, Gs)`` as a TF-era release does: ``Network`` objects
    of module ``dnnlib.tflib.network`` whose state holds ``variables``
    (``(name, value)`` pairs), ``components`` and ``static_kwargs``; G's
    mapping and synthesis variables sit in its two components, and ``Gs`` is
    the same network as ``G``.  Stand-in ``dnnlib`` modules exist only while
    pickling."""

    class Network(dict):
        pass

    Network.__module__, Network.__qualname__ = "dnnlib.tflib.network", "Network"

    def net(variables, components=None):
        n = Network()
        n.update(variables=list(variables.items()), components=components or {},
                 static_kwargs={"resolution": resolution})
        return n

    def part(prefix):
        return {k[len(prefix):]: v for k, v in g_vars.items() if k.startswith(prefix)}

    g = net({k: v for k, v in g_vars.items() if "/" not in k},
            {"mapping": net(part("mapping/")), "synthesis": net(part("synthesis/"))})
    d = net(d_vars)
    stand_ins = {"dnnlib": types.ModuleType("dnnlib"),
                 "dnnlib.tflib": types.ModuleType("dnnlib.tflib"),
                 "dnnlib.tflib.network": types.ModuleType("dnnlib.tflib.network")}
    stand_ins["dnnlib.tflib.network"].Network = Network
    saved = {name: sys.modules.get(name) for name in stand_ins}
    sys.modules.update(stand_ins)
    try:
        with open(path, "wb") as f:
            pickle.dump((g, d, g), f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod

