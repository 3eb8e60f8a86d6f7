#!/usr/bin/env python
"""Offline checkpoint conversion for ``gmpi_tpu_torch``: released checkpoints
-> one flat ``.npz`` in the reference's state-dict naming.

    python convert_checkpoint_torch.py --src ema.pth --out g.npz
    python convert_checkpoint_torch.py --src stylegan2-ffhq-256.pkl --out g.npz [--which G_ema]
    python convert_checkpoint_torch.py --src network.pkl --out g.npz --reference <reference repo>

Three sources (the flags and the output of ``convert_checkpoint.py``, the JAX
package's CLI):

* a ``.pth`` state dict (the GMPI release's ``generator.pth`` / ``ema.pth``)
  or a training checkpoint that nests one under ``generator``, ``G_ema``,
  ``ema`` or ``state_dict``; read with ``weights_only``;
* a TF-era StyleGAN2 ``.pkl``: unpickled with ``dnnlib`` classes replaced by
  an attribute dict, then mapped by ``gmpi_tpu_torch.models.legacy_tf`` for
  ``--which G_ema|G|D``; no reference code is needed;
* a torch-era ``.pkl`` (source-pickled modules): unpickling needs the
  reference repository's ``torch_utils``/``dnnlib`` on the path, given by
  ``--reference``; without it the CLI raises.

The ``.npz`` loads with ``train_gmpi_torch.py --warm_start`` (G) or
``--warm_start_d`` (D).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Dict, Optional

import numpy as np


def _install_reference(path: str) -> None:
    """Put the reference repository on ``sys.path``, with stand-ins for the
    two packages its model modules import and the unpickling never uses."""
    import functools
    import types

    for mod in ("yacs", "lazy"):
        if mod in sys.modules:
            continue
        m = types.ModuleType(mod)
        if mod == "yacs":
            cfg = types.ModuleType("yacs.config")
            cfg.CfgNode = dict
            m.config = cfg
            sys.modules["yacs.config"] = cfg
        else:
            def lazy(fn):
                a = "_lazy_" + fn.__name__

                @property
                @functools.wraps(fn)
                def wrapper(self):
                    if not hasattr(self, a):
                        setattr(self, a, fn(self))
                    return getattr(self, a)

                return wrapper

            m.lazy = lazy
        sys.modules[mod] = m
    for p in (path, os.path.join(path, "gmpi", "models")):
        if p not in sys.path:
            sys.path.insert(0, p)


class _TFStub(dict):
    """Attribute-access dict standing in for ``dnnlib.tflib.network.Network``
    and ``dnnlib.EasyDict`` (the reference's ``_TFNetworkStub``,
    ``legacy.py:69-71``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


class _TFUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("dnnlib"):
            return _TFStub
        return super().find_class(module, name)


def load_pkl_state_dict(src: str, which: str = "G_ema",
                        reference: Optional[str] = None) -> Dict[str, np.ndarray]:
    """A reference-named state dict of network ``which`` of a StyleGAN2
    ``.pkl``: a TF-era pickle goes through the name and layout table, a
    torch-era one through the reference's unpickling (``reference``)."""
    from gmpi_tpu_torch.models.legacy_tf import (collect_tf_params,
                                                 convert_tf_discriminator_params,
                                                 convert_tf_generator_params)

    try:
        with open(src, "rb") as f:
            data = _TFUnpickler(f).load()
    except (pickle.UnpicklingError, ImportError, AttributeError):
        data = None  # not a TF-era pickle: its classes live outside dnnlib
    if (isinstance(data, tuple) and len(data) == 3
            and all(isinstance(n, _TFStub) for n in data)):
        net = dict(zip(("G", "D", "G_ema"), data))[which]
        res = int(net.static_kwargs.get("resolution", 1024))
        conv = convert_tf_discriminator_params if which == "D" else convert_tf_generator_params
        return conv(collect_tf_params(net), res)
    if reference is None:
        raise RuntimeError(
            f"{src} is not a TF-era StyleGAN2 pickle; a torch-era (source-pickled) pickle "
            "unpickles only with the reference repository's torch_utils and dnnlib on the "
            "path: pass --reference <path to the reference repository>")
    _install_reference(reference)
    with open(src, "rb") as f:
        data = pickle.Unpickler(f).load()
    return {k: v.detach().cpu().numpy() for k, v in data[which].state_dict().items()}


def load_pth_state_dict(src: str) -> Dict[str, np.ndarray]:
    """The tensors of a ``.pth`` state dict, or of the one a training
    checkpoint nests under ``generator``, ``G_ema``, ``ema`` or
    ``state_dict``, as numpy arrays."""
    import torch

    obj = torch.load(src, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{src}: expected a state dict, got {type(obj).__name__}")
    for key in ("generator", "G_ema", "ema", "state_dict"):
        if key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
            for k, v in obj.items() if hasattr(v, "shape")}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help=".pth state dict or StyleGAN2 .pkl")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--reference", default=None,
                    help="reference repository (needed for torch-era .pkl sources only)")
    ap.add_argument("--which", default="G_ema", choices=["G_ema", "G", "D"],
                    help="which network to extract from a .pkl")
    return ap


def main(argv=None) -> Dict[str, np.ndarray]:
    """Convert ``--src`` into ``--out``; returns the state dict written."""
    args = build_parser().parse_args(argv)
    if args.src.endswith(".pkl"):
        sd = load_pkl_state_dict(args.src, args.which, args.reference)
    else:
        sd = load_pth_state_dict(args.src)
    np.savez(args.out, **sd)
    print(f"wrote {len(sd)} tensors to {args.out}")
    return sd


if __name__ == "__main__":
    main()
