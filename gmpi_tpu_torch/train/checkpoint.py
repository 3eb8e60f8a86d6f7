"""Checkpoint save and load of the training state (port of
``gmpi_tpu/train/checkpoint.py``).

The same layout as the JAX package: a ``step_%08d/`` directory per saved
step, a ``latest`` file naming the newest, the oldest pruned past
``keep_last``.  A step directory holds one ``torch.save`` of G's and D's
``state_dict``, both optimizers' ``state_dict``, both EMAs and ``step``; it
is written under a temporary name and renamed into place, so a run cut
mid-save leaves the previous checkpoint as ``latest``.  Resume restores all
of it in place into a state from ``init_train_state`` (the reference saves
the same items and cannot resume, ``gmpi/train.py:79-80, 427-437``).

:func:`export_torch_style` / :func:`load_torch_style` write and read a flat
``.npz`` in the reference's state-dict naming, the same file the JAX package
writes, so weights flow both ways between the packages.
:func:`load_generator` reads G alone from a checkpoint, for the eval and
render CLIs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from gmpi_tpu_torch.models.converter import Tree, convert_state_dict, tree_to_state_dict
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.train.step import TrainState
from gmpi_tpu_torch.utils.device import resolve_device

STATE_FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def state_payload(state: TrainState) -> dict:
    """What a checkpoint holds (tensors on their devices, not copied)."""
    return {"G": state.G.state_dict(), "D": state.D.state_dict(),
            "opt_g": state.opt_g.state_dict(), "opt_d": state.opt_d.state_dict(),
            "ema": state.ema, "ema2": state.ema2, "step": int(state.step)}


def save_checkpoint(base_dir: str, state: TrainState, keep_last: int = 3) -> str:
    """Save ``state`` under ``base_dir/step_%08d``, point ``latest`` at it and
    prune all but the newest ``keep_last``; returns the directory."""
    path = os.path.abspath(_ckpt_dir(base_dir, int(state.step)))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state_payload(state), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    latest_tmp = os.path.join(base_dir, "latest.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(path))
    os.replace(latest_tmp, os.path.join(base_dir, "latest"))
    kept = sorted(d for d in os.listdir(base_dir) if d.startswith("step_"))
    for d in kept[:-keep_last] if keep_last > 0 else ():
        shutil.rmtree(os.path.join(base_dir, d), ignore_errors=True)
    return path


def checkpoint_file(base_dir: str, step: Optional[int] = None) -> str:
    """The state file of ``step``, or of the one ``latest`` names."""
    if step is None:
        with open(os.path.join(base_dir, "latest")) as f:
            name = f.read().strip()
        return os.path.join(base_dir, name, STATE_FILE)
    return os.path.join(_ckpt_dir(base_dir, step), STATE_FILE)


def load_checkpoint(base_dir: str, state: TrainState, step: Optional[int] = None
                    ) -> TrainState:
    """Restore a checkpoint into ``state`` (from ``init_train_state`` with the
    same config) in place and return it.  Tensors load straight onto the
    device of G's parameters (``weights_only``); Adam's step counts go back
    to the host, where a non-capturable Adam keeps them."""
    device = next(state.G.parameters()).device
    ckpt = torch.load(checkpoint_file(base_dir, step), map_location=device, weights_only=True)
    state.G.load_state_dict(ckpt["G"], strict=True)
    state.D.load_state_dict(ckpt["D"], strict=True)
    for opt, key in ((state.opt_g, "opt_g"), (state.opt_d, "opt_d")):
        for s in ckpt[key]["state"].values():
            if isinstance(s.get("step"), torch.Tensor):
                s["step"] = s["step"].cpu()
        opt.load_state_dict(ckpt[key])
    with torch.no_grad():
        for name in ("ema", "ema2"):
            ema = getattr(state, name)
            if set(ema) != set(ckpt[name]):
                raise KeyError(f"{name}: the checkpoint's keys differ from the state's")
            for k, v in ckpt[name].items():
                ema[k].copy_(v)
    state.step = int(ckpt["step"])
    return state


def load_generator(base_dir: str, cfg, use_ema: bool = True, step: Optional[int] = None,
                   device="cuda") -> Generator:
    """G of a checkpoint (the one ``latest`` names, or ``step``) on ``device``
    in eval mode: G's saved state, with the EMA parameters in place of G's
    own when ``use_ema`` (G's buffers, ``w_avg`` and the noise constants,
    either way, as the loop's snapshots pair them)."""
    dev = resolve_device(device)
    ckpt = torch.load(checkpoint_file(base_dir, step), map_location="cpu", weights_only=True)
    G = Generator(cfg.generator_cfg())
    sd = dict(ckpt["G"])
    if use_ema:
        params = dict(G.named_parameters())
        if set(ckpt["ema"]) != set(params):
            raise KeyError("ema: the checkpoint's keys differ from the generator's parameters")
        sd.update(ckpt["ema"])
    G.load_state_dict(sd, strict=True)
    return G.to(dev).eval()


def save_config_snapshot(out_dir: str, cfg) -> None:
    """Config snapshot for exact eval reproduction (``gmpi/train.py:52-55``)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def export_torch_style(path: str, params: Mapping, buffers: Optional[Mapping] = None) -> None:
    """Write weights as a flat ``.npz`` in the reference's state-dict naming
    (loadable by the converters of both packages)."""
    np.savez(path, **tree_to_state_dict(params, buffers))


def load_torch_style(path: str) -> Tuple[Tree, Tree]:
    """Inverse of :func:`export_torch_style` -> ``(params, buffers)`` flat
    dicts of float32 CPU tensors."""
    with np.load(path) as data:
        sd = {k: data[k] for k in data.files}
    return convert_state_dict(sd)
