"""TF-era StyleGAN2 checkpoint conversion, a pure name and layout mapping
(port of ``gmpi_tpu/models/legacy_tf.py``; numpy only).

The reference rebuilds torch modules from TensorFlow pickles via a regex
mapping table (``gmpi/models/legacy.py:115-326``).  Unpickling a TF pickle
pulls in ``dnnlib.tflib`` class stubs, but once the variables are extracted
as ``{tf_name: np.ndarray}``, the conversion itself is a deterministic
rename + transpose/flip table.  This module re-implements exactly that
table with no reference-code imports, producing the reference *torch*
naming that ``models/converter.py`` consumes.

Use ``collect_tf_params`` on the unpickled TF network tuple (components
carry ``.variables`` lists) or pass any ``{name: array}`` mapping.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np


def collect_tf_params(tf_net) -> Dict[str, np.ndarray]:
    """Flatten a TF network object tree (``_collect_tf_params``,
    ``legacy.py:68-83``): walks ``.components`` and prefixes ``.variables``."""
    params: Dict[str, np.ndarray] = {}

    def visit(prefix, obj):
        for name, value in getattr(obj, "variables", []):
            params[prefix + name] = np.asarray(value)
        for comp_name, comp in getattr(obj, "components", {}).items():
            visit(prefix + comp_name + "/", comp)

    visit("", tf_net)
    return params


def _t(v):
    return np.asarray(v).transpose()


def _conv_w(v, flip=False):
    v = np.asarray(v)
    if flip:
        v = v[::-1, ::-1]
    return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW


def convert_tf_generator_params(
    tf_params: Mapping[str, np.ndarray], img_resolution: int
) -> Dict[str, np.ndarray]:
    """TF variable dict -> torch-style G state dict
    (``legacy.py:163-205``'s table, reproduced without building modules)."""
    tf = dict(tf_params)
    # ToRGB_lod aliasing (progressive-growing pickles), legacy.py:166-171
    for name, value in list(tf.items()):
        m = re.fullmatch(r"ToRGB_lod(\d+)/(.*)", name)
        if m:
            r = img_resolution // (2 ** int(m.group(1)))
            tf[f"{r}x{r}/ToRGB/{m.group(2)}"] = value

    out: Dict[str, np.ndarray] = {}

    def put(dst, src, fn=np.asarray, optional=False):
        if src in tf:
            out[dst] = np.asarray(fn(tf[src]))
        elif not optional:
            raise KeyError(f"TF checkpoint missing {src!r} (wanted for {dst})")

    put("mapping.w_avg", "dlatent_avg")
    put("mapping.embed.weight", "mapping/LabelEmbed/weight", _t, optional=True)
    put("mapping.embed.bias", "mapping/LabelEmbed/bias", optional=True)
    for i in range(16):
        if f"mapping/Dense{i}/weight" not in tf:
            break
        put(f"mapping.fc{i}.weight", f"mapping/Dense{i}/weight", _t)
        put(f"mapping.fc{i}.bias", f"mapping/Dense{i}/bias")

    put("synthesis.b4.const", "synthesis/4x4/Const/const", lambda v: np.asarray(v)[0])
    put("synthesis.b4.conv1.weight", "synthesis/4x4/Conv/weight", _conv_w)
    put("synthesis.b4.conv1.bias", "synthesis/4x4/Conv/bias")
    put("synthesis.b4.conv1.noise_const", "synthesis/noise0",
        lambda v: np.asarray(v)[0, 0], optional=True)
    put("synthesis.b4.conv1.noise_strength", "synthesis/4x4/Conv/noise_strength")
    put("synthesis.b4.conv1.affine.weight", "synthesis/4x4/Conv/mod_weight", _t)
    put("synthesis.b4.conv1.affine.bias", "synthesis/4x4/Conv/mod_bias",
        lambda v: np.asarray(v) + 1)

    res = 8
    while res <= img_resolution:
        r, lg = res, int(np.log2(res))
        pre = f"synthesis/{r}x{r}"
        dst = f"synthesis.b{r}"
        put(f"{dst}.conv0.weight", f"{pre}/Conv0_up/weight",
            lambda v: _conv_w(v, flip=True))
        put(f"{dst}.conv0.bias", f"{pre}/Conv0_up/bias")
        put(f"{dst}.conv0.noise_const", f"synthesis/noise{2 * lg - 5}",
            lambda v: np.asarray(v)[0, 0], optional=True)
        put(f"{dst}.conv0.noise_strength", f"{pre}/Conv0_up/noise_strength")
        put(f"{dst}.conv0.affine.weight", f"{pre}/Conv0_up/mod_weight", _t)
        put(f"{dst}.conv0.affine.bias", f"{pre}/Conv0_up/mod_bias",
            lambda v: np.asarray(v) + 1)
        put(f"{dst}.conv1.weight", f"{pre}/Conv1/weight", _conv_w)
        put(f"{dst}.conv1.bias", f"{pre}/Conv1/bias")
        put(f"{dst}.conv1.noise_const", f"synthesis/noise{2 * lg - 4}",
            lambda v: np.asarray(v)[0, 0], optional=True)
        put(f"{dst}.conv1.noise_strength", f"{pre}/Conv1/noise_strength")
        put(f"{dst}.conv1.affine.weight", f"{pre}/Conv1/mod_weight", _t)
        put(f"{dst}.conv1.affine.bias", f"{pre}/Conv1/mod_bias",
            lambda v: np.asarray(v) + 1)
        put(f"{dst}.skip.weight", f"{pre}/Skip/weight",
            lambda v: _conv_w(v, flip=True), optional=True)
        res *= 2
    # ToRGB at every resolution that has one (skip architecture: all)
    res = 4
    while res <= img_resolution:
        pre = f"synthesis/{res}x{res}"
        dst = f"synthesis.b{res}"
        put(f"{dst}.torgb.weight", f"{pre}/ToRGB/weight", _conv_w, optional=True)
        put(f"{dst}.torgb.bias", f"{pre}/ToRGB/bias", optional=True)
        put(f"{dst}.torgb.affine.weight", f"{pre}/ToRGB/mod_weight", _t,
            optional=True)
        put(f"{dst}.torgb.affine.bias", f"{pre}/ToRGB/mod_bias",
            lambda v: np.asarray(v) + 1, optional=True)
        res *= 2
    return out


def convert_tf_discriminator_params(
    tf_params: Mapping[str, np.ndarray], img_resolution: int
) -> Dict[str, np.ndarray]:
    """TF variable dict -> torch-style D state dict (``legacy.py:274-292``)."""
    tf = dict(tf_params)
    for name, value in list(tf.items()):
        m = re.fullmatch(r"FromRGB_lod(\d+)/(.*)", name)
        if m:
            r = img_resolution // (2 ** int(m.group(1)))
            tf[f"{r}x{r}/FromRGB/{m.group(2)}"] = value

    out: Dict[str, np.ndarray] = {}

    def put(dst, src, fn=np.asarray, optional=False):
        if src in tf:
            out[dst] = np.asarray(fn(tf[src]))
        elif not optional:
            raise KeyError(f"TF checkpoint missing {src!r} (wanted for {dst})")

    res = img_resolution
    while res >= 8:
        pre = f"{res}x{res}"
        dst = f"b{res}"
        put(f"{dst}.fromrgb.weight", f"{pre}/FromRGB/weight", _conv_w,
            optional=res != img_resolution)
        put(f"{dst}.fromrgb.bias", f"{pre}/FromRGB/bias",
            optional=res != img_resolution)
        put(f"{dst}.conv0.weight", f"{pre}/Conv0/weight", _conv_w)
        put(f"{dst}.conv0.bias", f"{pre}/Conv0/bias")
        put(f"{dst}.conv1.weight", f"{pre}/Conv1_down/weight", _conv_w)
        put(f"{dst}.conv1.bias", f"{pre}/Conv1_down/bias")
        put(f"{dst}.skip.weight", f"{pre}/Skip/weight", _conv_w, optional=True)
        res //= 2
    put("mapping.embed.weight", "LabelEmbed/weight", _t, optional=True)
    put("mapping.embed.bias", "LabelEmbed/bias", optional=True)
    for i in range(16):
        if f"Mapping{i}/weight" not in tf:
            break
        put(f"mapping.fc{i}.weight", f"Mapping{i}/weight", _t)
        put(f"mapping.fc{i}.bias", f"Mapping{i}/bias")
    put("b4.conv.weight", "4x4/Conv/weight", _conv_w)
    put("b4.conv.bias", "4x4/Conv/bias")
    put("b4.fc.weight", "4x4/Dense0/weight", _t)
    put("b4.fc.bias", "4x4/Dense0/bias")
    put("b4.out.weight", "Output/weight", _t)
    put("b4.out.bias", "Output/bias")
    return out
