"""TF-era StyleGAN2 checkpoints in ``gmpi_tpu_torch``: the port's name and
layout table (``models/legacy_tf.py``) against the JAX package's, its CLI
``convert_checkpoint_torch.py`` against ``convert_checkpoint.py``, and a warm
start from the converted file.

The pickles are synthetic (``gmpi_tpu_torch.tools.tf_pickle``: the
releases' variable names and shapes at a narrow width, seeded values); the
mapping must be bitwise the JAX package's and the two CLIs' ``.npz`` files
equal array for array.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gmpi_tpu.models import legacy_tf as jax_legacy
from gmpi_tpu_torch.models import legacy_tf
from gmpi_tpu_torch.tools.tf_pickle import (tf_discriminator_vars, tf_generator_vars,
                                            write_tf_pickle)

REPO = Path(__file__).resolve().parents[1]
RES = 32
NARROW = dict(resolution=RES, channel_base=256, channel_max=32)


def narrow_g(seed=0):
    return tf_generator_vars(z_dim=16, w_dim=16, mapping_layers=2, seed=seed, **NARROW)


def narrow_d(seed=1):
    return tf_discriminator_vars(seed=seed, **NARROW)


def assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("which", ["G", "G with lod aliases and labels", "D",
                                   "D with lod aliases"])
def test_mapping_is_bitwise_the_jax_packages(which):
    if which.startswith("G"):
        tf, conv, conv_j = narrow_g(), legacy_tf.convert_tf_generator_params, \
            jax_legacy.convert_tf_generator_params
        if "lod" in which:  # a progressive-growing pickle's ToRGB_lod names, a label embed
            for lod, r in ((0, RES), (1, RES // 2)):
                for leaf in ("weight", "bias", "mod_weight", "mod_bias"):
                    tf[f"ToRGB_lod{lod}/{leaf}"] = tf.pop(f"synthesis/{r}x{r}/ToRGB/{leaf}")
            tf["mapping/LabelEmbed/weight"] = np.ones((3, 16), np.float32)
            tf["mapping/LabelEmbed/bias"] = np.zeros(16, np.float32)
    else:
        tf, conv, conv_j = narrow_d(), legacy_tf.convert_tf_discriminator_params, \
            jax_legacy.convert_tf_discriminator_params
        if "lod" in which:
            for leaf in ("weight", "bias"):
                tf[f"FromRGB_lod0/{leaf}"] = tf.pop(f"{RES}x{RES}/FromRGB/{leaf}")
    sd = conv(tf, RES)
    assert_same_arrays(sd, conv_j(tf, RES))
    if which == "G":
        # the table's transforms: flip + HWIO -> OIHW on the transposed conv
        # only, mod_bias + 1, noise from synthesis/noise{2 log2(r) - 4}
        w = tf["synthesis/8x8/Conv0_up/weight"]
        np.testing.assert_array_equal(sd["synthesis.b8.conv0.weight"],
                                      w[::-1, ::-1].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd["synthesis.b8.conv1.weight"],
                                      tf["synthesis/8x8/Conv1/weight"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd["synthesis.b16.conv1.affine.bias"],
                                      tf["synthesis/16x16/Conv1/mod_bias"] + 1)
        np.testing.assert_array_equal(sd["synthesis.b16.conv1.noise_const"],
                                      tf["synthesis/noise4"][0, 0])
    with pytest.raises(KeyError, match="missing"):
        conv({k: v for k, v in tf.items() if "Conv0" not in k}, RES)


def test_collect_tf_params_walks_components(tmp_path):
    g = narrow_g()
    path = tmp_path / "net.pkl"
    write_tf_pickle(str(path), g, narrow_d(), RES)
    from convert_checkpoint_torch import _TFUnpickler

    with open(path, "rb") as f:
        tf_g, _, tf_gs = _TFUnpickler(f).load()
    assert tf_gs.static_kwargs["resolution"] == RES
    got = legacy_tf.collect_tf_params(tf_g)
    assert_same_arrays(got, jax_legacy.collect_tf_params(tf_g))
    assert_same_arrays(got, g)


def _run(script, *args):
    res = subprocess.run([sys.executable, str(REPO / script), *args], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]


@pytest.mark.parametrize("source", ["pkl G_ema", "pkl D", "pth nested"])
def test_cli_writes_what_the_jax_cli_writes(tmp_path, source):
    if source.startswith("pkl"):
        src = tmp_path / "net.pkl"
        write_tf_pickle(str(src), narrow_g(), narrow_d(), RES)
        extra = ["--which", source.split()[1]]
    else:
        src = tmp_path / "ckpt.pth"
        sd = {k: torch.from_numpy(v.copy()) for k, v in
              legacy_tf.convert_tf_generator_params(narrow_g(), RES).items()}
        torch.save({"generator": sd, "step": 7}, src)
        extra = []
    outs = {}
    for script in ("convert_checkpoint_torch.py", "convert_checkpoint.py"):
        outs[script] = tmp_path / f"{script}.npz"
        _run(script, "--src", str(src), "--out", str(outs[script]), *extra)
    with np.load(outs["convert_checkpoint_torch.py"]) as a, \
            np.load(outs["convert_checkpoint.py"]) as b:
        mine, theirs = {k: a[k] for k in a.files}, {k: b[k] for k in b.files}
    assert_same_arrays(mine, theirs)
    assert len(mine) > 20


def test_torch_era_pickle_needs_reference(tmp_path):
    """A pickle whose classes live outside ``dnnlib`` is not TF-era; without
    ``--reference`` the CLI says what it needs."""
    import convert_checkpoint_torch as cli

    src = tmp_path / "torch_era.pkl"
    with open(src, "wb") as f:
        f.write(pickle.dumps({"G_ema": None}).replace(b"builtins", b"torch_utils"))
    with pytest.raises(RuntimeError, match="--reference"):
        cli.main(["--src", str(src), "--out", str(tmp_path / "x.npz")])


def test_warm_start_from_a_converted_pickle(tmp_path):
    """``G_ema`` of a TF-era pickle -> ``.npz`` -> the port's MPI generator:
    the mapping, the trunk, ``torgb`` and the noise buffers equal the
    table's output bitwise; the MPI heads keep their initial values."""
    import convert_checkpoint_torch as cli
    from gmpi_tpu_torch.models.converter import convert_generator_checkpoint
    from gmpi_tpu_torch.models.generator import (Generator, GeneratorCfg,
                                                 SynthesisNetworkCfg)

    src, out = tmp_path / "net.pkl", tmp_path / "g.npz"
    tf = narrow_g()
    write_tf_pickle(str(src), tf, narrow_d(), RES)
    cli.main(["--src", str(src), "--out", str(out), "--which", "G_ema"])
    with np.load(out) as data:
        sd = {k: data[k] for k in data.files}
    cfg = GeneratorCfg(z_dim=16, w_dim=16, img_resolution=RES, mapping_num_layers=2,
                       synthesis=SynthesisNetworkCfg(w_dim=16, img_resolution=RES,
                                                     channel_base=256, channel_max=32))
    params, buffers = convert_generator_checkpoint(
        sd, cfg, warm_start=True, generator=torch.Generator().manual_seed(5))
    init = Generator(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
    g = Generator(cfg)
    g.load_state_dict({**params, **buffers}, strict=True)
    table = legacy_tf.convert_tf_generator_params(tf, RES)
    n_file = n_head = 0
    for k, v in g.state_dict().items():
        if k in table:
            n_file += 1
            assert torch.equal(v, torch.from_numpy(np.array(table[k]))), k
        else:  # the MPI heads: toalpha and the depth embedding
            n_head += 1
            assert k.split(".")[2] in ("toalpha", "pos_enc_embed"), k
            assert torch.equal(v, init[k]), k
    assert n_file == len(table) and n_head > 0
    with torch.no_grad():
        from gmpi_tpu_torch.core.geometry import build_plane_geometry, multi_res_xyz

        geom = build_plane_geometry(n_planes=4, min_d=0.95, max_d=1.12, fov_deg=12.6,
                                    sphere_center_z=1.0, sphere_r=1.0, yaw_mean=0.0,
                                    yaw_std=0.289, pitch_mean=0.0, pitch_std=0.127,
                                    device="cpu")
        mpi = g(torch.randn(2, 16), None, multi_res_xyz(geom, RES), 4)
    assert mpi.shape == (2, 4, 4, RES, RES) and torch.isfinite(mpi).all()
