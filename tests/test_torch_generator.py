"""Port parity: the MPI generator of ``gmpi_tpu_torch`` against ``gmpi_tpu``.

A narrow JAX generator at resolution 64 (fp32: no bf16 blocks at <= 128) is
initialized by JAX, its biases, noise strengths and ``w_avg`` are replaced by
numpy draws so every parameter matters, and the trees are carried into the
port with ``params_from_jax``.  The same numpy z must give the same MPI.
Tolerance: 1e-4 x max|ref| (two fp32 conv stacks that differ only in
summation order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.config import get_config as jax_get_config
from gmpi_tpu.eval.generate import generate_mpi as jax_generate_mpi
from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.models.converter import params_from_jax
from gmpi_tpu_torch.models.generator import Generator

N_PLANES = 4
REL_TOL = 1e-4


def small_cfg(get):
    """FFHQ preset cut to resolution 64, narrow channels, 4 eval planes."""
    cfg = get("FFHQ256")
    return dataclasses.replace(
        cfg, resolution=64, eval_n_planes=N_PLANES,
        planes=dataclasses.replace(cfg.planes, n_planes=N_PLANES),
        hparams=dataclasses.replace(cfg.hparams, img_size=64, tex_size=64),
        train=dataclasses.replace(cfg.train, z_dim=32, w_dim=32),
        model=dataclasses.replace(cfg.model, channel_base=1024, channel_max=32))


def jax_trees_with_random_leaves(gen_cfg, seed=0):
    """JAX init, then numpy draws for the leaves init leaves constant."""
    params, buffers = jax.jit(gen_cfg.init)(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name.startswith("bias") or name in ("noise_strength", "w_avg"):
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, params)
    buffers = jax.tree_util.tree_map_with_path(perturb, buffers)
    return params, buffers


def port_generator(gen_cfg_t, params, buffers):
    g = Generator(gen_cfg_t)
    g.load_state_dict(params_from_jax(params, buffers), strict=True)
    return g.eval()


@pytest.fixture(scope="module")
def jax_trees():
    return jax_trees_with_random_leaves(small_cfg(jax_get_config).generator_cfg())


@pytest.mark.parametrize("chunk,psi", [(-1, 1.0), (2, 0.7)])
def test_generate_mpi_matches_jax(jax_trees, chunk, psi):
    cfg_j, cfg_t = small_cfg(jax_get_config), small_cfg(get_config)
    gen_j = cfg_j.generator_cfg()
    params, buffers = jax_trees
    gen_t = port_generator(cfg_t.generator_cfg(), params, buffers)

    geom_j = cfg_j.plane_geometry()
    xyz_j = cfg_j.multi_res_xyz(geom_j)
    geom_t = cfg_t.plane_geometry(device="cpu")
    xyz_t = cfg_t.multi_res_xyz(geom_t)

    z = np.random.default_rng(3).standard_normal((2, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, b, z: jax_generate_mpi(
        gen_j, p, b, z, xyz_j, N_PLANES, chunk_n_planes=chunk, truncation_psi=psi,
        noise_mode="const"))(params, buffers, jnp.asarray(z)))
    with torch.no_grad():
        out = generate_mpi(gen_t, torch.from_numpy(z), xyz_t, N_PLANES,
                           chunk_n_planes=chunk, truncation_psi=psi, noise_mode="const").numpy()
    assert out.shape == ref.shape == (2, N_PLANES, 4, 64, 64)
    err = np.max(np.abs(out - ref))
    assert err <= REL_TOL * np.max(np.abs(ref)), err


def test_state_dict_keys_match_jax_tree(jax_trees):
    """Every JAX leaf has a torch key of the same shape and vice versa."""
    sd = params_from_jax(*jax_trees)
    own = Generator(small_cfg(get_config).generator_cfg()).state_dict()
    assert sorted(sd) == sorted(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)


def test_unported_cond_modes_raise():
    cfg_t = small_cfg(get_config)
    for model in (dataclasses.replace(cfg_t.model, cond_mode="cat_xyz"),
                  dataclasses.replace(cfg_t.model, embed_func="mlp")):
        with pytest.raises(NotImplementedError):
            Generator(dataclasses.replace(cfg_t, model=model).generator_cfg())


@pytest.mark.parametrize("up,down,activation", [(1, 1, "lrelu"), (2, 1, "linear"),
                                                (1, 2, "relu")])
def test_conv2d_layer_matches_jax(up, down, activation):
    """Conv2dLayer (weight gain, FIR resampling, bias_act with clamp): JAX
    params carried across; fp32, 1e-5 x max|ref|."""
    from gmpi_tpu.models.layers import Conv2d as JaxConv2d
    from gmpi_tpu_torch.models.layers import Conv2d

    layer_j = JaxConv2d(4, 6, 3, activation=activation, up=up, down=down, conv_clamp=1.5)
    p = jax.tree_util.tree_map(np.asarray, layer_j.init(jax.random.key(2)))
    p["bias"] = np.random.default_rng(1).standard_normal(6).astype(np.float32)
    x = np.random.default_rng(0).standard_normal((2, 4, 8, 8)).astype(np.float32)
    ref = np.asarray(layer_j.apply(p, jnp.asarray(x), gain=0.8))
    layer_t = Conv2d(4, 6, 3, activation=activation, up=up, down=down, conv_clamp=1.5)
    layer_t.load_state_dict(params_from_jax(p), strict=True)
    with torch.no_grad():
        out = layer_t(torch.from_numpy(x), gain=0.8).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
