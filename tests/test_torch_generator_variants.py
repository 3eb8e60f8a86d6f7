"""Port parity: every generator variant of ``gmpi_tpu_torch`` against ``gmpi_tpu``.

Each case builds the same narrow generator (resolution 16, fp32, 2 mapping
layers) in both packages: JAX initializes it, biases, noise strengths,
``w_avg`` and the ``learnable_param`` sentinel are replaced by numpy draws
so that every parameter matters, and the trees are carried into the port
with ``params_from_jax``.  The same numpy z (and label c), on the same
numpy conditioning grids, must give the same MPI within 1e-4 x max|ref|
(fp32 conv stacks that differ only in summation order), and the port's
state-dict keys must be the JAX tree's paths, shape for shape.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core import geometry as jax_geom
from gmpi_tpu.models import generator as jax_gen
from gmpi_tpu_torch.core import geometry as geom
from gmpi_tpu_torch.models import generator as gen
from gmpi_tpu_torch.models.converter import params_from_jax

RES, ZW = 16, 16
REL_TOL = 1e-4

CASES = {  # name: (synthesis fields, generator fields, eval planes)
    "add_z/mlp": (dict(cond_mode="add_z", embed_func="mlp"), {}, 4),
    "normalize_add_z/conv_lrelu": (dict(cond_mode="normalize_add_z", embed_func="conv_lrelu"),
                                   {}, 4),
    "normalize_add_xyz/modulated_lrelu": (dict(cond_mode="normalize_add_xyz",
                                               embed_func="modulated_lrelu",
                                               pos_enc_multires=1), {}, 4),
    "add_xyz/conv_relu": (dict(cond_mode="add_xyz", embed_func="conv_relu"), {}, 4),
    "cat_xyz/mlp/torgba": (dict(cond_mode="cat_xyz", embed_func="mlp", pos_enc_multires=1,
                                only_alpha=False, sep_background=False), {}, 4),
    "normalize_add_z/modulated_lrelu/torgba": (dict(only_alpha=False, sep_background=False),
                                               {}, 4),
    "cond_z/mlp": (dict(cond_mode="cond_z", embed_func="mlp"), {}, 4),
    "cond_xyz/conv_lrelu": (dict(cond_mode="cond_xyz", embed_func="conv_lrelu",
                                 pos_enc_multires=1), {}, 4),
    "learnable_param/6->4": (dict(embed_func="learnable_param", n_planes_train=6), {}, 4),
    "learnable_param/4->6": (dict(embed_func="learnable_param", n_planes_train=4), {}, 6),
    "c_dim=5": ({}, dict(c_dim=5), 4),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(module, syn_kw, gen_kw):
    syn = module.SynthesisNetworkCfg(w_dim=ZW, img_resolution=RES, channel_base=256,
                                     channel_max=32, conv_clamp=256.0,
                                     gen_alpha_largest_res=RES, **syn_kw)
    return module.GeneratorCfg(z_dim=ZW, w_dim=ZW, img_resolution=RES, synthesis=syn,
                               mapping_num_layers=2, **gen_kw)


def jax_trees(cfg_j, seed=0):
    params, buffers = cfg_j.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if (name.startswith("bias") or name in ("noise_strength", "w_avg")
                or name.endswith("_left_append")):
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return (jax.tree_util.tree_map_with_path(perturb, params),
            jax.tree_util.tree_map_with_path(perturb, buffers))


def plane_inputs(n_planes):
    """Conditioning grids of the JAX geometry, as numpy."""
    g = jax_geom.build_plane_geometry(
        n_planes=n_planes, min_d=0.95, max_d=1.12, fov_deg=12.6, sphere_center_z=1.0,
        sphere_r=1.0, yaw_mean=0.0, yaw_std=0.289, pitch_mean=0.0, pitch_std=0.127)
    return {r: np.asarray(v) for r, v in jax_geom.multi_res_xyz(g, RES).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_variant_matches_jax(case):
    syn_kw, gen_kw, n_planes = CASES[case]
    cfg_j, cfg_t = configs(jax_gen, syn_kw, gen_kw), configs(gen, syn_kw, gen_kw)
    params, buffers = jax_trees(cfg_j)
    sd = params_from_jax(params, buffers)
    g_t = gen.Generator(cfg_t)
    own = g_t.state_dict()
    assert sorted(sd) == sorted(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)
    g_t.load_state_dict(sd, strict=True)

    xyz = plane_inputs(n_planes)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, ZW)).astype(np.float32)
    c = rng.standard_normal((2, gen_kw["c_dim"])).astype(np.float32) if gen_kw else None
    ws_j = ws_t = None
    n_train = syn_kw.get("n_planes_train")
    if n_train is not None and n_train != n_planes:
        ws_j = jax_geom.plane_interp_weights(0.95, 1.12, n_train, n_planes)
        ws_t = geom.plane_interp_weights(0.95, 1.12, n_train, n_planes, device="cpu")
        np.testing.assert_array_equal(ws_t.numpy(), np.asarray(ws_j))

    apply = jax.jit(lambda p, b, z, c, xyz, ws: cfg_j.apply(
        p, b, z, c, xyz, n_planes, noise_mode="const", z_interpolation_ws=ws))
    ref = np.asarray(apply(params, buffers, jnp.asarray(z), None if c is None else jnp.asarray(c),
                           {r: jnp.asarray(v) for r, v in xyz.items()}, ws_j))
    with torch.no_grad():
        out = g_t(torch.from_numpy(z), None if c is None else torch.from_numpy(c),
                  {r: torch.tensor(v) for r, v in xyz.items()}, n_planes,
                  noise_mode="const", z_interpolation_ws=ws_t).numpy()
    assert out.shape == ref.shape == (2, n_planes, 4, RES, RES)
    err = np.max(np.abs(out - ref))
    assert err <= REL_TOL * np.max(np.abs(ref)), err
    if not syn_kw.get("only_alpha", True):  # torgba: RGB differs from plane to plane
        assert np.abs(out[:, 0, :3] - out[:, 1, :3]).max() > 1e-3


def test_cond_modes_need_mlp_or_conv_heads():
    """cond_z/cond_xyz with a modulated head builds in both packages and
    fails at the forward with the JAX package's assertion."""
    syn_kw = dict(cond_mode="cond_z", embed_func="modulated_lrelu")
    cfg_j, cfg_t = configs(jax_gen, syn_kw, {}), configs(gen, syn_kw, {})
    params, buffers = cfg_j.init(jax.random.key(0))
    xyz = plane_inputs(4)
    z = np.zeros((1, ZW), np.float32)
    with pytest.raises(AssertionError):
        cfg_j.apply(params, buffers, jnp.asarray(z), None,
                    {r: jnp.asarray(v) for r, v in xyz.items()}, 4)
    with pytest.raises(AssertionError), torch.no_grad():
        gen.Generator(cfg_t)(torch.from_numpy(z), None,
                             {r: torch.tensor(v) for r, v in xyz.items()}, 4)


def test_chunked_generation_of_a_torgba_variant_matches_unchunked():
    """``generate_mpi``'s plane chunks of the per-plane RGBA head give the
    unchunked MPI (no background plane: every slot is foreground)."""
    from gmpi_tpu_torch.eval.generate import generate_mpi

    syn_kw = CASES["cat_xyz/mlp/torgba"][0]
    g_t = gen.Generator(configs(gen, syn_kw, {}), generator=torch.Generator().manual_seed(0))
    xyz = {r: torch.tensor(v) for r, v in plane_inputs(6).items()}
    z = torch.randn((2, ZW), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = generate_mpi(g_t, z, xyz, 6)
        chunked = generate_mpi(g_t, z, xyz, 6, chunk_n_planes=4)
    # background_alpha_full forces the last slot's alpha in one call only
    torch.testing.assert_close(chunked[:, :, :3], full[:, :, :3], rtol=0, atol=1e-6)
    torch.testing.assert_close(chunked[:, :-1, 3], full[:, :-1, 3], rtol=0, atol=1e-6)
