"""Port parity: the vanilla and depth2alpha generators of ``gmpi_tpu_torch``
against ``gmpi_tpu/models/generator_vanilla.py``.

A narrow generator (resolution 16, fp32, 5 fixed planes) is initialized by
JAX, its biases, noise strengths and ``w_avg`` replaced by numpy draws, and
carried into the port with ``params_from_jax``.  The same numpy z on the same
numpy conditioning grids must give the same MPI within 1e-4 x max|ref|, and
the state-dict keys must be the JAX tree's paths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core import geometry as jax_geom
from gmpi_tpu.models.generator_vanilla import VanillaGeneratorCfg as JaxVanillaCfg
from gmpi_tpu_torch.models.converter import convert_generator_checkpoint, params_from_jax
from gmpi_tpu_torch.models.generator_vanilla import VanillaGenerator, VanillaGeneratorCfg

N_PLANES, RES = 5, 16
REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(tree, rng):
    def perturb(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name.startswith("bias") or name in ("noise_strength", "w_avg"):
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.mark.parametrize("head_type,sep_background,alpha_full", [
    ("vanilla", True, False), ("depth2alpha", True, True), ("depth2alpha", False, False)])
def test_vanilla_family_matches_jax(head_type, sep_background, alpha_full):
    kw = dict(z_dim=16, w_dim=16, img_resolution=RES, n_planes=N_PLANES, channel_base=256,
              channel_max=32, conv_clamp=256.0, head_type=head_type, mapping_num_layers=2,
              sep_background=sep_background, background_alpha_full=alpha_full,
              depth2alpha_n_z_bins=8)
    cfg_j = JaxVanillaCfg(**kw)
    params, buffers = cfg_j.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    params, buffers = perturbed(params, rng), perturbed(buffers, rng)
    sd = params_from_jax(params, buffers)
    g_t = VanillaGenerator(VanillaGeneratorCfg(**kw))
    assert sorted(sd) == sorted(g_t.state_dict())
    assert ("todepth" in params["synthesis"]["b16"]) == (head_type == "depth2alpha")
    g_t.load_state_dict(sd, strict=True)

    geom = jax_geom.build_plane_geometry(
        n_planes=N_PLANES, min_d=0.95, max_d=1.12, fov_deg=12.6, sphere_center_z=1.0,
        sphere_r=1.0, yaw_mean=0.0, yaw_std=0.289, pitch_mean=0.0, pitch_std=0.127)
    xyz = {r: np.asarray(v) for r, v in jax_geom.multi_res_xyz(geom, RES).items()}
    z = np.random.default_rng(3).standard_normal((2, 16)).astype(np.float32)
    apply = jax.jit(lambda p, b, z, xyz: cfg_j.apply(p, b, z, None, xyz, noise_mode="const"))
    ref = np.asarray(apply(params, buffers, jnp.asarray(z),
                           {r: jnp.asarray(v) for r, v in xyz.items()}))
    with torch.no_grad():
        out = g_t(torch.from_numpy(z), None, {r: torch.tensor(v) for r, v in xyz.items()},
                  noise_mode="const").numpy()
    assert out.shape == ref.shape == (2, N_PLANES, 4, RES, RES)
    err = np.abs(out - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), err
    if head_type == "depth2alpha":  # alphas step up with plane depth at a fixed depth
        assert (np.diff(out[:, :-1, 3], axis=1) >= -1e-6).all()
    with pytest.raises(AssertionError):  # the plane count is baked in
        g_t(torch.from_numpy(z), None, {r: torch.tensor(v) for r, v in xyz.items()},
            n_planes=N_PLANES + 1)


def test_vanilla_warm_start_from_the_main_generators_names():
    """The vanilla family shares the mapping and trunk names of the main
    generator: a warm start from its state dict fills them and leaves the
    L-alpha head at its initial value."""
    kw = dict(z_dim=16, w_dim=16, img_resolution=RES, n_planes=N_PLANES, channel_base=256,
              channel_max=32, mapping_num_layers=2)
    src = VanillaGenerator(VanillaGeneratorCfg(**kw), generator=torch.Generator().manual_seed(1))
    sd = {k: v.numpy() for k, v in src.state_dict().items() if "toalpha" not in k}
    cfg = VanillaGeneratorCfg(**kw)
    params, buffers = convert_generator_checkpoint(
        sd, cfg, warm_start=True, generator=torch.Generator().manual_seed(2))
    init = VanillaGenerator(cfg, generator=torch.Generator().manual_seed(2)).state_dict()
    for k, v in {**params, **buffers}.items():
        want = init[k] if "toalpha" in k else torch.from_numpy(sd[k])
        assert torch.equal(v, want), k
