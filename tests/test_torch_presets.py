"""Port parity at the 1024^2 and 512^2 presets, on the CPU.

The presets run on the card in ``chip_smoke.py`` phase 13 and in
``tests/test_torch_full_scale.py``; here they are held against the JAX
package at sizes the CPU affords:

* the structure of a full-width model: the JAX init of FFHQ1024 and of
  AFHQCat, traced with ``jax.eval_shape`` (no compute), maps leaf for leaf
  through ``params_from_jax`` onto the port's generator and discriminator,
  and the port's modules hold no other parameter or buffer;
* the FFHQ1024 generator at full depth (blocks 4 ... 1024, ``num_bf16_res``
  4, ``conv_clamp`` 256) at a narrow width, through both packages;
* one whole train step with FFHQ1024's switches on together (batch 4,
  ``batch_split`` 2, ``d_batch_split``, ``r1_remat``, the fused renderer
  with ``fused_remat``, a low-resolution worst-view render, lighting past
  its start) against the JAX step (``tests/_torch_jax_step.py``): at 16^2
  with 32 planes in fp32 (four ``fused_remat`` slabs; the JAX step renders
  through its gather route there), and at 128^2 with bf16 textures against
  the JAX step's fused kernels in interpret mode.
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
from gmpi_tpu_torch.models.discriminator import Discriminator
from gmpi_tpu_torch.models.generator import Generator
from tests import _torch_dist_child as child
from tests import _torch_jax_step as jax_step
from tests.test_torch_generator import jax_trees_with_random_leaves, port_generator

# FFHQ1024's switches (gmpi_tpu/config.py presets, docs/TPU_TRAIN.md's memory
# switches) at the tiny configuration's batch: micro-batches of 2 in both
# phases, R1 rematerialized, the fused slabs rematerialized, worst views at
# half the resolution, lighting from the first step
FFHQ1024_SWITCHES = dict(batch_size=4, batch_split=2, d_batch_split=True, r1_remat=True,
                         use_fused_renderer=True, fused_remat=True, aug_with_lighting=True,
                         lighting_start_iter=-1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["FFHQ1024", "AFHQCat"])
def test_full_width_init_maps_one_to_one(name):
    """Every leaf of the JAX init (shapes only) becomes a port parameter or
    buffer of the same shape, and the port's modules have nothing else:
    ``load_state_dict(strict=True)`` of the carried-across tree."""
    cfg_j, cfg_t = jax_get_config(name), get_config(name)
    key = jax.random.key(0)
    zeros = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda s: np.zeros(s.shape, np.float32), tree)
    g_params, g_buffers = jax.eval_shape(cfg_j.generator_cfg().init, key)
    d_params = jax.eval_shape(cfg_j.discriminator_cfg().init, key)
    for module, trees in ((Generator(cfg_t.generator_cfg()), (g_params, g_buffers)),
                          (Discriminator(cfg_t.discriminator_cfg()), (d_params,))):
        sd = params_from_jax(*(zeros(t) for t in trees))
        own = module.state_dict()
        assert sorted(sd) == sorted(own), (sorted(set(sd) ^ set(own)))[:5]
        assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)
        module.load_state_dict(sd, strict=True)
        n_jax = sum(int(np.prod(leaf.shape)) for t in trees
                    for leaf in jax.tree_util.tree_leaves(t))
        assert n_jax == sum(v.numel() for v in own.values())
        assert {k for k, _ in module.named_parameters()} <= set(sd)
    assert cfg_t.generator_cfg().synthesis.block_resolutions[-1] == cfg_t.resolution


N_PLANES_1024 = 4


def _narrow_1024(get, bf16=True):
    """FFHQ1024 at full depth (blocks 4 ... 1024, conv_clamp 256), channels
    capped at 16, 4 planes; ``num_bf16_res`` 4 as the preset, or 0."""
    cfg = get("FFHQ1024")
    return dataclasses.replace(
        cfg, eval_n_planes=N_PLANES_1024,
        planes=dataclasses.replace(cfg.planes, n_planes=N_PLANES_1024),
        model=dataclasses.replace(cfg.model, channel_max=16,
                                  num_bf16_res=cfg.model.num_bf16_res if bf16 else 0))


@pytest.fixture(scope="module")
def full_depth_mpis():
    """The narrow full-depth FFHQ1024 generator's MPI from one z, through
    both packages, with bf16 at the top 4 resolutions and in fp32:
    ``{(package, bf16): mpi}``."""
    cfg_j = _narrow_1024(jax_get_config)
    params, buffers = jax_trees_with_random_leaves(cfg_j.generator_cfg())
    z = np.random.default_rng(3).standard_normal((1, cfg_j.train.z_dim)).astype(np.float32)
    out = {}
    for bf16 in (True, False):
        cfg_j, cfg_t = _narrow_1024(jax_get_config, bf16), _narrow_1024(get_config, bf16)
        gen_j = cfg_j.generator_cfg()
        xyz_j = cfg_j.multi_res_xyz(cfg_j.plane_geometry())
        out["jax", bf16] = np.asarray(jax.jit(lambda p, b, z: jax_generate_mpi(
            gen_j, p, b, z, xyz_j, N_PLANES_1024, noise_mode="const"))(params, buffers,
                                                                        jnp.asarray(z)))
        gen_t = port_generator(cfg_t.generator_cfg(), params, buffers)
        xyz_t = cfg_t.multi_res_xyz(cfg_t.plane_geometry(device="cpu"))
        with torch.no_grad():
            out["port", bf16] = generate_mpi(gen_t, torch.from_numpy(z), xyz_t, N_PLANES_1024,
                                             noise_mode="const").numpy()
    return out


def test_ffhq1024_generator_full_depth_fp32_matches_jax(full_depth_mpis):
    """Without bf16 blocks the two packages compute the same fp32 function at
    every depth up to 1024^2: 1e-4 x max|ref| (measured 1.5e-5)."""
    ref, out = full_depth_mpis["jax", False], full_depth_mpis["port", False]
    assert out.shape == ref.shape == (1, N_PLANES_1024, 4, 1024, 1024)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_ffhq1024_generator_full_depth_bf16_matches_jax(full_depth_mpis):
    """The preset's bf16 blocks at 128 ... 1024.  The two frameworks round to
    bf16 in the same places, but an fp32 sum that differs in its last bit
    can round to the other bf16 neighbour (2^-8 relative), and six blocks of
    convolutions and the tanh carry that on: measured 4.6e-2 max and 1.3e-3
    mean apart, where bf16 itself moves either package 6.1e-2 to 6.7e-2 max
    and 2.1e-3 mean from its fp32 output.  So the two bf16 MPIs must be
    closer to each other than bf16 moves the JAX MPI from fp32: the mean
    within 0.8 of that move and the max within it; a port that ran its top
    blocks in fp32 would sit at the move itself."""
    ref, out = full_depth_mpis["jax", True], full_depth_mpis["port", True]
    move = np.abs(ref - full_depth_mpis["jax", False])
    apart = np.abs(out - ref)
    assert np.isfinite(out).all() and move.mean() > 0
    assert apart.mean() <= 0.8 * move.mean(), (apart.mean(), move.mean())
    assert apart.max() <= move.max(), (apart.max(), move.max())


def _step_against_jax(cfg, gates):
    cfg_j = jax_step.jax_config(cfg)
    st = jax_step.jax_state(cfg_j)
    real, pose = child.step_batch(cfg)
    ref = jax_step.run_jax_step(cfg_j, st, real, pose)
    state, metrics, grads = child.run_step(cfg, params=jax_step.port_params(st),
                                           draws=jax_step.jax_draws(cfg_j))
    jax_step.assert_step_matches(ref, child.step_record(state, metrics, grads), **gates)


def test_ffhq1024_switches_step_matches_jax():
    """FFHQ1024's switches together at 16^2 and 32 planes (the port's
    ``fused_remat`` combines four slabs of 8, the JAX step renders the same
    function through its gather route), worst views at 8^2: metrics, every
    D and G gradient, G's state and EMAs after the update within
    ``FP32_GATES``."""
    cfg = child.tiny_config(n_planes=32, worst_view_render_res=8, **FFHQ1024_SWITCHES)
    _step_against_jax(cfg, jax_step.FP32_GATES)


def test_ffhq1024_switches_bf16_step_matches_jax():
    """The same switches with bf16 textures at 128^2 (2 planes; worst views
    at 64^2) against the JAX step's fused kernels in interpret mode
    (``fused_remat``'s slab renderer with bf16 textures): ``BF16_GATES``."""
    cfg = child.tiny_config(resolution=128, n_planes=2, worst_view_render_res=64,
                            fused_compute_dtype="bf16", **FFHQ1024_SWITCHES)
    _step_against_jax(cfg, jax_step.BF16_GATES)
