"""The port's serving slice end to end against the JAX package, on the CPU.

Same weights (JAX init, carried across with ``params_from_jax``) and the same
numpy z: ``generate_mpi`` in both, then ``FakeImageGenerator.render`` at the
same yaws/pitches — JAX through its CPU gather path, the port through both
its fused renderer (the kernel's plain version here) and its gather path.
Tolerance 5e-4 absolute on colors in [-1, 1] and depths ~1 (the renderer
gate of ``bench.py``).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.config import get_config as jax_get_config
from gmpi_tpu.eval.generate import generate_mpi as jax_generate_mpi
from gmpi_tpu.eval.harness import FakeImageGenerator as JaxFakeImageGenerator
from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.eval.harness import FakeImageGenerator
from gmpi_tpu_torch.ops import fused_render
from tests.test_torch_generator import (N_PLANES, jax_trees_with_random_leaves,
                                        port_generator, small_cfg)

TOL = 5e-4
YAWS = np.array([[0.578], [-0.3], [0.0]], np.float32)
PITCHES = np.array([[0.254], [-0.1], [0.0]], np.float32)


@pytest.fixture(scope="module")
def both_generators():
    cfg_j, cfg_t = small_cfg(jax_get_config), small_cfg(get_config)
    params, buffers = jax_trees_with_random_leaves(cfg_j.generator_cfg(), seed=2)
    gen_j = JaxFakeImageGenerator(cfg_j, jax.tree_util.tree_map(jnp.asarray, params),
                                  jax.tree_util.tree_map(jnp.asarray, buffers), use_fused=False)
    g_t = port_generator(cfg_t.generator_cfg(), params, buffers)
    return gen_j, g_t, cfg_t


@pytest.mark.parametrize("use_fused", [True, False])
def test_slice_matches_jax(both_generators, use_fused):
    gen_j, g_t, cfg_t = both_generators
    gen_t = FakeImageGenerator(cfg_t, g_t, use_fused=use_fused, device="cpu")
    z = np.random.default_rng(9).standard_normal((1, 32)).astype(np.float32)

    mpi_j = jax.jit(lambda z: jax_generate_mpi(
        gen_j.gen_cfg, gen_j.params, gen_j.buffers, z, gen_j.xyz_dict, N_PLANES))(
        jnp.asarray(z))
    with torch.no_grad():
        mpi_t = generate_mpi(gen_t.G, torch.from_numpy(z), gen_t.xyz_dict, N_PLANES)
    np.testing.assert_allclose(mpi_t.numpy(), np.asarray(mpi_j), rtol=0, atol=TOL)

    v = len(YAWS)
    color_j, depth_j = gen_j.render(jnp.broadcast_to(mpi_j, (v, *mpi_j.shape[1:])), YAWS,
                                    PITCHES)
    before = dict(fused_render.LAUNCHES)
    color_t, depth_t = gen_t.render(mpi_t.expand(v, -1, -1, -1, -1), YAWS, PITCHES)
    assert fused_render.LAUNCHES == before  # the CPU runs the plain version
    assert color_t.shape == (v, 3, 64, 64) and depth_t.shape == (v, 1, 64, 64)
    np.testing.assert_allclose(color_t.numpy(), np.asarray(color_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j), rtol=0, atol=TOL)
    assert float(color_t.min()) >= -1.0 and float(color_t.max()) <= 1.0


@pytest.mark.parametrize("patch_backend", ["torch", "cuda"])
def test_harness_banded_route_matches_jax(both_generators, patch_backend):
    """``use_fused=False`` at 128 pixels: both packages render through
    ``render_mpi`` with the static tile bands of ``bands_for_config`` (equal
    tuples), the port with the patch backend it picks on the CPU and with the
    one it picks on a card (whose kernel wrapper runs its plain version
    here); the result also equals the port's per-pixel gather."""
    from gmpi_tpu.core.bands import bands_for_config as jax_bands_for_config
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses
    from gmpi_tpu_torch.core.renderer import render_mpi

    gen_j, g_t, cfg_t = both_generators
    gen_j128 = JaxFakeImageGenerator(gen_j.cfg, gen_j.params, gen_j.buffers, img_size=128,
                                     use_fused=False)
    gen_t = FakeImageGenerator(cfg_t, g_t, img_size=128, use_fused=False, device="cpu")
    assert gen_t.patch_backend == "torch"
    gen_t.patch_backend = patch_backend
    ref_bands = jax_bands_for_config(gen_j.cfg, img_size=128, n_planes=gen_j.n_planes)
    assert gen_t.tiled_bands == tuple(int(b) for b in ref_bands)
    assert FakeImageGenerator(cfg_t, g_t, use_fused=False, device="cpu").tiled_bands is None
    v = len(YAWS)
    mpi = np.random.default_rng(4).random((v, N_PLANES, 4, 64, 64)).astype(np.float32)
    color_j, depth_j = gen_j128.render(jnp.asarray(mpi), YAWS, PITCHES)
    color_t, depth_t = gen_t.render(torch.from_numpy(mpi), YAWS, PITCHES)
    assert color_t.shape == (v, 3, 128, 128)
    np.testing.assert_allclose(color_t.numpy(), np.asarray(color_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j), rtol=0, atol=TOL)
    c2w, _, _ = poses.sample_sphere_poses(None, v, cfg_t.camera, given_yaws=YAWS,
                                          given_pitches=PITCHES, device="cpu")
    gather = render_mpi(torch.from_numpy(mpi), gen_t.geom.dhw, *cam.generate_rays(gen_t.intr, c2w))
    np.testing.assert_allclose(color_t.numpy(), gather.color.numpy() * 2.0 - 1.0, rtol=0,
                               atol=1e-5)


def test_sample_mpi_and_views_are_seeded(both_generators):
    _, g_t, cfg_t = both_generators
    gen_t = FakeImageGenerator(cfg_t, g_t, use_fused=True, device="cpu",
                               sanity_full_alpha=True)
    a, b = gen_t.sample_mpi(seed=4), gen_t.sample_mpi(seed=4)
    assert torch.equal(a, b) and a.shape == (1, N_PLANES, 4, 64, 64)
    assert torch.all(a[:, :, 3] == 1.0)
    ya, pa = gen_t.sample_views(seed=4, n_views=5)
    yb, pb = gen_t.sample_views(seed=4, n_views=5)
    assert torch.equal(ya, yb) and torch.equal(pa, pb) and ya.shape == (5, 1)
    # fully opaque planes: the render is the nearest plane's RGB
    color, _ = gen_t.render(a.expand(5, -1, -1, -1, -1), ya, pa)
    assert torch.isfinite(color).all()


def test_harness_raises_on_cuda_without_a_card(both_generators):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, g_t, cfg_t = both_generators
    with pytest.raises(RuntimeError, match="cuda"):
        FakeImageGenerator(cfg_t, g_t)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port (found by walking the package),
    ``chip_smoke.py`` and the CLIs ``train_gmpi_torch.py``,
    ``eval_gmpi_torch.py`` and ``render_gmpi_torch.py`` adds no ``jax``,
    ``jaxlib`` or ``gmpi_tpu`` module to ``sys.modules`` (checked in a fresh
    interpreter)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        before = set(sys.modules)
        import gmpi_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(gmpi_tpu_torch.__path__,
                                                       "gmpi_tpu_torch.")]
        for name in names + ["chip_smoke", "train_gmpi_torch", "eval_gmpi_torch",
                             "render_gmpi_torch"]:
            importlib.import_module(name)
        for walked in ("tools.time_backward", "train.loop", "eval.inception", "eval.adapters",
                       "viz.mesh", "viz.render_video"):
            assert "gmpi_tpu_torch." + walked in names, names
        bad = sorted(m for m in set(sys.modules) - before
                     if m.split(".")[0] in ("jax", "jaxlib", "gmpi_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
