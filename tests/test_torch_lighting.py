"""Port parity: the lighting augmentation and the edge-aware smoothness loss
of ``gmpi_tpu_torch`` against ``gmpi_tpu``.

Same numpy MPI, plane geometry and light angles in both (the JAX side draws
its light from a key; the same key's angles are handed to the port).
Tolerance 1e-4 x max|ref|, fp32 on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core import geometry as jgeom
from gmpi_tpu.core import lighting as jlight
from gmpi_tpu.core import poses as jposes
from gmpi_tpu.utils.img import edge_aware_smooth_loss as jax_edge_aware
from gmpi_tpu_torch.core import geometry as geom_mod
from gmpi_tpu_torch.core import lighting
from gmpi_tpu_torch.utils.img import edge_aware_smooth_loss
from tests.test_torch_fused_render import GEOM_KW

REL_TOL = 1e-4
N_L, RES = 4, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(out) - ref).max() <= REL_TOL * np.abs(ref).max()


def _mpi(seed=0, bs=2):
    rng = np.random.default_rng(seed)
    mpi = rng.random((bs, N_L, 4, RES, RES)).astype(np.float32)
    mpi[:, -1, 3] = 1.0
    return mpi


def test_blur_depth_and_normals_match_jax():
    rng = np.random.default_rng(1)
    x = rng.random((2, 3, 20, 20)).astype(np.float32)
    _close(lighting.gaussian_blur(torch.from_numpy(x), 9), jlight.gaussian_blur(jnp.asarray(x), 9))
    mpi = _mpi()
    ds = np.linspace(0.95, 1.12, N_L).astype(np.float32)
    _close(lighting.expected_depth(torch.from_numpy(mpi[:, :, 3:]), torch.from_numpy(ds)),
           jlight.expected_depth(jnp.asarray(mpi[:, :, 3:]), jnp.asarray(ds)))
    grid = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    _close(lighting.finite_difference_normals(torch.from_numpy(grid)),
           jlight.finite_difference_normals(jnp.asarray(grid)))


def test_light_mpi_matches_jax():
    """The whole augmentation at two schedule positions, same light angles."""
    gj = jgeom.build_plane_geometry(n_planes=N_L, **GEOM_KW)
    gt = geom_mod.build_plane_geometry(n_planes=N_L, **GEOM_KW, device="cpu")
    xyz_j = jgeom.plane_xyz_grid(gj, RES, RES)[-1]
    xyz_t = geom_mod.plane_xyz_grid(gt, RES, RES)[-1]
    cfg_kw = dict(sphere_center_z=1.0, sphere_r=1.0, n_grow_iters=100)
    cfg_j, cfg_t = jlight.LightingConfig(**cfg_kw), lighting.LightingConfig(**cfg_kw)
    mpi = _mpi(seed=2)
    key = jax.random.key(5)
    pose_cfg = jposes.SphereCameraConfig(1.0, 1.0, cfg_j.l_h_mean, cfg_j.l_h_std,
                                         cfg_j.l_v_mean, cfg_j.l_v_std, 2.0,
                                         "truncated_gaussian")
    _, yaws, pitches = jposes.sample_sphere_poses(key, 2, pose_cfg)
    for step in (30, 500):
        ref = jlight.light_mpi(cfg_j, jnp.asarray(mpi), gj.dhw, xyz_j,
                               jnp.asarray(step, jnp.int32), key)
        out = lighting.light_mpi(cfg_t, torch.from_numpy(mpi), gt.dhw, xyz_t, step,
                                 light_yaws=np.array(yaws), light_pitches=np.array(pitches))
        assert out.shape == mpi.shape
        _close(out, ref)
        assert torch.equal(out[:, :, 3], torch.from_numpy(mpi[:, :, 3]))  # alpha untouched
    assert float((out[:, :, :3] - torch.from_numpy(mpi[:, :, :3])).abs().max()) > 1e-3


def test_light_mpi_draws_from_its_generator_and_differentiates():
    gt = geom_mod.build_plane_geometry(n_planes=N_L, **GEOM_KW, device="cpu")
    xyz_t = geom_mod.plane_xyz_grid(gt, RES, RES)[-1]
    cfg_t = lighting.LightingConfig(sphere_center_z=1.0, sphere_r=1.0)
    mpi = torch.from_numpy(_mpi(seed=3)).requires_grad_()
    a = lighting.light_mpi(cfg_t, mpi, gt.dhw, xyz_t, 400, torch.Generator().manual_seed(1))
    b = lighting.light_mpi(cfg_t, mpi, gt.dhw, xyz_t, 400, torch.Generator().manual_seed(1))
    c = lighting.light_mpi(cfg_t, mpi, gt.dhw, xyz_t, 400, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    (g,) = torch.autograd.grad(a.sum(), mpi)
    assert torch.isfinite(g).all() and float(g[:, :, 3].abs().max()) > 0


def test_edge_aware_smooth_loss_matches_jax():
    rng = np.random.default_rng(4)
    rgb = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    depth = (1.0 + 0.1 * rng.random((2, 1, 16, 16))).astype(np.float32)
    ref = jax_edge_aware(jnp.asarray(rgb), jnp.asarray(depth), 0.3, 0.01)
    out = edge_aware_smooth_loss(torch.from_numpy(rgb), torch.from_numpy(depth), 0.3, 0.01)
    assert float(ref) > 0
    np.testing.assert_allclose(float(out), float(ref), rtol=REL_TOL)
