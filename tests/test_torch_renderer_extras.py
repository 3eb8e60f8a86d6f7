"""Port parity: the renderer's remaining entry points in ``gmpi_tpu_torch``.

``render_mpi_chunked`` (plain, rematerialized, through tile bands, with one
band tuple per slab, with and without disparity), ``composite_sequential``,
the ray-coverage checks and ``render_mpi(stop_pose_grad=False)`` against the
JAX package's on the same numpy inputs.  Gates: renders 5e-4 absolute (the
renderer gate of ``bench.py``), gradients 1e-3 of the reference's largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core import renderer as jr
from gmpi_tpu.ops.tiled_warp import required_bands as jax_required_bands
from gmpi_tpu_torch.core import renderer as tr
from tests.test_torch_fused_render import random_mpi, setup_both
from tests.test_torch_tiled_warp import homography_grids

TOL = 5e-4
N_L, RES = 4, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    cams_j, cams_t = setup_both(N_L, RES, [0.5, -0.3], [0.2, -0.1])
    rgba = random_mpi(2, N_L, RES, seed=5)
    cot = np.random.default_rng(8).standard_normal((2, 3, RES, RES)).astype(np.float32)
    grid = homography_grids(n_views=2, n_planes=N_L, img=RES)
    by, bx = jax_required_bands((2 * N_L, 4, RES, RES), jnp.asarray(grid), tile=(8, RES))
    return cams_j, cams_t, rgba, cot, (by + 8, bx + 8)


def _value_and_grad_both(scene, kw_j, kw_t):
    cams_j, cams_t, rgba, cot, _ = scene
    out_j, g_j = jax.value_and_grad(
        lambda x: jnp.sum(jr.render_mpi_chunked(x, *cams_j, **kw_j).color * cot))(
        jnp.asarray(rgba))
    x = torch.from_numpy(rgba).clone().requires_grad_()
    out_t = (tr.render_mpi_chunked(x, *cams_t, **kw_t).color * torch.from_numpy(cot)).sum()
    out_t.backward()
    return (float(out_j), np.asarray(g_j)), (float(out_t.detach()), x.grad.numpy())


@pytest.mark.parametrize("case", ["plain", "remat", "tiled", "tiled_cuda_patches",
                                  "per_chunk_bands_remat"])
def test_render_mpi_chunked_matches_jax(scene, case):
    cams_j, cams_t, rgba, _, bands = scene
    kw = dict(plane_chunk=2)
    kw_j, kw_t = dict(kw), dict(kw)
    if case == "remat":
        kw_j["remat"] = kw_t["remat"] = True
    if case == "tiled":
        kw_j["tiled_bands"] = kw_t["tiled_bands"] = bands
    if case == "tiled_cuda_patches":
        # the card's route: 4-field bands, so that under autograd too the warp takes
        # the taps (the kernels' plain versions here) with the tiled adjoint as backward
        kw_j["tiled_bands"] = kw_t["tiled_bands"] = bands + (40, 80)
    if case == "per_chunk_bands_remat":
        per = ((bands[0], bands[1]), (bands[0] + 8, bands[1] + 8))
        kw_j.update(remat=True, tiled_bands=per)
        kw_t.update(remat=True, tiled_bands=per)
    for with_disp in (True, False):
        ref = jr.render_mpi_chunked(jnp.asarray(rgba), *cams_j, with_disp=with_disp, **kw_j)
        with torch.no_grad():
            out = tr.render_mpi_chunked(torch.from_numpy(rgba), *cams_t, with_disp=with_disp,
                                        **kw_t)
        assert (out.disp is None) == (ref.disp is None) == (not with_disp)
        for a, b in zip(ref, out):
            if a is not None:
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=TOL)
    (val_j, g_j), (val_t, g_t) = _value_and_grad_both(scene, kw_j, kw_t)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-4)
    assert np.abs(g_t - g_j).max() <= 1e-3 * np.abs(g_j).max()


def test_render_mpi_chunked_equals_the_unchunked_render_and_checks_its_chunk(scene):
    _, cams_t, rgba, _, bands = scene
    x = torch.from_numpy(rgba)
    whole = tr.render_mpi(x, *cams_t)
    for kw in (dict(), dict(tiled_bands=bands), dict(tiled_bands=bands + (40, 80))):
        out = tr.render_mpi_chunked(x, *cams_t, plane_chunk=1, **kw)
        for a, b in zip(whole, out):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="does not divide"):
        tr.render_mpi_chunked(x, *cams_t, plane_chunk=3)
    with pytest.raises(ValueError, match="band tuples"):
        tr.render_mpi_chunked(x, *cams_t, plane_chunk=2, tiled_bands=(bands,))


def test_banded_render_loops_tile_rows_under_its_step_budget(scene, monkeypatch):
    """With more hats than ``TILED_STEP_BYTES`` in one step, the banded render
    under autograd (whose warp takes the hats) goes through equal texture
    groups sized to the budget and, where one texture's tile rows exceed it,
    loops over groups of tile rows: same values, more steps."""
    from gmpi_tpu_torch.ops import tiled_warp as tw

    _, cams_t, rgba, _, bands = scene
    steps = []  # (textures, tiles) of each tile-row step
    row_step = tw._warp_row_tiles
    monkeypatch.setattr(tw, "_warp_row_tiles",
                        lambda texf, fx, *a, **k: steps.append(tuple(fx.shape[:2])) or
                        row_step(texf, fx, *a, **k))
    x = torch.from_numpy(rgba).requires_grad_()
    whole = tr.render_mpi(x, *cams_t, tiled_bands=bands)
    # all 8 tile rows of the one 64-wide tile column of all 8 textures at once
    assert steps == [(2 * N_L, RES // 8)]
    row_bytes = 4 * 8 * RES * (bands[1] + bands[0] + bands[0] * 4)  # one texture's tile row
    for budget, want in (
            (3 * 8 * row_bytes, [(3, 8), (3, 8), (2, 8)]),  # 3 textures fit: 3 equal groups
            # 3 rows of one texture fit; 2 is the largest divisor of 8 under it
            (3 * row_bytes, [(1, 2)] * (4 * 2 * N_L))):
        monkeypatch.setattr(tr, "TILED_STEP_BYTES", budget)
        del steps[:]
        looped = tr.render_mpi(x, *cams_t, tiled_bands=bands)
        assert steps == want
        for a, b in zip(whole, looped):
            assert torch.equal(a, b)


def test_render_mpi_tiled_bands_matches_jax_in_value_and_gradient(scene):
    """``render_mpi(tiled_bands=...)`` with 2-field bands (plain autograd) and
    4-field bands (the tiled adjoint as backward) against JAX's."""
    cams_j, cams_t, rgba, cot, bands = scene
    for tb in (bands, bands + (40, 80)):
        val_j, g_j = jax.value_and_grad(
            lambda x: jnp.sum(jr.render_mpi(x, *cams_j, tiled_bands=tb).color * cot))(
            jnp.asarray(rgba))
        x = torch.from_numpy(rgba).clone().requires_grad_()
        out = tr.render_mpi(x, *cams_t, tiled_bands=tb)
        val_t = (out.color * torch.from_numpy(cot)).sum()
        val_t.backward()
        np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-4)
        assert np.abs(x.grad.numpy() - np.asarray(g_j)).max() <= 1e-3 * np.abs(g_j).max()


def test_composite_sequential_matches_jax_and_composite():
    rng = np.random.default_rng(11)
    rgb = rng.random((2, 6, 3, 16, 16)).astype(np.float32)
    alpha = rng.random((2, 6, 1, 16, 16)).astype(np.float32)
    depth = rng.random((2, 6, 1, 16, 16)).astype(np.float32) + 1.0
    ref = jr.composite_sequential(jnp.asarray(rgb), jnp.asarray(alpha), jnp.asarray(depth))
    t = torch.from_numpy
    out = tr.composite_sequential(t(rgb), t(alpha), t(depth))
    vec = tr.composite(t(rgb), t(alpha), t(depth))
    for a, b, c in zip(ref, out, vec):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=1e-4, atol=1e-5)


def test_ray_coverage_checks_inside_and_outside(scene):
    """A pose inside the truncation range keeps every ray on the last plane; a
    yaw far outside does not.  All three checks agree with the JAX package's."""
    (dj, _, _, _), (dt, _, _, _), _, _, _ = scene
    color = np.random.default_rng(2).random((1, 3, RES, RES)).astype(np.float32)
    for yaw, inside in ((0.5, True), (1.4, False)):
        (_, rj, ej, zj), (_, rt, et, zt) = setup_both(N_L, RES, [yaw], [0.1])
        ref_ok = bool(jr.ray_coverage_ok(dj[-1], ej, rj, zj))
        ok = tr.ray_coverage_ok(dt[-1], et, rt, zt)
        assert ok.dtype == torch.bool and ok.ndim == 0
        assert bool(ok) is ref_ok is inside
        assert tr.check_rays_hit_last_plane(dt[-1:], et, rt, zt) is inside
        assert jr.check_rays_hit_last_plane(dj[-1:], ej, rj, zj) is inside
        ref = np.asarray(jr.poison_if_rays_escape(jnp.asarray(color), dj[-1], ej, rj, zj))
        out = tr.poison_if_rays_escape(torch.from_numpy(color), dt[-1], et, rt, zt).numpy()
        assert np.isnan(out).all() == np.isnan(ref).all() == (not inside)
        if inside:
            assert np.array_equal(out, color)


@pytest.mark.parametrize("tiled", [False, True], ids=["gather", "tiled"])
def test_differentiable_pose_gradient_matches_jax(tiled):
    """``stop_pose_grad=False``: the gradient of a render with respect to the
    eye position, through the grid and the depth, against ``jax.grad`` (1e-3
    relative; a smooth texture and an eye offset off the bilinear kinks); with
    tile bands the mode drops to plain autograd through the banded warp.  By
    default the pose gets no gradient."""
    res = 32
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(N_L, res, [0.2], [0.1])
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res), indexing="ij")
    smooth = np.stack([np.sin(2 * yy + 1), np.cos(3 * xx), yy * xx, 0.5 + 0.4 * np.sin(xx + yy)])
    rgba = (np.tile(smooth[None, None], (1, N_L, 1, 1, 1)) * 0.5 + 0.25).astype(np.float32)
    cot = np.random.default_rng(3).standard_normal((1, 3, res, res)).astype(np.float32)
    offset = np.array([[0.00337, -0.0021, 0.0013]], np.float32)
    bands = None
    if tiled:
        grid = homography_grids(n_views=1, n_planes=N_L, img=res)
        by, bx = jax_required_bands((N_L, 4, res, res), jnp.asarray(grid), tile=(8, res))
        bands = (by + 16, bx + 16, 40, 40)  # 4 fields: the mode keeps the first two

    def loss_j(e):
        out = jr.render_mpi(jnp.asarray(rgba), dj, rj, e, zj, tiled_bands=bands,
                            stop_pose_grad=False)
        return jnp.sum(out.color * cot) + jnp.sum(out.depth)

    g_j = np.asarray(jax.grad(loss_j)(ej + offset))
    e = (et + torch.from_numpy(offset)).requires_grad_()
    out = tr.render_mpi(torch.from_numpy(rgba), dt, rt, e, zt, tiled_bands=bands,
                        stop_pose_grad=False)
    ((out.color * torch.from_numpy(cot)).sum() + out.depth.sum()).backward()
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(e.grad.numpy(), g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())
    e2 = (et + torch.from_numpy(offset)).requires_grad_()
    stopped = tr.render_mpi(torch.from_numpy(rgba), dt, rt, e2, zt, tiled_bands=bands)
    assert not stopped.color.requires_grad and not stopped.depth.requires_grad
