"""Port parity: the tiled warp's scatter-free adjoint in ``gmpi_tpu_torch``.

The same numpy inputs go through ``gmpi_tpu.ops.tiled_warp_adjoint`` and its
port: the band helpers give equal bools and ints, the adjoint itself and the
gradient of ``make_tiled_warp_with_adjoint`` agree within 1e-4 absolute (two
fp32 stacks; cotangents are O(1) and a texel sums a handful of them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.ops import tiled_warp as jtw
from gmpi_tpu.ops import tiled_warp_adjoint as jta
from gmpi_tpu_torch.ops import tiled_warp as tw
from gmpi_tpu_torch.ops import tiled_warp_adjoint as ta
from gmpi_tpu_torch.ops.grid_sample import grid_sample_bilinear
from tests.test_torch_tiled_warp import homography_grids


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    grid = homography_grids(n_views=2, n_planes=2, img=64)
    rng = np.random.default_rng(6)
    tex = rng.random((grid.shape[0], 4, 64, 64)).astype(np.float32)
    cot = rng.standard_normal((grid.shape[0], 4, 64, 64)).astype(np.float32)
    return tex, grid, cot


def test_check_monotone_equals_jax(scene):
    tex, grid, _ = scene
    for g in (grid, grid[:, :, ::-1].copy(), grid[:, ::-1].copy()):
        ref = jta.check_monotone(tex.shape, jnp.asarray(g))
        assert ta.check_monotone(tex.shape, torch.from_numpy(g)) is ref
    assert ta.check_monotone(tex.shape, torch.from_numpy(grid)) is True
    assert ta.check_monotone(tex.shape, torch.from_numpy(grid[:, ::-1].copy())) is False


@pytest.mark.parametrize("tile", [(8, 64), (32, 64), (8, 32)])
def test_required_output_bands_equal_jax(scene, tile):
    tex, grid, _ = scene
    ref = jta.required_output_bands(tex.shape, jnp.asarray(grid), tile=tile)
    assert ta.required_output_bands(tex.shape, torch.from_numpy(grid), tile=tile) == ref


@pytest.mark.parametrize("row_scan,rows_per_step,step_bytes", [
    (False, 1, None), (True, 1, None), (True, 2, None), (False, 1, 1), (True, 2, 1)])
def test_grid_sample_tiled_adjoint_matches_jax(scene, row_scan, rows_per_step, step_bytes,
                                               monkeypatch):
    """With ``step_bytes`` (1 byte: one plane a step) the planes go through
    one at a time, to the same values."""
    tex, grid, cot = scene
    pbr, pbc = jta.required_output_bands(tex.shape, jnp.asarray(grid), tile=(8, 32))
    ref = jta.grid_sample_tiled_adjoint(jnp.asarray(cot), jnp.asarray(grid), tex.shape, pbr, pbc,
                                        tile=(8, 32), row_scan=row_scan,
                                        rows_per_step=rows_per_step)
    groups, planes = [], ta._adjoint_planes

    def recorded(cot, *a, **kw):
        groups.append(cot.shape[0])
        return planes(cot, *a, **kw)

    monkeypatch.setattr(ta, "_adjoint_planes", recorded)
    out = ta.grid_sample_tiled_adjoint(torch.from_numpy(cot), torch.from_numpy(grid), tex.shape,
                                       pbr, pbc, tile=(8, 32), row_scan=row_scan,
                                       rows_per_step=rows_per_step, step_bytes=step_bytes)
    assert groups == ([tex.shape[0]] if step_bytes is None else [1] * tex.shape[0])
    assert out.shape == tex.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="multiple of the tile"):
        ta.grid_sample_tiled_adjoint(torch.from_numpy(cot), torch.from_numpy(grid), tex.shape,
                                     pbr, pbc, tile=(8, 48))


@pytest.mark.parametrize("patch_backend", ["torch", "cuda"])
def test_gradient_of_tiled_warp_with_adjoint_matches_jax(scene, patch_backend):
    """The Function's forward and its texture gradient against the JAX
    custom-VJP warp's, and the gradient against plain autograd through the
    per-pixel gather.  The kernel backend works inside the Function (no
    autograd records there) and the grid gets no gradient."""
    tex, grid, cot = scene
    by, bx = jtw.required_bands(tex.shape, jnp.asarray(grid), tile=(8, 64))
    pbr, pbc = jta.required_output_bands(tex.shape, jnp.asarray(grid), tile=(8, 64))
    kw = dict(tile=(8, 64), adjoint_tile=(8, 64))
    fn_j = jtw.make_tiled_warp_with_adjoint(by, bx, (pbr, pbc), **kw)
    val_j, g_j = jax.value_and_grad(
        lambda t: jnp.sum(fn_j(t, jnp.asarray(grid)) * jnp.asarray(cot)))(jnp.asarray(tex))

    fn_t = tw.make_tiled_warp_with_adjoint(by, bx, (pbr, pbc), patch_backend=patch_backend, **kw)
    x = torch.from_numpy(tex).clone().requires_grad_()
    g = torch.from_numpy(grid).clone().requires_grad_()
    val_t = (fn_t(x, g) * torch.from_numpy(cot)).sum()
    val_t.backward()
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=0, atol=1e-4)
    assert g.grad is None

    y = torch.from_numpy(tex).clone().requires_grad_()
    (grid_sample_bilinear(y, torch.from_numpy(grid)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=0, atol=1e-4)
