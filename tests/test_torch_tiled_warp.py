"""Port parity: the tile-banded warp and its patch gather in ``gmpi_tpu_torch``.

The same numpy inputs (seeded textures, homography grids computed once by the
JAX package) go through ``gmpi_tpu.ops.tiled_warp`` and its port.  Gates:
band helpers equal ints and bools; samples 1e-5 absolute (two fp32 stacks that
contract in another order); the bf16 operand mode 2e-2 (bf16 rounds at other
places in the two frameworks); the patch gather exact (it is a copy), against
``gather_patches(interpret=True)``.  Where autograd records nothing the
warp takes its taps route, which runs the plain versions of its two kernels
(the patch gather, the tap sampler) on these CPU tensors; it is also held
against the JAX package's Pallas backend in interpret mode.  The hats route
is reached as a caller reaches it, under autograd (``hats``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmpi_tpu.core.renderer import homography_grid as jax_homography_grid
from gmpi_tpu.ops import tiled_warp as jtw
from gmpi_tpu.ops.pallas_patch import gather_patches as jax_gather_patches
from gmpi_tpu_torch.ops import patch_gather as pg
from gmpi_tpu_torch.ops import tiled_warp as tw
from gmpi_tpu_torch.ops.grid_sample import grid_sample_bilinear
from tests.test_torch_fused_render import setup_both
from tests.test_torch_patch_sample import hats


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def homography_grids(n_views=2, n_planes=3, img=64):
    """Real renderer grids over a wide pose range, ``[V*L, img, img, 2]`` numpy."""
    (dj, rj, ej, zj), _ = setup_both(n_planes, img, np.linspace(-0.55, 0.55, n_views),
                                     np.linspace(-0.25, 0.25, n_views))
    v, l = n_views, n_planes
    dhw = jnp.broadcast_to(dj[None], (v, l, 3)).reshape(v * l, 3)
    ray = jnp.broadcast_to(rj[:, None], (v, l, 3, img, img)).reshape(v * l, 3, img, img)
    eye = jnp.broadcast_to(ej[:, None], (v, l, 3)).reshape(v * l, 3)
    z = jnp.broadcast_to(zj[:, None], (v, l, 3)).reshape(v * l, 3)
    return np.asarray(jax_homography_grid(dhw, eye, ray, z)[0])


@pytest.fixture(scope="module")
def scene():
    grid = homography_grids()
    tex = np.random.default_rng(1).random((grid.shape[0], 4, 64, 64)).astype(np.float32)
    return tex, grid


@pytest.mark.parametrize("tile", [(8, 64), (8, 32)])
def test_required_bands_and_bands_cover_equal_jax(scene, tile):
    tex, grid = scene
    by, bx = jtw.required_bands(tex.shape, jnp.asarray(grid), tile=tile)
    assert tw.required_bands(tex.shape, torch.from_numpy(grid), tile=tile) == (by, bx)
    for bands in ((by, bx), (by - 1, bx), (by, bx - 1), (by + 8, bx + 8)):
        ref = bool(jtw.bands_cover(tex.shape, jnp.asarray(grid), *bands, tile=tile))
        out = tw.bands_cover(tex.shape, torch.from_numpy(grid), *bands, tile=tile)
        assert out.dtype == torch.bool and out.ndim == 0 and bool(out) is ref
    with pytest.raises(ValueError, match="multiple of the tile"):
        tw.required_bands(tex.shape, torch.from_numpy(grid), tile=(8, 48))


@pytest.mark.parametrize("row_scan,rows_per_step", [(False, 1), (True, 1), (True, 3)])
def test_grid_sample_tiled_matches_jax(scene, row_scan, rows_per_step):
    tex, grid = scene
    by, bx = jtw.required_bands(tex.shape, jnp.asarray(grid), tile=(8, 64))
    ref = jtw.grid_sample_tiled(jnp.asarray(tex), jnp.asarray(grid), by, bx, tile=(8, 64),
                                row_scan=row_scan, rows_per_step=rows_per_step)
    out = tw.grid_sample_tiled(torch.from_numpy(tex), torch.from_numpy(grid), by, bx,
                               tile=(8, 64), row_scan=row_scan, rows_per_step=rows_per_step)
    assert out.dtype == torch.float32 and out.shape == tex.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # and both equal the per-pixel gather
    gather = grid_sample_bilinear(torch.from_numpy(tex), torch.from_numpy(grid))
    np.testing.assert_allclose(out.numpy(), gather.numpy(), rtol=0, atol=1e-5)


def test_check_poisons_a_render_that_leaves_its_bands(scene):
    tex, grid = scene
    by, bx = jtw.required_bands(tex.shape, jnp.asarray(grid), tile=(8, 64))
    t, g = torch.from_numpy(tex), torch.from_numpy(grid)
    for bands, poisoned in (((by, bx), False), ((by - 2, bx), True)):
        ref = np.asarray(jtw.grid_sample_tiled(jnp.asarray(tex), jnp.asarray(grid), *bands,
                                               tile=(8, 64), check=True))
        out = tw.grid_sample_tiled(t, g, *bands, tile=(8, 64), check=True).numpy()
        assert np.isnan(ref).all() == np.isnan(out).all() == poisoned
        if not poisoned:
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("row_scan,rows_per_step", [(False, 1), (True, 2)])
def test_texture_groups_under_step_bytes_match_jax(scene, row_scan, rows_per_step, monkeypatch):
    """With ``step_bytes`` under one step of all 6 textures' hats (the bytes
    of 4: two groups of 3; 1 byte: one texture and one tile row a step) the
    textures go through in groups, to the JAX package's values and bitwise
    to the ungrouped warp's (the taps' budget: ``tests/test_torch_patch_sample.py``)."""
    tex, grid = scene
    by, bx = jtw.required_bands(tex.shape, jnp.asarray(grid), tile=(8, 64))
    ref = jtw.grid_sample_tiled(jnp.asarray(tex), jnp.asarray(grid), by, bx, tile=(8, 64),
                                row_scan=row_scan, rows_per_step=rows_per_step)
    kw = dict(tile=(8, 64), row_scan=row_scan, rows_per_step=rows_per_step)
    t, g = torch.from_numpy(tex), torch.from_numpy(grid)
    whole = hats(t, g, by, bx, **kw)
    groups, warp = [], tw._warp_textures
    monkeypatch.setattr(tw, "_warp_textures",
                        lambda tx, *a: groups.append((len(tx), a[4])) or warp(tx, *a))
    rows = 2 if row_scan else 8  # tile rows of a step
    tex_bytes = 4 * rows * 8 * 64 * (bx + by + by * 4)
    for step_bytes, sizes in ((4 * tex_bytes, [(3, rows)] * 2), (1, [(1, 1)] * 6),
                              (6 * tex_bytes, [(6, rows)])):
        groups.clear()
        out = hats(t, g, by, bx, step_bytes=step_bytes, **kw)
        assert groups == sizes
        assert torch.equal(out, whole)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_bf16_compute_dtype_matches_jax_within_bf16_rounding():
    rng = np.random.default_rng(3)
    tex = rng.random((2, 4, 64, 64)).astype(np.float32)
    base = np.stack(np.meshgrid(np.linspace(-0.9, 0.9, 64), np.linspace(-0.9, 0.9, 64),
                                indexing="xy"), -1)
    grid = (base[None] + rng.uniform(-0.02, 0.02, (2, 1, 1, 2))).astype(np.float32)
    by, bx = jtw.required_bands(tex.shape, jnp.asarray(grid), tile=(8, 64))
    ref = jtw.grid_sample_tiled(jnp.asarray(tex), jnp.asarray(grid), by, bx, tile=(8, 64),
                                compute_dtype=jnp.bfloat16)
    out = tw.grid_sample_tiled(torch.from_numpy(tex), torch.from_numpy(grid), by, bx,
                               tile=(8, 64), compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-2)
    full = tw.grid_sample_tiled(torch.from_numpy(tex), torch.from_numpy(grid), by, bx,
                                tile=(8, 64))
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=0, atol=2e-2)


def test_zero_padding_out_of_range_is_exactly_zero():
    tex = torch.rand((1, 4, 16, 128), generator=torch.Generator().manual_seed(3))
    grid = torch.full((1, 8, 128, 2), 3.0)  # way outside
    for route in (tw.grid_sample_tiled, hats):
        out = route(tex, grid, band_y=16, band_x=64, tile=(8, 128))
        assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_patches_equals_jax_pallas_interpret(dtype):
    """Tile-aligned offsets (the TPU kernel takes no others), patches at the
    border of the padded texture included: exact equality."""
    rng = np.random.default_rng(5)
    n, wp, hpc, t, band_x, band_yc = 2, 64, 512, 8, 16, 256
    texf = rng.standard_normal((n, wp, hpc)).astype(np.float32)
    offs = np.stack([rng.integers(0, (wp - band_x) // 8 + 1, (n, t)) * 8,
                     rng.integers(0, (hpc - band_yc) // 128 + 1, (n, t)) * 128], -1)
    offs[0, 0] = (0, 0)
    offs[1, -1] = (wp - band_x, hpc - band_yc)
    offs = offs.astype(np.int32)
    ref = jax_gather_patches(jnp.asarray(texf, dtype=getattr(jnp, dtype)), jnp.asarray(offs),
                             band_x, band_yc, k_tiles=4, interpret=True)
    tt = torch.from_numpy(texf).to(getattr(torch, dtype))
    out = pg.gather_patches(tt, torch.from_numpy(offs), band_x, band_yc)
    assert out.dtype == tt.dtype and out.shape == (n, t, band_x, band_yc)
    assert np.array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_gather_patches_takes_any_in_range_offset_and_refuses_the_rest():
    """Unaligned offsets equal a loop of slices; a patch that leaves the
    texture raises on the host; a tensor that requires grad raises."""
    rng = np.random.default_rng(6)
    n, wp, hpc, t, band_x, band_yc = 2, 37, 91, 5, 7, 13
    texf = torch.from_numpy(rng.standard_normal((n, wp, hpc)).astype(np.float32))
    offs = torch.from_numpy(np.stack([rng.integers(0, wp - band_x + 1, (n, t)),
                                      rng.integers(0, hpc - band_yc + 1, (n, t))],
                                     -1).astype(np.int32))
    offs[0, 0] = torch.tensor([wp - band_x, hpc - band_yc])
    before = dict(pg.LAUNCHES)
    out = pg.gather_patches(texf, offs, band_x, band_yc)
    assert pg.LAUNCHES == before  # the CPU runs the plain version
    for ni in range(n):
        for ti in range(t):
            x, y = (int(a) for a in offs[ni, ti])
            assert torch.equal(out[ni, ti], texf[ni, x:x + band_x, y:y + band_yc])
    for bad in ((wp - band_x + 1, 0), (0, hpc - band_yc + 1), (-1, 0)):
        worse = offs.clone()
        worse[1, 2] = torch.tensor(bad)
        with pytest.raises(ValueError, match="leaves the texture"):
            pg.gather_patches(texf, worse, band_x, band_yc)
    with pytest.raises(ValueError, match="int32"):
        pg.gather_patches(texf, offs.long(), band_x, band_yc)
    with pytest.raises(ValueError, match="do not fit"):
        pg.gather_patches(texf, offs, wp + 1, band_yc)
    with pytest.raises(RuntimeError, match="no gradient"):
        pg.gather_patches(texf.clone().requires_grad_(), offs, band_x, band_yc)
    with torch.no_grad():
        pg.gather_patches(texf.clone().requires_grad_(), offs, band_x, band_yc)


def test_tap_route_matches_jax_pallas_backend_interpret():
    """The taps (the plain versions of the patch gather and the tap sampler
    here) against the JAX Pallas backend in interpret mode, with the bands
    that backend needs (its DMA alignment slack); and against the port's
    hats (the same patches, the hats' bilinear sum in another order) within
    1e-6 of max|samples|."""
    rng = np.random.default_rng(9)
    grid = homography_grids(n_views=1, n_planes=4, img=64)
    tex = rng.random((grid.shape[0], 4, 64, 64)).astype(np.float32)
    by, bx = jtw.required_bands(tex.shape, jnp.asarray(grid), tile=(8, 64))
    by_a, bx_a = ((by + 62) // 32) * 32, ((bx + 14) // 8) * 8
    # the JAX package's arguments (tile, align_corners, row_scan, rows_per_step, its patch
    # backend, interpret): its Pallas backend in interpret mode
    ref = jtw.grid_sample_tiled(jnp.asarray(tex), jnp.asarray(grid), by_a, bx_a, (8, 64), True,
                                False, 1, "pallas", True)
    t, g = torch.from_numpy(tex), torch.from_numpy(grid)
    out = tw.grid_sample_tiled(t, g, by_a, bx_a, tile=(8, 64))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # no alignment slack needed here: the exact bands serve both routes alike
    a = tw.grid_sample_tiled(t, g, by, bx, tile=(8, 64))
    b = hats(t, g, by, bx, tile=(8, 64))
    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
