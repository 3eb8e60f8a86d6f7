"""Port parity: static band estimation (``gmpi_tpu_torch/core/bands.py``)
gives the JAX package's tuples, as equal ints: on a small config, and for
each of the five presets at 128^2 and 256^2 with 8 planes, planned at once
and in (pose, plane) groups that do not divide the pair count.  Planning
runs on the caller's device and raises without a card unless asked for the
CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from gmpi_tpu.config import get_config as jax_get_config
from gmpi_tpu.core import bands as jbands
from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.core import bands

PRESETS = ("FFHQ256", "FFHQ512", "FFHQ1024", "AFHQCat", "MetFaces")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(get, name="FFHQ256", n_planes=3):
    cfg = get(name)
    return dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_planes))


def test_corner_rays_match_jax():
    cj, ct = _small(jax_get_config), _small(get_config)
    ref = jbands._corner_rays(cj.camera, cj.fov_deg, 32, 32)
    out = bands._corner_rays(ct.camera, ct.fov_deg, 32, 32, device="cpu")
    assert out[0].shape == (9, 3, 32, 32)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("img,tile", [(128, None), (64, (8, 64))], ids=["128", "64_tile_8x64"])
def test_estimate_bands_equal_jax(img, tile):
    cj, ct = _small(jax_get_config), _small(get_config)
    ref = jbands.estimate_bands(cj.plane_geometry(), cj.camera, cj.fov_deg, img, img, tile=tile)
    out = bands.estimate_bands(ct.plane_geometry(device="cpu"), ct.camera, ct.fov_deg, img, img,
                               tile=tile, device="cpu")
    assert len(out) == 4 and all(isinstance(b, int) for b in out)
    assert out == tuple(int(b) for b in ref)


def test_bands_for_config_equal_jax_and_none_under_128():
    cj, ct = _small(jax_get_config), _small(get_config)
    ref = jbands.bands_for_config(cj, img_size=128, n_planes=2)
    assert bands.bands_for_config(ct, img_size=128, n_planes=2,
                                  device="cpu") == tuple(int(b) for b in ref)
    assert bands.bands_for_config(ct, img_size=64, device="cpu") is None
    assert jbands.bands_for_config(cj, img_size=64) is None


@pytest.mark.parametrize("img", [128, 256])
@pytest.mark.parametrize("name", PRESETS)
def test_grouped_planning_equals_ungrouped_and_jax(name, img, monkeypatch):
    """Each preset's camera and planes (8 of them, 9 poses: 72 pairs) in
    groups of 5 pairs (14 groups and one of 2), then all at once: the same
    tuple as the JAX package's ``bands_for_config``."""
    cj, ct = _small(jax_get_config, name, 8), _small(get_config, name, 8)
    ref = tuple(int(b) for b in jbands.bands_for_config(cj, img_size=img))
    groups, grid_of = [], bands.homography_grid

    def recorded(dhw, *a, **kw):
        groups.append(dhw.shape[0])
        return grid_of(dhw, *a, **kw)

    monkeypatch.setattr(bands, "homography_grid", recorded)
    pair_bytes = bands._PLAN_FLOATS_PER_PIXEL * 4 * img * img
    monkeypatch.setattr(bands, "PLAN_STEP_BYTES", 5 * pair_bytes)
    grouped = bands.bands_for_config(ct, img_size=img, device="cpu")
    assert groups == [5] * 14 + [2]
    groups.clear()
    monkeypatch.setattr(bands, "PLAN_STEP_BYTES", 72 * pair_bytes)
    whole = bands.bands_for_config(ct, img_size=img, device="cpu")
    assert groups == [72]
    assert len(ref) == 4 and grouped == whole == ref


def test_planning_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ct = _small(get_config)
    geom = ct.plane_geometry(device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        bands.bands_for_config(ct, img_size=128)
    with pytest.raises(RuntimeError, match="cuda"):
        bands.estimate_bands(geom, ct.camera, ct.fov_deg, 128, 128)
    with pytest.raises(RuntimeError, match="cuda"):
        bands._corner_rays(ct.camera, ct.fov_deg, 128, 128)
    assert len(bands.bands_for_config(ct, img_size=128, device="cpu")) == 4


@pytest.mark.parametrize("img", [64, 128, 256, 384])
def test_planner_and_renderer_share_the_tiling(img, monkeypatch):
    """``required_spans`` measures the warp's bands for the tiles that the
    renderer's banded warp runs (64, 128, 256 and 128 columns wide at these
    image widths), and the adjoint's bands for the texture tiles of its
    tiled adjoint (32 rows): one rule, ``tiled_warp.tiling``."""
    from gmpi_tpu_torch.core import renderer
    from gmpi_tpu_torch.ops import tiled_warp as tw
    from gmpi_tpu_torch.ops import tiled_warp_adjoint as ta

    ct = _small(get_config, n_planes=2)
    geom = ct.plane_geometry(device="cpu")
    rays = bands._corner_rays(ct.camera, ct.fov_deg, img, img, device="cpu")
    seen = {k: set() for k in ("plan", "plan_adjoint", "warp", "adjoint")}

    def recorded(key, fn):
        return lambda *a, tile, **k: seen[key].add(tile) or fn(*a, tile=tile, **k)

    monkeypatch.setattr(bands, "required_bands", recorded("plan", bands.required_bands))
    monkeypatch.setattr(bands, "required_output_bands",
                        recorded("plan_adjoint", bands.required_output_bands))
    spans = bands.required_spans(geom.dhw, rays, img, img)
    coords = tw._tile_coords
    monkeypatch.setattr(tw, "_tile_coords", lambda shape, grid, ac, tile=None:
                        seen["warp"].add(tile) or coords(shape, grid, ac, tile))
    monkeypatch.setattr(ta, "grid_sample_tiled_adjoint",
                        recorded("adjoint", ta.grid_sample_tiled_adjoint))
    ray_dir, eye, z_dir = rays
    grid, _ = renderer.homography_grid(geom.dhw[:1], eye[:1], ray_dir[:1], z_dir[:1])
    x = torch.rand((1, 4, img, img), generator=torch.Generator().manual_seed(img),
                   requires_grad=True)
    renderer._sample(x, grid, True, tuple(b + 8 for b in spans)).sum().backward()
    want = tw.tiling(img, img)
    assert want.tile == (8, {64: 64, 128: 128, 256: 256, 384: 128}[img])
    assert want.adjoint_tile == (32, want.tile[1])
    assert seen == {"plan": {want.tile}, "warp": {want.tile},
                    "plan_adjoint": {want.adjoint_tile}, "adjoint": {want.adjoint_tile}}
