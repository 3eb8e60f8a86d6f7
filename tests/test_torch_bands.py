"""Port parity: static band estimation (``gmpi_tpu_torch/core/bands.py``)
gives the JAX package's tuples, as equal ints, on a small config."""

import dataclasses

import numpy as np
import pytest
import torch

from gmpi_tpu.config import get_config as jax_get_config
from gmpi_tpu.core import bands as jbands
from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.core import bands


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(get):
    cfg = get("FFHQ256")
    return dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=3))


def test_corner_rays_match_jax():
    cj, ct = _small(jax_get_config), _small(get_config)
    ref = jbands._corner_rays(cj.camera, cj.fov_deg, 32, 32)
    out = bands._corner_rays(ct.camera, ct.fov_deg, 32, 32)
    assert out[0].shape == (9, 3, 32, 32)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("img,tile", [(128, None), (64, (8, 64))], ids=["128", "64_tile_8x64"])
def test_estimate_bands_equal_jax(img, tile):
    cj, ct = _small(jax_get_config), _small(get_config)
    ref = jbands.estimate_bands(cj.plane_geometry(), cj.camera, cj.fov_deg, img, img, tile=tile)
    out = bands.estimate_bands(ct.plane_geometry(device="cpu"), ct.camera, ct.fov_deg, img, img,
                               tile=tile)
    assert len(out) == 4 and all(isinstance(b, int) for b in out)
    assert out == tuple(int(b) for b in ref)


def test_bands_for_config_equal_jax_and_none_under_128():
    cj, ct = _small(jax_get_config), _small(get_config)
    ref = jbands.bands_for_config(cj, img_size=128, n_planes=2)
    assert bands.bands_for_config(ct, img_size=128, n_planes=2) == tuple(int(b) for b in ref)
    assert bands.bands_for_config(ct, img_size=64) is None
    assert jbands.bands_for_config(cj, img_size=64) is None
