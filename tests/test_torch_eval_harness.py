"""The port's eval harness (``gmpi_tpu_torch/eval/harness.py``) against the
JAX package's, on the CPU.

Both generators hold the same weights (JAX init carried across with
``params_from_jax``) at the FFHQ preset cut to resolution 64, narrow
channels, 4 planes.  The same seed draws different z and views in the two
packages, so both are subclassed to take z and views from one numpy table.
The stub adapters are ``chip_smoke``'s, the feature function a fixed numpy
projection.

Tolerances: ``_save_png`` and ``load_images_chw`` bitwise; dumped PNGs
within 1 level of 255 (renders that agree within 5e-4 can land a level apart
where ``_save_png`` truncates; the share of such pixels is asserted below
1%), depth ``.npy`` within 5e-4, angle ``.npy`` exact; the metrics of both
harnesses on the same directories within 1e-10; the port's fused render at
224^2 against the JAX banded render within 5e-4.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import chip_smoke
from gmpi_tpu.config import get_config as jax_get_config
from gmpi_tpu.eval import harness as jax_harness
from gmpi_tpu.eval.generate import generate_mpi as jax_generate_mpi
from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.eval import harness
from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.ops import fused_render
from tests.test_torch_generator import jax_trees_with_random_leaves, port_generator, small_cfg

TOL = 5e-4
METRIC_TOL = 1e-10
N_SEEDS = 4
RNG = np.random.default_rng(11)
Z = RNG.standard_normal((N_SEEDS, 32)).astype(np.float32)
YAWS = RNG.uniform(-0.5, 0.5, (N_SEEDS, 2, 1)).astype(np.float32)
PITCHES = RNG.uniform(-0.2, 0.2, (N_SEEDS, 2, 1)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxInjected(jax_harness.FakeImageGenerator):
    """The JAX harness with z and views from the tables."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._gen = jax.jit(lambda z: jax_generate_mpi(
            self.gen_cfg, self.params, self.buffers, z, self.xyz_dict, self.n_planes,
            noise_mode="const"))

    def sample_mpi(self, seed, batch=1):
        return self._gen(jnp.asarray(Z[seed:seed + 1]))

    def sample_views(self, seed, n_views):
        return YAWS[seed, :n_views], PITCHES[seed, :n_views]


class Injected(harness.FakeImageGenerator):
    """The port's harness with z and views from the tables."""

    @torch.no_grad()
    def sample_mpi(self, seed, batch=1):
        return generate_mpi(self.G, torch.from_numpy(Z[seed:seed + 1]), self.xyz_dict,
                            self.n_planes, noise_mode="const")

    def sample_views(self, seed, n_views):
        return torch.from_numpy(YAWS[seed, :n_views]), torch.from_numpy(PITCHES[seed, :n_views])


@pytest.fixture(scope="module")
def generators():
    """``{img_size: (JAX generator, port generator)}``: 64^2 (the gather path
    in both) and 224^2 (the banded path in both)."""
    cfg_j, cfg_t = small_cfg(jax_get_config), small_cfg(get_config)
    params, buffers = jax_trees_with_random_leaves(cfg_j.generator_cfg(), seed=5)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    b_j = jax.tree_util.tree_map(jnp.asarray, buffers)
    g_t = port_generator(cfg_t.generator_cfg(), params, buffers)
    return {size: (JaxInjected(cfg_j, p_j, b_j, img_size=size),
                   Injected(cfg_t, g_t, img_size=size, device="cpu"))
            for size in (64, 224)}


def test_save_png_and_load_images_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1.1, 1.1, (3, 3, 10, 12)).astype(np.float32)  # clipped at both ends
    for pkg, sub in ((harness, "a"), (jax_harness, "b")):
        os.makedirs(tmp_path / sub)
        for i, img in enumerate(imgs):
            pkg._save_png(str(tmp_path / sub / f"{i:06d}.png"), img)
    for i in range(3):
        name = f"{i:06d}.png"
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    ours = harness.load_images_chw(str(tmp_path / "a"))
    theirs = jax_harness.load_images_chw(str(tmp_path / "b"))
    assert ours.shape == (3, 3, 10, 12) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    # truncation, not rounding
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "a" / "000000.png")),
        ((imgs[0].transpose(1, 2, 0) + 1) / 2 * 255).clip(0, 255).astype(np.uint8))


@pytest.mark.parametrize("task,size", [("fid_kid", 64), ("consistency", 64),
                                       ("geometry", 224)])
def test_prepare_fake_images_matches_jax(tmp_path, generators, task, size):
    gen_j, gen_t = generators[size]
    n = 2 if size == 224 else N_SEEDS
    harness.prepare_fake_images(gen_t, str(tmp_path / "t"), n, task=task)
    jax_harness.prepare_fake_images(gen_j, str(tmp_path / "j"), n, task=task)
    n_views = 2 if task == "consistency" else 1
    assert len(os.listdir(tmp_path / "t" / "rgb")) == n * n_views
    worst, share = chip_smoke._pngs_apart(str(tmp_path / "t" / "rgb"),
                                          str(tmp_path / "j" / "rgb"))
    assert worst <= 1 and share < 0.01, (worst, share)
    if task == "geometry":
        for i in range(n):
            d_t = np.load(tmp_path / "t" / "depth" / f"{i:06d}.npy")
            d_j = np.load(tmp_path / "j" / "depth" / f"{i:06d}.npy")
            assert d_t.shape == d_j.shape == (size, size) and d_t.dtype == np.float32
            np.testing.assert_allclose(d_t, d_j, rtol=0, atol=TOL)
            a_t = np.load(tmp_path / "t" / "angle" / f"{i:06d}.npy")
            a_j = np.load(tmp_path / "j" / "angle" / f"{i:06d}.npy")
            np.testing.assert_array_equal(a_t, a_j)
            np.testing.assert_array_equal(a_t, [PITCHES[i, 0, 0], YAWS[i, 0, 0]])
    else:
        assert not os.path.exists(tmp_path / "t" / "depth")


def _features(images):
    """A fixed numpy projection of 4x4-pooled images to 8 features."""
    n, c, h, w = images.shape
    pooled = images.reshape(n, c, 4, h // 4, 4, w // 4).mean(axis=(3, 5)).reshape(n, -1)
    proj = np.random.default_rng(3).standard_normal((pooled.shape[1], 8))
    return pooled @ proj


def test_metrics_match_jax_on_the_same_dumps(tmp_path, generators):
    gen_j, _ = generators[64]
    jax_harness.prepare_fake_images(gen_j, str(tmp_path / "fake"), N_SEEDS, task="fid_kid")
    jax_harness.prepare_fake_images(gen_j, str(tmp_path / "cons"), N_SEEDS, task="consistency")
    gen_j224, _ = generators[224]
    jax_harness.prepare_fake_images(gen_j224, str(tmp_path / "geo"), 2, task="geometry")

    class Reals:  # (img_chw in [-1, 1], ...) like a dataset
        def __len__(self):
            return 9

        def __getitem__(self, i):
            rng = np.random.default_rng(100 + i)
            return (rng.uniform(-1, 1, (3, 64, 64)).astype(np.float32), None)

    assert harness.prepare_real_images(Reals(), str(tmp_path / "ra"), 6) == 6
    assert jax_harness.prepare_real_images(Reals(), str(tmp_path / "rb"), 6) == 6
    for name in sorted(os.listdir(tmp_path / "ra")):
        assert (tmp_path / "ra" / name).read_bytes() == (tmp_path / "rb" / name).read_bytes()

    fake = str(tmp_path / "fake" / "rgb")
    for kw in ({}, dict(kid_subset_size=3, kid_subsets=5)):
        ours = harness.compute_fid_kid_dirs(str(tmp_path / "ra"), fake, _features, **kw)
        theirs = jax_harness.compute_fid_kid_dirs(str(tmp_path / "ra"), fake, _features, **kw)
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert np.isfinite(ours[k]) and abs(ours[k] - theirs[k]) <= METRIC_TOL, k
    assert ours["frechet_inception_distance"] > 0

    embed = chip_smoke.StubEmbedder().embed
    ours = harness.compute_consistency_dir(str(tmp_path / "cons"), N_SEEDS, embed)
    theirs = jax_harness.compute_consistency_dir(str(tmp_path / "cons"), N_SEEDS, embed)
    assert sorted(ours) == sorted(theirs) == ["consistency_mean", "consistency_std"]
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= METRIC_TOL

    class Blind(chip_smoke.StubDetector):  # no face in the second image
        def detect(self, img):
            return None if int(img.sum()) % 2 == self.parity else super().detect(img)

    second = np.asarray(Image.open(tmp_path / "geo" / "rgb" / "000001.png"))
    Blind.parity = int(second.sum()) % 2
    for det in (chip_smoke.StubDetector(), Blind()):
        args = (str(tmp_path / "geo"), 2, det, chip_smoke.StubEstimator())
        ours, theirs = harness.compute_geometry_dir(*args), jax_harness.compute_geometry_dir(*args)
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert abs(ours[k] - theirs[k]) <= METRIC_TOL, k
    assert ours["n_skipped"] >= 1 and ours["n_evaluated"] + ours["n_skipped"] == 2


def test_fused_render_at_224_matches_jax_banded(generators):
    """The port's ``use_fused`` route stays fused at 224^2 (ragged tiles);
    the JAX harness takes its banded path there."""
    gen_j, gen_t = generators[224]
    assert gen_j.img_size == 224
    fused = Injected(gen_t.cfg, gen_t.G, img_size=224, use_fused=True, device="cpu")
    assert fused.use_fused and fused.tiled_bands is None
    mpi = fused.sample_mpi(1)
    y, p = YAWS[1], PITCHES[1]
    before = dict(fused_render.LAUNCHES)
    color, depth = fused.render(mpi.expand(2, -1, -1, -1, -1), y, p)
    assert fused_render.LAUNCHES == before  # the CPU runs the plain version
    color_j, depth_j = gen_j.render(jnp.broadcast_to(gen_j.sample_mpi(1), (2, 4, 4, 64, 64)),
                                    y, p)
    assert color.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(color.numpy(), np.asarray(color_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_j), rtol=0, atol=TOL)
