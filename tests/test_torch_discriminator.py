"""Port parity: the discriminator of ``gmpi_tpu_torch`` against ``gmpi_tpu``.

A narrow JAX discriminator (resolution 32, pose-conditioned) is initialized
by JAX, its biases replaced by numpy draws so that every parameter matters,
and carried into the port with ``params_from_jax``.  The same numpy images
and poses must give the same scores.  Tolerance 1e-4 x max|ref|: two fp32
conv stacks that differ in summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.models.discriminator import DiscriminatorCfg as JaxDiscriminatorCfg
from gmpi_tpu.models.layers import minibatch_std as jax_minibatch_std
from gmpi_tpu_torch.models.converter import params_from_jax
from gmpi_tpu_torch.models.discriminator import Discriminator, DiscriminatorCfg
from gmpi_tpu_torch.models.layers import minibatch_std

REL_TOL = 1e-4
KW = dict(c_dim=16, img_resolution=32, channel_base=512, channel_max=32, cmap_dim=8,
          mbstd_group_size=2, conv_clamp=256.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_disc_params(cfg_j, seed=0):
    params = jax.tree_util.tree_map(np.asarray, jax.jit(cfg_j.init)(jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        if str(path[-1].key) == "bias":
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(perturb, params)


def both_discriminators():
    """(JAX cfg, its params as numpy, the port's module with the same weights,
    images, poses)."""
    cfg_j = JaxDiscriminatorCfg(**KW)
    params = jax_disc_params(cfg_j)
    d_t = Discriminator(DiscriminatorCfg(**KW))
    d_t.load_state_dict(params_from_jax(params), strict=True)
    rng = np.random.default_rng(1)
    imgs = rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    pose = rng.standard_normal((4, 16)).astype(np.float32)
    return cfg_j, params, d_t, imgs, pose


@pytest.fixture(scope="module")
def both():
    return both_discriminators()


def _close(out, ref):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(out) - ref).max() <= REL_TOL * np.abs(ref).max()


def test_state_dict_keys_match_jax_tree(both):
    _, params, d_t, _, _ = both
    sd, own = params_from_jax(params), d_t.state_dict()
    assert sorted(sd) == sorted(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)


def test_scores_match_jax(both):
    cfg_j, params, d_t, imgs, pose = both
    ref = cfg_j.apply(params, jnp.asarray(imgs), jnp.asarray(pose))
    with torch.no_grad():
        out = d_t(torch.from_numpy(imgs), torch.from_numpy(pose))
    assert out.shape == (4, 1)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("group,channels", [(2, 1), (None, 2), (4, 1)])
def test_minibatch_std_matches_jax(group, channels):
    x = np.random.default_rng(2).standard_normal((4, 6, 4, 4)).astype(np.float32)
    ref = jax_minibatch_std(jnp.asarray(x), group, channels)
    out = minibatch_std(torch.from_numpy(x), group, channels)
    assert out.shape == (4, 6 + channels, 4, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_unconditional_and_bf16_variants_run():
    """c_dim=0 drops the pose projection; bf16 top blocks keep a float32
    score close to the float32 network's (bf16 keeps ~3 digits)."""
    kw = dict(KW, c_dim=0)
    g = torch.Generator().manual_seed(0)
    d32 = Discriminator(DiscriminatorCfg(**kw), generator=g)
    d16 = Discriminator(DiscriminatorCfg(**dict(kw, num_bf16_res=2)))
    d16.load_state_dict(d32.state_dict())
    assert not hasattr(d32, "mapping") and d16.b32.cfg.use_bf16 and not d16.b8.cfg.use_bf16
    imgs = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    with torch.no_grad():
        a, b = d32(imgs), d16(imgs)
    assert a.shape == (2, 1) and b.dtype == torch.float32
    assert float((a - b).abs().max()) < 0.1 * max(1.0, float(a.abs().max()))
    with pytest.raises(NotImplementedError):
        Discriminator(DiscriminatorCfg(**dict(kw, architecture="skip")))
