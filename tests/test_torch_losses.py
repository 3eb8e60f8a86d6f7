"""Port parity: the GAN losses and the R1 penalty of ``gmpi_tpu_torch``
against ``gmpi_tpu.train.losses``.

R1 runs on the narrow discriminator of ``test_torch_discriminator.py`` with
weights carried across: the penalty and, through the double backward, its
gradient with respect to every parameter of D must agree within 1e-4 x the
largest reference gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.train import losses as jax_losses
from gmpi_tpu_torch.models.converter import params_from_jax
from gmpi_tpu_torch.train import losses
from tests.test_torch_discriminator import REL_TOL, both_discriminators


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(3)
    r, f = (rng.standard_normal((8, 1)).astype(np.float32) * 3 for _ in range(2))
    ref = jax_losses.d_gan_loss(jnp.asarray(r), jnp.asarray(f))
    out = losses.d_gan_loss(torch.from_numpy(r), torch.from_numpy(f))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    np.testing.assert_allclose(float(losses.g_gan_loss(torch.from_numpy(f))),
                               float(jax_losses.g_gan_loss(jnp.asarray(f))), rtol=1e-6)


def test_r1_penalty_and_its_parameter_gradient_match_jax():
    """R1 against ``gmpi_tpu.train.losses.r1_penalty`` and, through the
    double backward, its gradient with respect to every parameter of D."""
    cfg_j, params, d_t, imgs, pose = both_discriminators()
    pose_j = jnp.asarray(pose)

    def r1_of(p):
        return jax_losses.r1_penalty(lambda im: cfg_j.apply(p, im, pose_j), jnp.asarray(imgs),
                                     10.0)

    ref, ref_grads = jax.value_and_grad(r1_of)(jax.tree_util.tree_map(jnp.asarray, params))
    pose_t = torch.from_numpy(pose)
    r1 = losses.r1_penalty(lambda im: d_t(im, pose_t), torch.from_numpy(imgs), 10.0)
    r1.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(float(r1.detach()), float(ref), rtol=REL_TOL)
    ref_sd = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
    biggest = max(float(v.abs().max()) for v in ref_sd.values())
    for k, p in d_t.named_parameters():
        # a parameter that d score / d image does not depend on has no gradient here
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert float((got - ref_sd[k]).abs().max()) <= REL_TOL * biggest, k
