"""Port parity: the plain-PyTorch model ops of ``gmpi_tpu_torch`` against
``gmpi_tpu.ops`` on the CPU, float32, inputs from numpy.  Tolerance 1e-5
(fp32 convolutions that differ only in summation order)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmpi_tpu_torch.ops import bias_act as tba
from gmpi_tpu_torch.ops import conv2d as tconv
from gmpi_tpu_torch.ops import modulated_conv as tmod
from gmpi_tpu_torch.ops import upfirdn2d as tup

# gmpi_tpu.ops re-exports functions under its submodules' names
jba, jconv, jmod, jup = (importlib.import_module(f"gmpi_tpu.ops.{m}") for m in (
    "bias_act", "conv2d", "modulated_conv", "upfirdn2d"))
TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(ref, out, tol=TOL):
    ref = np.asarray(ref)
    assert ref.shape == tuple(out.shape)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("act", sorted(tba.activation_funcs))
@pytest.mark.parametrize("clamp", [None, 0.5])
def test_bias_act_matches_jax(act, clamp):
    x = _rng().standard_normal((2, 5, 3, 4)).astype(np.float32)
    b = _rng(1).standard_normal(5).astype(np.float32)
    ref = jba.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, clamp=clamp)
    _close(ref, tba.bias_act(torch.from_numpy(x), torch.from_numpy(b), act=act, clamp=clamp))


@pytest.mark.parametrize("up,down,padding,flip", [
    (1, 1, 0, False), (2, 1, (2, 1, 2, 1), False), (1, 2, (1, 1, 1, 1), True),
    (2, 2, (1, 2, 0, 3), False), (1, 1, (-1, 2, 1, -1), False), ((2, 1), (1, 2), 1, True)])
def test_upfirdn2d_matches_jax(up, down, padding, flip):
    x = _rng().standard_normal((2, 3, 9, 7)).astype(np.float32)
    f = jup.setup_filter([1, 3, 3, 1])
    np.testing.assert_array_equal(f, tup.setup_filter([1, 3, 3, 1]))
    ref = jup.upfirdn2d(jnp.asarray(x), f, up=up, down=down, padding=padding,
                        flip_filter=flip, gain=1.5)
    _close(ref, tup.upfirdn2d(torch.from_numpy(x), f, up=up, down=down, padding=padding,
                              flip_filter=flip, gain=1.5))


@pytest.mark.parametrize("name", ["filter2d", "upsample2d", "downsample2d"])
def test_resample_helpers_match_jax(name):
    x = _rng().standard_normal((1, 2, 8, 8)).astype(np.float32)
    f = tup.setup_filter([1, 2, 1], gain=2.0)
    ref = getattr(jup, name)(jnp.asarray(x), f)
    _close(ref, getattr(tup, name)(torch.from_numpy(x), f))


@pytest.mark.parametrize("up,down,flip_weight", [(1, 1, True), (2, 1, False), (1, 2, True),
                                                 (1, 1, False)])
def test_conv2d_resample_matches_jax(up, down, flip_weight):
    x = _rng().standard_normal((2, 4, 8, 8)).astype(np.float32)
    w = _rng(1).standard_normal((5, 4, 3, 3)).astype(np.float32)
    f = jup.setup_filter([1, 3, 3, 1])
    ref = jconv.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, up=up, down=down,
                                padding=1, flip_weight=flip_weight)
    _close(ref, tconv.conv2d_resample(torch.from_numpy(x), torch.from_numpy(w), f=f, up=up,
                                      down=down, padding=1, flip_weight=flip_weight))


@pytest.mark.parametrize("demodulate,noise,up", [(True, True, 1), (True, False, 2),
                                                 (False, False, 1), (False, True, 1)])
def test_modulated_conv2d_matches_jax(demodulate, noise, up):
    rng = _rng(2)
    x = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 6, 3, 3)).astype(np.float32)
    s = rng.standard_normal((2, 6)).astype(np.float32)
    n = rng.standard_normal((8 * up, 8 * up)).astype(np.float32) if noise else None
    f = jup.setup_filter([1, 3, 3, 1]) if up > 1 else None
    ref = jmod.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                noise=None if n is None else jnp.asarray(n), up=up, padding=1,
                                resample_filter=f, demodulate=demodulate,
                                flip_weight=(up == 1))
    out = tmod.modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
                                noise=None if n is None else torch.from_numpy(n), up=up,
                                padding=1, resample_filter=f, demodulate=demodulate,
                                flip_weight=(up == 1))
    _close(ref, out)


def test_modulated_conv2d_bf16_guard_matches_jax():
    """bf16 activations take the pre-normalization guard; compared in bf16
    at bf16's resolution (8 mantissa bits: 2e-2 relative)."""
    rng = _rng(3)
    x = rng.standard_normal((1, 6, 8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 6, 3, 3)).astype(np.float32)
    s = rng.standard_normal((1, 6)).astype(np.float32)
    ref = jmod.modulated_conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(s),
                                padding=1)
    out = tmod.modulated_conv2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                                torch.from_numpy(s), padding=1)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())
