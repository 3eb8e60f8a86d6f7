"""The port's InceptionV3 (``gmpi_tpu_torch/eval/inception.py``) against the
JAX package's, on the CPU.

Weights are drawn with numpy (``random_params``: He-scaled convs, batch-norm
statistics away from the identity) under torchvision names and go through
each package's own loader.  The JAX side runs eagerly: each of its ops
compiles once (~13 s for the whole network, then ~1 s for another input size
or variant) where one ``jit`` of the network takes longer than that per size.

Tolerances: pool3 features within 1e-4 x max|ref| (an input smaller than 299^2
is upsampled, a larger one downsampled with antialiasing, as
``jax.image.resize`` does); single blocks within 1e-5 x max|ref|; state-dict
conversions and loads exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.eval import inception as jax_inception
from gmpi_tpu_torch.eval import inception

FEATURE_TOL = 1e-4
BLOCK_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """With several test workers on one machine, PyTorch's per-process thread
    pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """``(numpy state dict, JAX tree)`` of one seeded weight set."""
    sd = inception.random_params(seed=3)
    return sd, jax_inception.convert_torch_state_dict(sd)


def _port_model(sd, fid_variant):
    model = inception.InceptionV3(fid_variant)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("fid_variant", [True, False])
def test_pool3_features_match_jax(tmp_path, weights, fid_variant):
    sd, tree = weights
    path = str(tmp_path / "inception.npz")
    np.savez(path, **sd)
    model = inception.InceptionV3(fid_variant)
    model.load_state_dict(inception.load_params(path), strict=True)
    rng = np.random.default_rng(5)
    for x in (rng.random((2, 3, 32, 32), np.float32),     # upsampled to 299^2
              rng.random((1, 3, 320, 320), np.float32)):  # downsampled, antialiased
        ref = np.asarray(jax_inception.inception_pool3(tree, jnp.asarray(x), fid_variant))
        with torch.no_grad():
            out = model(torch.from_numpy(x)).numpy()
        assert out.shape == ref.shape == (len(x), 2048)
        assert np.isfinite(ref).all() and ref.std() > 0.1
        err = np.abs(out - ref).max()
        assert err <= FEATURE_TOL * np.abs(ref).max(), (x.shape, err, np.abs(ref).max())


def _block_cases():
    # (block name, constructor, JAX function of (x, params), input channels, size)
    return [
        ("Mixed_5b", lambda: inception.InceptionA(192, 32, fid=True),
         lambda x, p: jax_inception._inception_a(x, p, True), 192, 7),
        ("Mixed_5b", lambda: inception.InceptionA(192, 32, fid=False),
         lambda x, p: jax_inception._inception_a(x, p, False), 192, 7),
        ("Mixed_6b", lambda: inception.InceptionC(768, 128, fid=True),
         lambda x, p: jax_inception._inception_c(x, p, True), 768, 9),
        ("Mixed_7b", lambda: inception.InceptionE(1280, "avg_fid"),
         lambda x, p: jax_inception._inception_e(x, p, "avg_fid"), 1280, 5),
        ("Mixed_7c", lambda: inception.InceptionE(2048, "max"),
         lambda x, p: jax_inception._inception_e(x, p, "max"), 2048, 5),
        ("Mixed_7c", lambda: inception.InceptionE(2048, "avg"),
         lambda x, p: jax_inception._inception_e(x, p, "avg"), 2048, 5),
    ]


@pytest.mark.parametrize("case", range(6))
def test_blocks_match_jax(weights, case):
    """Single blocks at small spatial sizes, the pools' edges included:
    average pools with and without the padding counted, the 3x3 max pool
    padded with -inf (E_2)."""
    sd, tree = weights
    name, make, jax_fn, cin, size = _block_cases()[case]
    block = make()
    prefix = name + "."
    block.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items()
                           if k.startswith(prefix)}, strict=True)
    # inputs below zero too, so a max over padding would differ from one over -inf
    x = np.random.default_rng(case).standard_normal((2, cin, size, size)).astype(np.float32)
    ref = np.asarray(jax_fn(jnp.asarray(x), tree[name]))
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= BLOCK_TOL * np.abs(ref).max()


def test_converter_drops_fc_auxlogits_and_counters(weights):
    sd, _ = weights
    extra = {"fc.weight": np.zeros((1008, 2048), np.float32), "fc.bias": np.zeros(1008),
             "AuxLogits.conv0.conv.weight": np.zeros((128, 768, 1, 1), np.float32),
             "Conv2d_1a_3x3.bn.num_batches_tracked": np.array(7)}
    full = {**sd, **extra}
    ours = inception.convert_torch_state_dict(full)
    theirs = jax_inception.convert_torch_state_dict(full)
    assert sorted(ours) == sorted(sd)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[".".join(prefix + (k,))] = np.asarray(v)

    walk(theirs, ())
    assert sorted(flat) == sorted(ours)
    for k, v in ours.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), flat[k])
    # a torch state dict with tensors converts the same way
    ours_t = inception.convert_torch_state_dict({k: torch.from_numpy(np.asarray(v))
                                                 for k, v in full.items()})
    assert all(torch.equal(ours_t[k], ours[k]) for k in ours)


@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_load_round_trip(tmp_path, weights, suffix):
    sd, _ = weights
    path = str(tmp_path / f"w{suffix}")
    if suffix == ".npz":
        np.savez(path, **sd, **{"fc.weight": np.ones((2, 2), np.float32)})
    else:
        model = _port_model(sd, True)
        torch.save({**model.state_dict(), "fc.bias": torch.zeros(3),
                    "Mixed_5b.branch1x1.bn.num_batches_tracked": torch.tensor(1)}, path)
    loaded = inception.load_params(path)
    assert sorted(loaded) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v)
    model = inception.load_inception(path, fid_variant=False)
    assert not model.fid_variant and not model.training


def test_state_dict_from_jax_is_exact(weights):
    sd, tree = weights
    out = inception.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert sorted(out) == sorted(sd)
    for k, v in sd.items():
        assert out[k].dtype == torch.float32
        np.testing.assert_array_equal(out[k].numpy(), v)
    _port_model({k: v.numpy() for k, v in out.items()}, True)  # loads strictly


def test_feature_fn_batches_like_one_call(weights):
    sd, _ = weights
    model = _port_model(sd, True)
    x = np.random.default_rng(1).random((5, 3, 24, 24), np.float32)
    fn = inception.make_feature_fn(model, batch=2, device="cpu")
    got = fn(x)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    assert got.shape == (5, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            inception.make_feature_fn(model)
