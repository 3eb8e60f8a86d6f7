"""``FakeImageGenerator.sample_mpi`` (``gmpi_tpu_torch/eval/harness.py``): eager
on the CPU, a replayed CUDA graph of the generator on a card.

Imports only torch and the port, so the card's tests run on a machine
without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_sampler_graph.py

On the CPU the sampler must run the generator eagerly, count nothing in
``SAMPLER_GRAPH``, return a tensor of its own each call and equal
``generate_mpi`` on the seed's z.  On the card (``gpu``; skips without one),
at the FFHQ256 preset's full width with seeded weights, on both render routes
and with and without plane chunks: the replays equal eager ``generate_mpi``
on the same z bitwise (the graph launches the kernels eager mode launches, on
the same inputs), an earlier MPI survives later replays, one capture serves
every later call of its key, another truncation psi captures a second
graph, and a weight swap re-captures only where the weights moved.
"""

import collections
import copy

import pytest
import torch

from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.eval.harness import SAMPLER_GRAPH, FakeImageGenerator
from gmpi_tpu_torch.models.generator import Generator
from tests.test_torch_tracing import tiny_config

N_PLANES = 4  # the CPU tests' plane count


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def z_of(gen: FakeImageGenerator, seed: int, batch: int = 1) -> torch.Tensor:
    """The z that ``sample_mpi`` draws for ``seed``, on the host."""
    return torch.randn((batch, gen.cfg.train.z_dim), generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def eager(gen: FakeImageGenerator, seed: int, batch: int = 1) -> torch.Tensor:
    return generate_mpi(gen.G, z_of(gen, seed, batch), gen.xyz_dict, gen.n_planes,
                        chunk_n_planes=gen.chunk, truncation_psi=gen.psi, noise_mode="const")


def tiny_sampler(**kw) -> FakeImageGenerator:
    cfg = tiny_config(32, n_planes=N_PLANES)
    G = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(0))
    return FakeImageGenerator(cfg, G, n_planes=N_PLANES, use_fused=True, device="cpu", **kw)


# -- the CPU: eager, as before ---------------------------------------------------------


def test_cpu_sampler_is_eager_and_counts_no_graph():
    gen = tiny_sampler()
    for seed in range(3):
        gen.sample_mpi(seed)
    assert not SAMPLER_GRAPH and not gen._graphs


def test_consecutive_samples_share_no_storage():
    gen = tiny_sampler()
    first = gen.sample_mpi(0)
    kept = first.clone()
    second = gen.sample_mpi(1)
    assert first.untyped_storage().data_ptr() != second.untyped_storage().data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.parametrize("chunk,psi,batch", [(-1, 1.0, 1), (2, 1.0, 1), (-1, 0.7, 1),
                                             (-1, 1.0, 2)])
def test_sample_equals_generate_mpi_on_the_seeds_z(chunk, psi, batch):
    gen = tiny_sampler(chunk_n_planes=chunk, truncation_psi=psi)
    for seed in (5, 6):
        mpi = gen.sample_mpi(seed, batch=batch)
        assert mpi.shape == (batch, N_PLANES, 4, 32, 32)
        assert torch.equal(mpi, eager(gen, seed, batch))


# -- the card: a replayed graph ---------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ffhq256(cuda):
    cfg = get_config("FFHQ256")
    return cfg, Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(0))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [-1, 24])
@pytest.mark.parametrize("use_fused", [True, False])
def test_replays_equal_eager_and_earlier_samples_survive(cuda, ffhq256, use_fused, chunk):
    """Three seeds in a row: one capture, two replays, each MPI bitwise equal
    to eager ``generate_mpi`` run after all three (so the first survived the
    later replays); then a truncation psi the graph was not captured for
    captures a second graph."""
    cfg, G = ffhq256
    gen = FakeImageGenerator(cfg, copy.deepcopy(G), chunk_n_planes=chunk, use_fused=use_fused,
                             device=cuda)
    before = SAMPLER_GRAPH.copy()
    seeds = (3, 4, 5)
    mpis = [gen.sample_mpi(s) for s in seeds]
    assert SAMPLER_GRAPH - before == collections.Counter(capture=1, replay=len(seeds) - 1)
    assert len({m.untyped_storage().data_ptr() for m in mpis}) == len(seeds)
    for seed, mpi in zip(seeds, mpis):
        assert mpi.shape == (1, cfg.eval_n_planes, 4, cfg.resolution, cfg.resolution)
        assert torch.equal(mpi, eager(gen, seed))

    gen.psi = 0.7
    before = SAMPLER_GRAPH.copy()
    truncated = [gen.sample_mpi(s) for s in seeds[:2]]
    assert SAMPLER_GRAPH - before == collections.Counter(capture=1, replay=1)
    assert len(gen._graphs) == 2
    for seed, mpi in zip(seeds, truncated):
        assert torch.equal(mpi, eager(gen, seed))


@pytest.mark.gpu
def test_weight_swap_recaptures_only_where_the_weights_moved(cuda, ffhq256):
    """A swap in place (``load_state_dict``) replays the graph it has; a
    swap onto other storage (``assign=True``) captures anew.  Either way the
    MPI is the new weights'."""
    cfg, G = ffhq256
    gen = FakeImageGenerator(cfg, copy.deepcopy(G), device=cuda)
    other = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(1)).to(cuda)
    third = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(2)).to(cuda)
    old = gen.sample_mpi(7)

    before = SAMPLER_GRAPH.copy()
    gen.G.load_state_dict(other.state_dict())
    swapped = gen.sample_mpi(7)
    assert SAMPLER_GRAPH - before == collections.Counter(replay=1)
    assert torch.equal(swapped, eager(gen, 7)) and not torch.equal(swapped, old)

    before = SAMPLER_GRAPH.copy()
    gen.G.load_state_dict(third.state_dict(), assign=True)
    assigned = [gen.sample_mpi(s) for s in (7, 8)]
    assert SAMPLER_GRAPH - before == collections.Counter(capture=1, replay=1)
    assert len(gen._graphs) == 1
    for seed, mpi in zip((7, 8), assigned):
        assert torch.equal(mpi, eager(gen, seed))
    assert not torch.equal(assigned[0], swapped)
