"""The generator's MPI skip-stack update (``gmpi_tpu_torch/ops/mpi_stack.py``,
K9 ``csrc/mpi_stack.cu``).

Imports only torch and the port, so the card's tests run on a machine
without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_mpi_stack.py

On the CPU: the plain form is bitwise the chain of library ops it took over
from ``SynthesisBlock.forward`` and ``Generator.synthesize`` (``_chain``
below, those lines as they were), in value and gradient, for every kind of
block; the kernel's arithmetic, repeated in Python (``_kernel_in_python``),
equals the plain form within fp32 rounding on an asymmetric filter; the
route is the kernel's exactly where autograd records nothing on a card, and
inputs the kernel cannot take raise there.  On the card (``gpu``; skips without one): the kernel against the plain
form at the presets' serving and training shapes, one launch a block of a
no-gradient generator call and none under autograd, and a replayed sampler
graph bitwise its eager call.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gmpi_tpu_torch.models import generator as gen_mod
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.ops import mpi_stack as ms
from gmpi_tpu_torch.ops.upfirdn2d import setup_filter, upsample2d
from tests.test_torch_tracing import tiny_config

F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(img, single_rgb, background, alpha, resample_filter, n_planes, final_act=None,
           alpha_full=False):
    """The library chain as the generator ran it before the kernel: the
    lines of ``SynthesisBlock.forward`` from the upsample to the add, then at
    the last block those of ``Generator.synthesize`` from the activation to
    the background alpha."""
    bs, _, res, _ = single_rgb.shape
    if img is not None:
        img = upsample2d(img, resample_filter)
    if background is not None:
        fg = single_rgb[:, None].expand(bs, n_planes - 1, 3, res, res)
        cur_rgb = torch.cat([fg.to(background.dtype), background[:, None]], dim=1)
    else:
        cur_rgb = single_rgb[:, None].expand(bs, n_planes, 3, res, res)
    cur_rgb = cur_rgb.reshape(bs * n_planes, 3, res, res)
    if alpha is not None:
        cur_alpha = alpha
    else:
        cur_alpha = torch.zeros((bs * n_planes, 1, res, res), dtype=cur_rgb.dtype,
                                device=cur_rgb.device)
    y = torch.cat([cur_rgb, cur_alpha.to(cur_rgb.dtype)], dim=1)
    y = y.reshape(bs, n_planes * 4, res, res).to(torch.float32)
    img = img + y if img is not None else y
    if final_act is None:
        return img
    if final_act == "none":
        img = (torch.clamp(img, -1.0, 1.0) + 1.0) / 2.0
    elif final_act == "sigmoid":
        img = torch.sigmoid(img)
    elif final_act == "tanh":
        img = (torch.tanh(img) + 1.0) / 2.0
    else:
        raise ValueError(final_act)
    if alpha_full:
        ones = torch.ones_like(img[:, :1])
        img = torch.cat([img[:, :-1], ones], dim=1)
    return img


# name: (stack, background, alpha, head dtype, final_act, alpha_full)
CASES = {
    "first_block": (False, True, True, torch.float32, None, False),
    "no_alpha": (True, True, False, torch.bfloat16, None, False),
    "alpha": (True, True, True, torch.bfloat16, None, False),
    "last_tanh": (True, True, False, torch.bfloat16, "tanh", True),
    "last_sigmoid": (True, True, True, torch.float32, "sigmoid", True),
    "last_none": (True, True, True, torch.bfloat16, "none", True),
    "foreground_only": (True, False, True, torch.bfloat16, "tanh", False),
    "no_background": (True, False, False, torch.float32, "tanh", True),
}


def _inputs(case, bs=2, n_planes=5, res=16, seed=0, device="cpu", requires_grad=False):
    """The case's stack, heads and filter; the background float32 (built from
    the interpolated feature, as the generator's is), the other heads in the
    case's dtype."""
    with_stack, with_bg, with_alpha, dtype, _, _ = CASES[case]
    g = torch.Generator().manual_seed(seed)

    def draw(shape, dt=torch.float32, scale=1.0):
        t = (scale * torch.randn(shape, generator=g)).to(dt).to(device)
        return t.requires_grad_() if requires_grad else t

    stack = draw((bs, n_planes * 4, res // 2, res // 2), scale=2.0) if with_stack else None
    rgb = draw((bs, 3, res, res), dtype)
    background = draw((bs, 3, res, res)) if with_bg else None
    alpha = draw((bs * n_planes, 1, res, res), dtype) if with_alpha else None
    f = torch.from_numpy(setup_filter([1, 3, 3, 1])).to(device)
    return stack, rgb, background, alpha, f


@pytest.mark.parametrize("case", CASES)
def test_plain_form_is_the_chain_it_replaces(case):
    """``mpi_stack_ref`` and the route on the CPU equal the old chain
    bitwise, and so do their gradients with respect to the stack and every
    head."""
    *_, final_act, alpha_full = CASES[case]
    args = _inputs(case, requires_grad=True)
    want = _chain(*args[:4], args[4], 5, final_act, alpha_full)
    got = ms.mpi_stack_ref(*args[:4], args[4], 5, final_act, alpha_full)
    routed = ms.mpi_stack(*args[:4], args[4], 5, final_act, alpha_full)
    assert want.shape == (2, 20, 16, 16) and want.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(routed, want)
    leaves = [t for t in args[:4] if t is not None]
    cot = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    for out in (got, routed):
        grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
        for g_want, g in zip(torch.autograd.grad(want, leaves, cot, retain_graph=True), grads):
            assert torch.equal(g, g_want)


def _kernel_in_python(stack, rgb, background, alpha, f, n_planes, final_act, alpha_full,
                      planes_per_chunk):
    """``csrc/mpi_stack.cu`` repeated with tensors: a thread per (batch,
    channel, row pair m, column quad q), walking its chunk of planes; the
    polyphase taps ``w[py][px][a][b] = 4 f[3 - py - 2a][3 - px - 2b]`` on the
    window of input rows ``m - 1 .. m + 1`` and columns ``2q - 1 .. 2q + 2``
    (zero outside), summed in the kernel's order; the heads widened to fp32
    after the wrapper's narrowing; the activation; plane L - 1's alpha."""
    narrow = (background if background is not None else rgb).dtype
    if narrow == torch.bfloat16:
        rgb = rgb.to(narrow)
        alpha = alpha.to(narrow) if alpha is not None else None
    bs, _, res, _ = rgb.shape
    pairs, quads = res // 2, res // 4
    out = torch.full((bs, n_planes, 4, res, res), float("nan"))
    w = 4.0 * f.flip([0, 1])  # w[ky][kx] = 4 f[3 - ky][3 - kx]
    if stack is not None:
        # [B, L, 4, m, window row i, q, window column j]
        pad = F.pad(stack.reshape(bs, n_planes, 4, pairs, pairs), (1, 1, 1, 1))
        rows = torch.arange(pairs)[:, None] + torch.arange(3)  # padded row m + i
        cols = 2 * torch.arange(quads)[:, None] + torch.arange(4)  # padded column 2q + j
        win = pad[:, :, :, rows][..., cols]  # [B, L, 4, m, 3, q, 4]
    for chunk_start in range(0, n_planes, planes_per_chunk):
        for l in range(chunk_start, min(n_planes, chunk_start + planes_per_chunk)):
            v = torch.zeros((bs, 4, res, res))
            v[:, :3] = (background if background is not None and l == n_planes - 1
                        else rgb).to(torch.float32)
            if alpha is not None:
                v[:, 3] = alpha.reshape(bs, n_planes, res, res)[:, l].to(torch.float32)
            if stack is not None:
                x = win[:, l]  # [B, 4, m, 3, q, 4]
                u = torch.empty((bs, 4, pairs, 2, quads, 4))
                for py in range(2):
                    for k in range(4):
                        px, j = k & 1, (k >> 1) + (k & 1)
                        s = x[:, :, :, py, :, j] * w[py, px]
                        s = s + x[:, :, :, py, :, j + 1] * w[py, px + 2]
                        s = s + x[:, :, :, py + 1, :, j] * w[py + 2, px]
                        u[:, :, :, py, :, k] = s + x[:, :, :, py + 1, :, j + 1] * w[py + 2, px + 2]
                v = u.reshape(bs, 4, res, res) + v
            if final_act is not None:
                v = ms.finish(v, final_act, False)
            if alpha_full and l == n_planes - 1:
                v[:, 3] = 1.0
            out[:, l] = v
    return out.reshape(bs, n_planes * 4, res, res)


@pytest.mark.parametrize("chunk", [1, 2, 5])
@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_matches_plain_form(case, chunk):
    """The kernel's indices, taps and heads, repeated in Python on a filter
    that is neither symmetric nor separable, against the plain form: within
    fp32 rounding of the sums (the kernel adds its four products in another
    order than the convolution), in every plane chunking."""
    *_, final_act, alpha_full = CASES[case]
    stack, rgb, background, alpha, _ = _inputs(case, res=12, seed=3)
    f = torch.arange(1.0, 17.0).reshape(4, 4) ** 1.5
    f = f / f.sum()
    want = ms.mpi_stack_ref(stack, rgb, background, alpha, f, 5, final_act, alpha_full)
    got = _kernel_in_python(stack, rgb, background, alpha, f, 5, final_act, alpha_full, chunk)
    assert float((got - want).abs().max()) <= 8 * F32_EPS * max(1.0, float(want.abs().max()))


def _generator(res=32, n_planes=5, **synthesis):
    """A narrow generator at ``res`` (bf16 in its top two blocks, alpha up to
    half the resolution) and the conditioning grids of ``n_planes``."""
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator

    cfg = tiny_config(res, n_planes=n_planes)
    gcfg = cfg.generator_cfg()
    gcfg = dataclasses.replace(gcfg, synthesis=dataclasses.replace(
        gcfg.synthesis, **{"channel_max": 16, "num_bf16_res": 2,
                           "gen_alpha_largest_res": res // 2, **synthesis}))
    G = Generator(gcfg, generator=torch.Generator().manual_seed(0))
    xyz = FakeImageGenerator(cfg, G, n_planes=n_planes, use_fused=True, device="cpu").xyz_dict
    return G, xyz


def _count_launches(monkeypatch):
    """Take the route's card check as passed and record each would-be launch
    (answered by the plain form)."""
    launched = []

    def launch(*args):
        launched.append(args[1].shape[-1])
        return ms.mpi_stack_ref(*args)

    monkeypatch.setattr(ms, "_on_card", lambda t: True)
    monkeypatch.setattr(ms, "_launch", launch)
    return launched


ROUTES = {"no_grad": True, "inference": True, "params_no_grad": True, "autograd": False,
          "torgba": False}


@pytest.mark.parametrize("case", ROUTES)
def test_the_block_picks_its_route(monkeypatch, case):
    """With the card check passed, a generator call launches once a block
    where autograd records nothing (under ``no_grad``, ``inference_mode``, or
    on parameters that require none) and never under autograd or on the
    ``torgba`` head; its MPI is the plain form's either way."""
    G, xyz = _generator(**({"only_alpha": False, "sep_background": False,
                            "gen_alpha_largest_res": 32} if case == "torgba" else {}))
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(1))
    want = G(z, None, xyz, 5).detach()
    launched = _count_launches(monkeypatch)
    if case == "no_grad":
        with torch.no_grad():
            out = G(z, None, xyz, 5)
    elif case == "inference":
        with torch.inference_mode():
            out = G(z, None, xyz, 5)
    elif case == "params_no_grad":
        out = G.requires_grad_(False)(z, None, xyz, 5)
    else:
        out = G(z, None, xyz, 5)
    assert launched == ([4, 8, 16, 32] if ROUTES[case] else [])  # the blocks' resolutions
    assert torch.equal(out.detach(), want)


def test_route_rule_on_the_inputs(monkeypatch):
    """``takes_kernel``: the kernel on a card where autograd records nothing
    through the inputs, the plain form on the CPU and under autograd.  On a
    card without autograd, inputs the kernel cannot take raise a ValueError
    naming them (a 6-tap filter, float16 heads, a resolution off a multiple
    of four, a float64 stack); the plain form takes them under autograd and
    on the CPU."""
    monkeypatch.setattr(ms, "_on_card", lambda t: True)
    stack, rgb, background, alpha, f = _inputs("alpha")
    assert ms.takes_kernel(stack, rgb, background, alpha)
    assert ms.takes_kernel(None, rgb.float(), None, None)
    assert not ms.takes_kernel(stack, rgb.clone().requires_grad_(), background, alpha)
    with torch.no_grad():
        assert ms.takes_kernel(stack, rgb.clone().requires_grad_(), background, alpha)
    f6 = torch.from_numpy(setup_filter([1, 5, 10, 10, 5, 1]))
    unfit = {
        "resample_filter must be 4 x 4": (stack, rgb, background, alpha, f6),
        "rgb must be float32 or bfloat16": (stack, rgb.half(), background, alpha, f),
        "alpha must be float32 or bfloat16": (stack, rgb, background, alpha.half(), f),
        "multiple of 4, got 14": _inputs("alpha", res=14),
        "stack must be float32": (stack.double(), rgb, background, alpha, f),
    }
    for match, args in unfit.items():
        with pytest.raises(ValueError, match=match):
            ms.mpi_stack(*args, 5)
        grad_args = [t.clone().requires_grad_() if t is not None else None for t in args[:4]]
        out = ms.mpi_stack(*grad_args, args[4], 5)  # under autograd: the plain form
        assert out.requires_grad
    monkeypatch.undo()
    assert not ms.takes_kernel(stack, rgb, background, alpha)  # the CPU
    for args in unfit.values():
        assert torch.equal(ms.mpi_stack(*args, 5), ms.mpi_stack_ref(*args, 5))


def test_generator_values_and_gradients_unchanged(monkeypatch):
    """G's MPI and its parameters' gradients, with bf16 blocks, alpha and
    non-alpha blocks and the background plane, bitwise those of G running
    the old chain in each block (the activation at the last)."""
    G, xyz = _generator()
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(2))

    def run():
        G.zero_grad(set_to_none=True)
        out = G(z, None, xyz, 5)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        return out.detach(), {n: p.grad.clone() for n, p in G.named_parameters()
                              if p.grad is not None}

    out, grads = run()
    monkeypatch.setattr(gen_mod, "mpi_stack", _chain)
    old_out, old_grads = run()
    assert torch.equal(out, old_out) and grads.keys() == old_grads.keys() and len(grads) > 40
    assert all(torch.equal(grads[n], old_grads[n]) for n in grads)


def test_mpi_stack_checks_its_arguments():
    stack, rgb, background, alpha, f = _inputs("alpha")
    with pytest.raises(ValueError, match="alpha"):
        ms.mpi_stack(stack, rgb, background, alpha[:-2], f, 5)
    with pytest.raises(ValueError, match="stack"):
        ms.mpi_stack(stack[:, :-4], rgb, background, alpha, f, 5)
    with pytest.raises(ValueError, match="background"):
        ms.mpi_stack(stack, rgb, background[:1], alpha, f, 5)
    with pytest.raises(ValueError, match="relu"):
        ms.mpi_stack(stack, rgb, background, alpha, f, 5, final_act="relu")
    with pytest.raises(ValueError, match="alpha_full"):
        ms.mpi_stack(stack, rgb, background, alpha, f, 5, alpha_full=True)
    with pytest.raises(ValueError, match="alpha_full"):
        ms.add_to_stack(stack, ms.plane_heads(rgb, background, alpha, 5), f, alpha_full=True)


def test_only_the_last_block_finishes_the_stack():
    """The generator's ``(final_img_act, background_alpha_full)`` goes to
    its last block alone, at construction; a block built otherwise raises."""
    G, _ = _generator()
    blocks = [getattr(G.synthesis, f"b{r}") for r in G.synthesis.cfg.block_resolutions]
    assert [b.finish for b in blocks] == [None] * 3 + [("tanh", True)]
    last, first = blocks[-1].cfg, blocks[0].cfg
    with pytest.raises(ValueError, match="last block"):
        gen_mod.SynthesisBlock(last)
    with pytest.raises(ValueError, match="last block"):
        gen_mod.SynthesisBlock(first, finish=("tanh", True))


def test_plane_chunks_fill_the_card():
    """Chunks only where the pixels give fewer than ``CHUNK_THREADS``
    threads: none at 1024^2, 4 at 512^2, 16 at 256^2 (96 planes, batch 1)."""
    assert ms.plane_chunk(1, 96, 1024) == 96
    assert ms.plane_chunk(1, 96, 512) == 24
    assert ms.plane_chunk(1, 96, 256) == 6
    assert ms.plane_chunk(8, 32, 256) == 16
    assert ms.plane_chunk(1, 96, 4) == 1


# -- the card -------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# name: (batch, planes, resolution, case): the presets' serving blocks at batch 1
# and 96 planes (the FFHQ256 last block with alpha, the 512^2 and 1024^2 blocks
# without), their first and a middle block, and the train steps' shapes
CARD_SHAPES = {
    "serve256_last": (1, 96, 256, "last_sigmoid"),
    "serve512": (1, 96, 512, "no_alpha"),
    "serve1024_last": (1, 96, 1024, "last_tanh"),
    "serve_first": (1, 96, 4, "first_block"),
    "serve64": (1, 96, 64, "alpha"),
    "train256": (8, 32, 256, "last_none"),
    "train512": (4, 32, 512, "foreground_only"),
    "train128": (8, 32, 128, "no_background"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_version(cuda, shape):
    """One launch; within fp32 rounding of the plain form (1e-6 of
    max(1, max|plain|): the four products summed in another order than
    cuDNN's, and ``tanhf``/``expf`` against PyTorch's)."""
    bs, n_planes, res, case = CARD_SHAPES[shape]
    *_, final_act, alpha_full = CASES[case]
    args = _inputs(case, bs=bs, n_planes=n_planes, res=res, seed=res + bs, device=cuda)
    before = ms.LAUNCHES["mpi_stack"]
    with torch.no_grad():
        got = ms.mpi_stack(*args[:4], args[4], n_planes, final_act, alpha_full)
        torch.cuda.synchronize()
        assert ms.LAUNCHES["mpi_stack"] == before + 1
        want = ms.mpi_stack_ref(*args[:4], args[4], n_planes, final_act, alpha_full)
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-6 * scale
    del got, want, args
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_launches_one_a_block_without_gradient_none_under_autograd(cuda):
    G, xyz = _generator(res=64)
    G = G.to(cuda)
    xyz = {r: v.to(cuda) for r, v in xyz.items()}
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(4)).to(cuda)
    before = ms.LAUNCHES["mpi_stack"]
    with torch.no_grad():
        fast = G(z, None, xyz, 5)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["mpi_stack"] == before + 5  # blocks 4 .. 64
    plain = G(z, None, xyz, 5)
    assert plain.requires_grad and ms.LAUNCHES["mpi_stack"] == before + 5
    plain.sum().backward()
    assert float((fast - plain.detach()).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_captured_sampler_replays_its_eager_call_bitwise(cuda):
    """A ``sample_mpi`` replay (K9 captured in the graph) equals the eager
    ``generate_mpi`` of the same z bitwise, chunked and not; the eager call
    before the capture and the capture launch K9 once a block each, the
    replays not at all."""
    from gmpi_tpu_torch.eval.generate import generate_mpi
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator

    cfg = tiny_config(64, n_planes=6)
    G, _ = _generator(res=64, n_planes=6)
    for chunk in (-1, 2):
        gen = FakeImageGenerator(cfg, G.to(cuda), n_planes=6, use_fused=True, device=cuda,
                                 chunk_n_planes=chunk)
        before = ms.LAUNCHES["mpi_stack"]
        first = gen.sample_mpi(11)
        calls = 1 if chunk == -1 else 3 + 1  # foreground chunks of 2, the background call
        assert ms.LAUNCHES["mpi_stack"] == before + 2 * 5 * calls
        for seed in (12, 13):
            z = torch.randn((1, 32), generator=torch.Generator().manual_seed(seed))
            with torch.no_grad():
                eager = generate_mpi(gen.G, z, gen.xyz_dict, 6, chunk_n_planes=gen.chunk,
                                     noise_mode="const")
            launched = ms.LAUNCHES["mpi_stack"]
            replay = gen.sample_mpi(seed)
            assert ms.LAUNCHES["mpi_stack"] == launched
            assert torch.equal(replay, eager)
        assert first.shape == (1, 6, 4, 64, 64)
