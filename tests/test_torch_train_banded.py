"""The port's banded train step against the JAX step's banded route, on the
CPU.

With ``use_fused_renderer=False`` at 128^2 both packages plan 4-field tile
bands (``bands_for_config``: the forward's bands and the tiled adjoint's
output bands) and render every view of the step through the tile-banded
warp, whose backward is the scatter-free tiled adjoint
(``ops/tiled_warp.py``, ``ops/tiled_warp_adjoint.py``).  The port's step is
handed the JAX step's draws (``tests/_torch_jax_step.py``) and held to its
whole-step gates.  The step's banded forward takes the warp's taps, the
patch-gather and tap kernels (their plain versions here), which have no
gradient: inside the warp with the tiled adjoint autograd records nothing,
and the values and the ``rgba`` gradient are those of the hats, checked here
against the step's render at the same bands under plain autograd.
"""

import dataclasses

import pytest
import torch

from gmpi_tpu_torch.ops import tiled_warp as tw
from tests import _torch_dist_child as child
from tests import _torch_jax_step as jax_step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _banded_config(**over):
    """The tiny configuration at 128^2 with 2 planes, batch 2, worst views
    rendered at full resolution (so every render of the step is banded)."""
    return child.tiny_config(resolution=128, n_planes=2, batch_size=2, use_fused_renderer=False,
                             worst_view_render_res=0, **over)


def test_banded_step_matches_jax():
    """One whole step (D phase, worst of 2 views, G phase) through the tile
    bands in both packages: metrics, every D and G gradient, G's state and
    EMAs after the update within ``FP32_GATES``."""
    from gmpi_tpu.core.bands import bands_for_config as jax_bands_for_config
    from gmpi_tpu_torch.train import make_train_step

    cfg = _banded_config()
    cfg_j = jax_step.jax_config(cfg)
    assert cfg_j.train.use_fused_renderer is False
    step = make_train_step(cfg, device="cpu")
    assert not step.use_fused
    assert len(step.tiled_bands) == 4
    assert step.tiled_bands == tuple(int(b) for b in jax_bands_for_config(cfg_j))
    st = jax_step.jax_state(cfg_j)
    real, pose = child.step_batch(cfg)
    ref = jax_step.run_jax_step(cfg_j, st, real, pose)
    state, metrics, grads = child.run_step(cfg, params=jax_step.port_params(st),
                                           draws=jax_step.jax_draws(cfg_j))
    jax_step.assert_step_matches(ref, child.step_record(state, metrics, grads),
                                 **jax_step.FP32_GATES)


@pytest.mark.parametrize("plane_chunk", [0, 1], ids=["whole", "slabs"])
def test_step_tiled_warp_taps_match_the_hats(plane_chunk, monkeypatch):
    """The step's banded render (whole, and in plane slabs), whose warp takes
    the taps (the kernels' plain versions here, on textures that record no
    gradient) with the tiled adjoint as its backward, against the same step
    at the same bands without the adjoint fields, whose warp under autograd
    takes the advanced index and the hats and whose backward is autograd's:
    images and ``rgba`` gradients within 1e-6 of max (the same patches and
    the same bilinear sum in another order)."""
    from gmpi_tpu_torch.train import make_train_step

    cfg = _banded_config(renderer_plane_chunk=plane_chunk)
    step = make_train_step(cfg, device="cpu")
    rng = torch.Generator().manual_seed(0)
    mpi = torch.rand((2, 2, 4, 128, 128), generator=rng)
    cot = torch.randn((2, 3, 128, 128), generator=rng)
    yaws, pitches = torch.tensor([[0.5], [-0.3]]), torch.tensor([[0.2], [-0.1]])
    gathered, gather = [], tw.gather_patches

    def recorded(texf, *a, **kw):
        gathered.append(texf.requires_grad)
        return gather(texf, *a, **kw)

    monkeypatch.setattr(tw, "gather_patches", recorded)
    out = {}
    for route, bands in (("taps", step.tiled_bands), ("hats", step.tiled_bands[:2])):
        step.tiled_bands = bands
        x = mpi.clone().requires_grad_()
        imgs, _, _ = step.render_views(x, yaws, pitches)
        out[route] = imgs.detach(), torch.autograd.grad((imgs * cot).sum(), x)[0]
        if route == "taps":
            n_taps = len(gathered)
    assert n_taps and len(gathered) == n_taps and not any(gathered)  # none on the hats
    for hats, taps in zip(out["hats"], out["taps"]):
        assert float((hats - taps).abs().max()) <= 1e-6 * float(hats.abs().max())
    assert float(out["taps"][1].abs().max()) > 0


def test_two_field_bands_on_a_card_raise(monkeypatch):
    """Where the planned bands have 2 fields (a warp not monotone over the
    pose range: no tiled adjoint), a banded step on a card refuses to build,
    since the patch-gather kernel has no gradient; on the CPU the same bands
    build, and the step's render under autograd takes the hats.  The card
    and the plan are stood in for."""
    from gmpi_tpu_torch.train import step as step_mod

    cfg = _banded_config()
    monkeypatch.setattr(step_mod, "bands_for_config", lambda cfg, device: (32, 160))
    step = step_mod.TrainStep(cfg, device="cpu")
    assert step.tiled_bands == (32, 160)
    taken, hats = [], tw._sample_hats
    monkeypatch.setattr(tw, "_sample_hats", lambda *a, **k: taken.append(1) or hats(*a, **k))
    x = torch.rand((1, 2, 4, 128, 128), generator=torch.Generator().manual_seed(1))
    imgs, _, _ = step.render_views(x.requires_grad_(), torch.tensor([[0.1]]),
                                   torch.tensor([[0.05]]))
    assert taken and imgs.requires_grad
    monkeypatch.setattr(step_mod, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="needs 4-field bands"):
        step_mod.TrainStep(cfg, device="cuda")
