"""Port parity: the fused forward's bf16-texture form (K1,
``compute_dtype=torch.bfloat16``).

On the CPU ``warp_composite_fwd`` runs its plain version, which repeats the
JAX kernel's bf16 arithmetic step for step (bf16 texels, x-hats rounded to
bf16 from fp32, fp32 y-hats and sums; ``fused_render.sample_bilinear``).  It
is held against ``make_fused_renderer(..., compute_dtype=jnp.bfloat16,
interpret=True)`` at 128^2, 2 planes, one view, on a random stack and on one
whose front plane is opaque: the inference form and the training form
within 1e-5 absolute (measured: 3.1e-6; the rest is the order of the JAX
kernel's fp32 sums and rare bf16 ties of a hat), and the ``rgba`` gradient
within 1e-3 of its largest entry (the backward is fp32 in both packages).
Then the train step with ``fused_compute_dtype="bf16"`` at 128^2, 2 planes,
batch 2, held against the JAX step with the same settings (its kernels in
interpret mode, ``precision="bf16x3"``) from the same state on the same
draws (``tests/_torch_jax_step.py``, whose ``BF16_GATES`` state the gates
and what they measure); and, as a further check, every fused render of the
step reads bf16 textures, and its metrics and gradients stay within the bf16
render's error of the fp32 fused step's.  The CUDA kernel's bf16
form is held against this plain version by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core.renderer import plan_fused
from gmpi_tpu.ops.pallas_warp import make_fused_renderer
from gmpi_tpu_torch.core.renderer import render_mpi_fused
from gmpi_tpu_torch.ops import fused_render as fr
from tests.test_torch_fused_render import random_mpi, setup_both

TOL = 1e-5
GRAD_REL = 1e-3
RES, N_PLANES = 128, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(N_PLANES, RES, [0.1], [0.05])
    plans = plan_fused(dj, rj, ej, zj, RES, RES)
    stacks = {"uniform": random_mpi(1, N_PLANES, RES, seed=11),
              "opaque_front": random_mpi(1, N_PLANES, RES, seed=12, opaque_plane=0)}
    scal = fr.plane_affine(dt.float(), et.float(), RES, RES).contiguous()
    rx, ry, q = (a.contiguous() for a in fr.ray_fields(rt.float(), zt.float()))
    return dict(jax=(jnp.asarray(dj), rj, ej, zj), torch=(dt, rt, et, zt), plans=plans,
                stacks=stacks, fields=(rx, ry, q, scal))


def _jax_fn(case, early_out):
    plan, adj = case["plans"]
    return make_fused_renderer(plan, adj, RES, RES, early_out=early_out, interpret=True,
                               precision="bf16x3", compute_dtype=jnp.bfloat16, with_disp=True)


def _close(ref, got, tol=TOL):
    err = float(np.abs(np.asarray(ref) - got.detach().numpy()).max())
    assert err <= tol, err


@pytest.mark.parametrize("stack", ["uniform", "opaque_front"])
def test_inference_form_matches_jax_bf16(case, stack):
    """The inference form: with the transmittance early-out on the uniform
    stack (no pixel gets there), without it behind the opaque plane.  There
    the two early-outs differ by design (the JAX kernel stops a 16-row strip
    once all its pixels are below 1e-6, the port each pixel), and in bf16 by
    more than in fp32: the bf16 hats need not sum to one, so an opaque alpha
    samples up to 2^-8 above 1 and leaves a transmittance of either sign and
    that size, which the port's pixel stops on and the JAX strip may not."""
    rgba = case["stacks"][stack]
    early_out = stack == "uniform"
    ref = _jax_fn(case, early_out)(jnp.asarray(rgba), *case["jax"])  # color, depth, disp, trans
    tex = torch.from_numpy(rgba).to(torch.bfloat16)
    got = fr.warp_composite_fwd(tex, *case["fields"], early_out=early_out, with_disp=True)
    for a, b in zip(ref, got):
        _close(a, b)


@pytest.mark.parametrize("stack", ["uniform", "opaque_front"])
def test_training_form_and_gradient_match_jax_bf16(case, stack):
    """The training form (grad-safe early-out, residual, ``n_live``) gives
    the JAX training forward's outputs; its residual holds the bf16 samples
    of every plane a pixel reached; the gradient through ``render_mpi_fused(
    compute_dtype=torch.bfloat16)`` (fp32 composite backward and splat)
    reaches ``rgba`` in fp32 and matches the JAX VJP."""
    rgba = case["stacks"][stack]
    rng = np.random.default_rng(3)
    cot = (rng.standard_normal((1, 3, RES, RES)).astype(np.float32),
           rng.standard_normal((1, 1, RES, RES)).astype(np.float32))
    fn = _jax_fn(case, False)
    outs, vjp = jax.vjp(lambda x: fn(x, *case["jax"]), jnp.asarray(rgba))
    ref_grad = np.asarray(vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]),
                               jnp.zeros_like(outs[2]), jnp.zeros_like(outs[3])))[0])

    tex = torch.from_numpy(rgba).to(torch.bfloat16)
    *got, warped, n_live = fr.warp_composite_fwd(tex, *case["fields"], early_out="grad",
                                                 with_disp=True, with_warped=True)
    for a, b in zip(outs, got):
        _close(a, b)
    *_, samples = fr.warp_composite_fwd(tex, *case["fields"], early_out=False, with_disp=True,
                                        with_warped=True)
    reached = (torch.arange(N_PLANES)[None, :, None, None, None] < n_live[:, None, None])
    assert bool(reached.any())
    assert torch.equal(warped[reached.expand_as(warped)], samples[reached.expand_as(samples)])

    x = torch.from_numpy(rgba).requires_grad_()
    out = render_mpi_fused(x, *case["torch"], compute_dtype=torch.bfloat16)
    grad, = torch.autograd.grad((out.color * torch.from_numpy(cot[0])).sum()
                                + (out.depth * torch.from_numpy(cot[1])).sum(), x)
    assert grad.dtype == torch.float32
    scale = float(np.abs(ref_grad).max())
    assert float(np.abs(grad.numpy() - ref_grad).max()) <= GRAD_REL * scale


def test_bf16_step_matches_jax_bf16_step():
    """The whole step, fused with bf16 textures, against the JAX step with
    ``use_fused_renderer=True, fused_compute_dtype="bf16"``: metrics, every
    D and G gradient, G's state and EMAs after the update."""
    from tests import _torch_dist_child as child
    from tests import _torch_jax_step as jax_step

    cfg = child.tiny_config(use_fused_renderer=True, fused_compute_dtype="bf16", resolution=128,
                            n_planes=2, batch_size=2)
    cfg_j = jax_step.jax_config(cfg)
    st = jax_step.jax_state(cfg_j)
    real, pose = child.step_batch(cfg)
    ref = jax_step.run_jax_step(cfg_j, st, real, pose)
    state, metrics, grads = child.run_step(cfg, params=jax_step.port_params(st),
                                           draws=jax_step.jax_draws(cfg_j))
    jax_step.assert_step_matches(ref, child.step_record(state, metrics, grads),
                                 **jax_step.BF16_GATES)


def test_bf16_step_reads_bf16_and_tracks_the_fp32_step(monkeypatch):
    """The tiny config's step, fused, with ``fused_compute_dtype="bf16"``:
    every fused forward of the step (D-phase fakes, G phase) gets a bf16
    texture, and metrics and gradients stay within the bf16 render's error
    (~5e-3 of the fp32 render, ``tests/test_pallas_warp.py``'s 2e-2 gate) of
    the fp32 fused step from the same state and generator."""
    from tests import _torch_dist_child as child

    dtypes = []
    wrapped = fr.warp_composite_fwd

    def recording(tex, *a, **kw):
        dtypes.append(tex.dtype)
        return wrapped(tex, *a, **kw)

    monkeypatch.setattr(fr, "warp_composite_fwd", recording)
    _, m32, g32 = child.run_step(child.tiny_config(use_fused_renderer=True))
    assert set(dtypes) == {torch.float32} and len(dtypes) == 2  # D fakes, G phase
    dtypes.clear()
    _, m16, g16 = child.run_step(child.tiny_config(use_fused_renderer=True,
                                                   fused_compute_dtype="bf16"))
    assert set(dtypes) == {torch.bfloat16} and len(dtypes) == 2
    for k in m32:
        assert np.isfinite(m16[k]) and abs(m16[k] - m32[k]) <= 2e-2 * max(1.0, abs(m32[k])), k
    for phase in ("d", "g"):
        biggest = max(float(v.abs().max()) for v in g32[phase].values())
        worst = max(float((g16[phase][k] - v).abs().max()) for k, v in g32[phase].items())
        assert 0 < worst <= 2e-2 * biggest, (phase, worst, biggest)


def test_render_cost_counts_bf16_texel_reads():
    """The bf16 form's model bound: 2 bytes a texel read, 4 for the images."""
    from gmpi_tpu_torch.utils import roofline

    args = (4, 96, 256, 256, 256, 256)
    fp32 = roofline.render_cost(*args, patch_overread=1.0)
    bf16 = roofline.render_cost(*args, patch_overread=1.0, tex_bytes_per_el=2)
    tex, images = 4 * 96 * 4 * 256 * 256, 4 * 4 * 256 * 256
    assert fp32["bytes"] == tex * 4 + images * 4
    assert bf16["bytes"] == tex * 2 + images * 4
    assert bf16["flops"] == fp32["flops"]

