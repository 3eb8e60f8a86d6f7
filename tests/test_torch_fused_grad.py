"""Port parity: gradients of the fused renderer of ``gmpi_tpu_torch``.

``render_mpi_fused`` under autograd runs ``FusedRender``: the forward kernel's
training form, then the composite backward and the splat (their plain PyTorch
versions on the CPU, whose dead residual slots hold NaN).  Its ``rgba``
gradient is held against the JAX fused renderer's ``custom_vjp`` (the Pallas
kernels in interpret mode) and against both packages' gather renderers under
autodiff, relative 1e-3 of the largest reference gradient (the gate of
``tests/test_pallas_warp.py``), including behind one and two opaque planes;
the remat and slab forms against ``render_mpi_fused``; and the Function
passes ``gradcheck`` in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core.renderer import plan_fused
from gmpi_tpu.core.renderer import render_mpi_fused as jax_render_mpi_fused
from gmpi_tpu_torch.core.renderer import (combine_segments, make_fused_slab_renderer,
                                          render_mpi, render_mpi_fused,
                                          render_mpi_fused_remat)
from gmpi_tpu_torch.ops import fused_render as fr
from tests.test_torch_fused_render import random_mpi, setup_both

REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny ops: with several test workers on one machine, PyTorch's
    per-process thread pools oversubscribe the cores and crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cotangents(seed, v, res):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((v, c, res, res)).astype(np.float32) for c in (3, 1, 1)]


def _loss_torch(out, cot):
    return sum((o * torch.from_numpy(g)).sum() for o, g in zip(out, cot))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("opaque", [(), (0, 1)], ids=["random", "two_opaque_near_planes"])
def test_fused_grad_matches_jax_fused_vjp_interpret(opaque):
    """L=5, 256^2, one view, cotangents on color, depth and disparity, against
    ``make_fused_renderer(..., interpret=True)``.  Behind two opaque planes
    the port gives exact zeros; the JAX kernel counts live planes per 16-row
    strip, the port per pixel, which moves gradients by O(GRAD_TAU) at most
    (here JAX keeps ~1e-11 where the port has zeros)."""
    n_l, res = 5, 256
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(n_l, res, [0.1], [0.05])
    rgba = random_mpi(1, n_l, res, seed=3)
    for l in opaque:
        rgba[:, l, 3] = 1.0
    cot = _cotangents(4, 1, res)
    plans = plan_fused(dj, rj, ej, zj, res, res)

    def loss_jax(x):
        out = jax_render_mpi_fused(x, dj, rj, ej, zj, plans, interpret=True)
        return sum(jnp.sum(o * jnp.asarray(g)) for o, g in zip(out, cot))

    ref = np.asarray(jax.grad(loss_jax)(jnp.asarray(rgba)))
    x = torch.from_numpy(rgba).requires_grad_()
    (got,) = torch.autograd.grad(_loss_torch(render_mpi_fused(x, dt, rt, et, zt), cot), x)
    assert _rel(got.numpy(), ref) < REL
    if opaque:
        assert float(got[:, 2:].abs().max()) == 0.0 and np.abs(ref[:, 2:]).max() < 1e-9
        assert float(got[:, 0].abs().max()) > 0.0


@pytest.mark.parametrize("case", ["random", "opaque_near_plane", "two_opaque_planes"])
def test_fused_grad_matches_gather_autograd(case):
    """V=2 at the truncation corners against the port's own gather renderer
    under autograd; the opaque near plane is open over its top rows, so
    planes behind it are both hidden and visible."""
    n_l, res = 5, 64
    dt, rt, et, zt = setup_both(n_l, res, [0.578, -0.578], [0.254, -0.254])[1]
    rgba = random_mpi(2, n_l, res, seed=5)
    if case == "opaque_near_plane":
        rgba[:, 0, 3] = 1.0
        rgba[:, 0, 3, :16] = 0.0
    elif case == "two_opaque_planes":
        rgba[:, 1, 3] = 1.0
        rgba[:, 2, 3] = 1.0
    cot = _cotangents(6, 2, res)
    grads = []
    for render in (render_mpi, render_mpi_fused):
        x = torch.from_numpy(rgba).requires_grad_()
        grads.append(torch.autograd.grad(_loss_torch(render(x, dt, rt, et, zt), cot), x)[0])
    assert torch.isfinite(grads[1]).all()
    assert _rel(grads[1].numpy(), grads[0].numpy()) < REL


def test_remat_and_slab_forms_match_fused():
    """``render_mpi_fused_remat`` (slabs of 2 planes under checkpoint) and two
    slab renders combined by hand give ``render_mpi_fused``'s outputs (1e-5)
    and gradients (rel 1e-3), trans cotangent included on the slabs."""
    n_l, res = 5, 32
    dt, rt, et, zt = setup_both(n_l, res, [0.3, -0.2], [0.1, -0.1])[1]
    rgba = random_mpi(2, n_l, res, seed=7, opaque_plane=2)
    cot = _cotangents(8, 2, res)

    def grad_of(render):
        x = torch.from_numpy(rgba).requires_grad_()
        out = render(x)
        return out, torch.autograd.grad(_loss_torch(out, cot), x)[0]

    ref_out, ref_grad = grad_of(lambda x: render_mpi_fused(x, dt, rt, et, zt))
    out, grad = grad_of(lambda x: render_mpi_fused_remat(x, dt, rt, et, zt, plane_chunk=2))
    for a, b in zip(out, ref_out):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-5)
    assert _rel(grad.numpy(), ref_grad.numpy()) < REL

    slab = make_fused_slab_renderer(with_disp=True)

    def by_hand(x):
        front = slab(x[:, :3], dt[:3], rt, et, zt)
        back = slab(x[:, 3:], dt[3:], rt, et, zt)
        assert len(front) == 4  # color, depth, disp, trans
        return combine_segments(front, back)[:3]

    out, grad = grad_of(by_hand)
    for a, b in zip(out, ref_out):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-5)
    assert _rel(grad.numpy(), ref_grad.numpy()) < REL


def test_function_gradcheck_float64():
    """``torch.autograd.gradcheck`` of ``FusedRender`` on an 8x8, 3-plane case
    in float64 through the plain versions, every output's cotangent in play:
    the full check with the grad-safe sparsity, the fast (random projection)
    check without it."""
    dt, rt, et, zt = setup_both(3, 8, [0.3], [0.1])[1]
    scal = fr.plane_affine(dt, et, 8, 8).double()
    rx, ry, q = (a.double() for a in fr.ray_fields(rt, zt))
    tex = torch.from_numpy(random_mpi(1, 3, 8, seed=2) * 0.8 + 0.1).double().requires_grad_()
    for sparsity in (True, False):
        assert torch.autograd.gradcheck(
            lambda t: fr.FusedRender.apply(t, rx, ry, q, scal, True, sparsity), (tex,),
            eps=1e-6, atol=1e-6, fast_mode=not sparsity)


def test_expanded_mpi_and_bf16_input_gradients():
    """One MPI expanded over views gets the sum of the views' gradients
    (autograd's ``expand`` backward), equal to the gradient of a repeat; a
    bf16 ``rgba`` renders in float32 and gets a bf16 gradient back."""
    dt, rt, et, zt = setup_both(3, 16, [0.3, -0.2, 0.0], [0.1, 0.0, -0.1])[1]
    cot = _cotangents(9, 3, 16)
    one = torch.from_numpy(random_mpi(1, 3, 16, seed=6))
    grads = []
    for spread in (lambda t: t.expand(3, -1, -1, -1, -1), lambda t: t.repeat(3, 1, 1, 1, 1)):
        x = one.clone().requires_grad_()
        grads.append(torch.autograd.grad(
            _loss_torch(render_mpi_fused(spread(x), dt, rt, et, zt), cot), x)[0])
    assert grads[0].shape == one.shape
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-5, atol=1e-5)

    x16 = one.to(torch.bfloat16).requires_grad_()
    out = render_mpi_fused(x16.expand(3, -1, -1, -1, -1), dt, rt, et, zt)
    assert out.color.dtype == torch.float32
    (g16,) = torch.autograd.grad(_loss_torch(out, cot), x16)
    assert g16.dtype == torch.bfloat16 and torch.isfinite(g16.float()).all()
