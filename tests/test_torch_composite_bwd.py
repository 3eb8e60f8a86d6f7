"""Port parity: the composite backward of ``gmpi_tpu_torch``.

On the CPU ``composite_bwd`` runs its plain PyTorch version.  It is held
against the JAX package's XLA oracle ``composite_bwd`` (1e-4 abs/rel, the
gate of ``tests/test_pallas_warp.py``) and against both Pallas kernels that
the one CUDA kernel replaces, run by the interpreter: ``_composite_bwd_fat_kernel``
(``_COMP_BACKEND="fat"``) and ``_composite_bwd_kernel`` (``"block"``), with
``grad_tau`` and an ``n_live`` mask (2e-5 abs/rel: the same fp32 recurrence in
the same order).  The CUDA kernel itself is compared with the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmpi_tpu.ops import pallas_warp as pw
from gmpi_tpu_torch.ops import fused_render as fr


def _stack(seed, v=2, n_l=7, h=8, w=16, opaque=(2,)):
    rng = np.random.default_rng(seed)
    warped = rng.random((v, n_l, 4, h, w)).astype(np.float32)
    for l in opaque:  # exactly opaque planes mid-stack: the factor is eps = 1e-10
        warped[:, l, 3] = 1.0
    scal = np.zeros((v, n_l, 6), np.float32)
    scal[:, :, 4] = rng.random((v, n_l)).astype(np.float32) + 0.5
    q = rng.random((v, h, w)).astype(np.float32) + 0.9
    cot = [rng.standard_normal((v, 3, h, w)).astype(np.float32)] + [
        rng.standard_normal((v, h, w)).astype(np.float32) for _ in range(3)]
    return warped, q, scal, cot


@pytest.mark.parametrize("with_gd,with_gp,with_gt", [(True, True, True), (False, False, False),
                                                     (True, False, True), (False, True, False)])
def test_composite_bwd_matches_jax_xla_oracle(with_gd, with_gp, with_gt):
    """Every combination of optional cotangents, with an exactly opaque mid
    plane (its alpha gradient is amplified by 1/eps)."""
    warped, q, scal, (gc, gd, gp, gt) = _stack(1)
    gd, gp, gt = (g if on else None for g, on in ((gd, with_gd), (gp, with_gp), (gt, with_gt)))
    dsc = scal[:, :, 4][:, :, None, None]
    ref = pw.composite_bwd(
        jnp.asarray(warped), jnp.asarray(dsc * q[:, None]), jnp.asarray(gc),
        None if gd is None else jnp.asarray(gd), None if gt is None else jnp.asarray(gt),
        g_disp=None if gp is None else jnp.asarray(gp),
        delta_disp=jnp.asarray((1.0 / dsc) / q[:, None]))
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    out = fr.composite_bwd(t(warped), t(q), t(scal), t(gc), t(gd), t(gp), t(gt))
    assert out.shape == (2, 7, 4, 8, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _strip_major(x, ns, r8):
    """[V, (L, C,) NS*R8, 128] row-major pixels -> the Pallas strip-major
    [V, NS, (L, C,) R8, 128]."""
    lead = x.shape[1:-2]
    y = x.reshape(x.shape[0], *lead, ns, r8, 128)
    return np.moveaxis(y, -3, 1)


@pytest.mark.parametrize("backend", ["fat", "block"])
def test_composite_bwd_matches_jax_pallas_kernels(monkeypatch, backend):
    """Against each Pallas backend in interpret mode at v=1, L=5, ns=2,
    r8=32, all cotangents on, ``grad_tau`` and an ``n_live`` mask.  Strip 0
    sits behind two opaque planes, so the forward would have reached 2 planes
    there; the port's dead slots hold NaN (unwritten), JAX's finite garbage."""
    monkeypatch.setattr(pw, "_COMP_BACKEND", backend)
    v, n_l, ns, r8 = 1, 5, 2, 32
    warped, q, scal, (gc, gd, gp, gt) = _stack(0, v, n_l, ns * r8, 128, opaque=())
    warped[:, 0:2, 3, :r8] = 1.0
    n_live = np.array([[2, n_l]], np.int32)
    got = pw.composite_bwd_pallas(
        jnp.asarray(_strip_major(warped, ns, r8)), jnp.asarray(scal),
        jnp.asarray(_strip_major(q, ns, r8)),
        jnp.asarray(np.moveaxis(_strip_major(gc, ns, r8), 1, 2)),
        jnp.asarray(_strip_major(gd, ns, r8)), jnp.asarray(_strip_major(gt, ns, r8)),
        interpret=True, grad_tau=pw.GRAD_TAU, gp=jnp.asarray(_strip_major(gp, ns, r8)),
        n_live=jnp.asarray(n_live))
    if isinstance(got, tuple):
        got = got[0]
    ref = np.moveaxis(np.asarray(got), 1, 3).reshape(v, n_l, 4, ns * r8, 128)

    poisoned = warped.copy()
    poisoned[:, 2:, :, :r8] = np.nan
    n_live_px = np.repeat(n_live, r8, axis=1)[:, :, None].repeat(128, axis=2)
    t = torch.from_numpy
    out = fr.composite_bwd(t(poisoned), t(q), t(scal), t(gc), t(gd), t(gp), t(gt),
                           n_live=t(n_live_px), grad_tau=fr.GRAD_TAU).numpy()
    assert np.isfinite(out).all()
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    assert np.all(out[:, 2:, :, :r8] == 0.0) and np.all(ref[:, 2:, :, :r8] == 0.0)


def test_exact_zeros_behind_two_opaque_planes_and_not_behind_one():
    """S = T / M collapses to ~eps behind TWO opaque planes: exact zeros
    there; behind ONE it stays 1 and the planes behind keep their O(1)
    cotangents (they feed the occluder's alpha gradient)."""
    warped, q, scal, (gc, _, _, _) = _stack(3, v=1, n_l=5, opaque=(0, 1))
    t = torch.from_numpy
    d = fr.composite_bwd(t(warped), t(q), t(scal), t(gc), grad_tau=fr.GRAD_TAU)
    assert float(d[:, 2:].abs().max()) == 0.0
    assert float(d[:, 0].abs().max()) > 0.0
    warped[:, 1, 3] = 0.5
    d = fr.composite_bwd(t(warped), t(q), t(scal), t(gc), grad_tau=fr.GRAD_TAU)
    assert float(d[:, 1, 3].abs().min()) > 0.0
    # the occluder's alpha gradient carries the composite behind it at O(1)
    assert float(d[:, 0, 3].abs().max()) > 1e-2


def test_n_live_needs_grad_tau_and_cpu_launches_nothing():
    warped, q, scal, (gc, _, _, _) = _stack(4, v=1, n_l=3)
    t = torch.from_numpy
    before = dict(fr.LAUNCHES)
    with pytest.raises(ValueError, match="grad_tau"):
        fr.composite_bwd(t(warped), t(q), t(scal), t(gc),
                         n_live=torch.full((1, 8, 16), 3, dtype=torch.int32))
    a = fr.composite_bwd(t(warped), t(q), t(scal), t(gc))
    b = fr.composite_bwd_ref(t(warped), t(q), t(scal), t(gc))
    assert torch.equal(a, b) and fr.LAUNCHES == before
