"""Port parity: the splat (the warp's transpose) of ``gmpi_tpu_torch``.

On the CPU ``warp_splat`` runs its plain PyTorch version.  It is held against
``jax.vjp`` of the JAX gather warp ``warp_planes`` and against both Pallas
kernels that the one CUDA kernel replaces, run by the interpreter:
``_splat_plane_kernel`` (``_SPLAT_BACKEND="fat"``) and ``_splat_kernel``
(``"classic"``).  Gate: 1e-3 of ``max|ref|``, the JAX package's own for its
splat (its MXU hat-matrix products run at ``bf16x3``); against the fp32 gather
VJP the port is tighter, 1e-4 (the gather warp reaches its texel coordinates
through a UV grid, so tap weights differ in the last fp32 digits).  The
adjoint identity ``<warp(x), g> = <x, splat(g)>`` is checked in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core.renderer import warp_planes as jax_warp_planes
from gmpi_tpu.ops import pallas_warp as pw
from gmpi_tpu_torch.ops import fused_render as fr
from tests.test_torch_fused_render import setup_both

RES = 256


def _fields(n_planes, res=RES, yaw=0.1, pitch=0.05):
    """Same scene in both packages: per-view ray fields and plane tables."""
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(n_planes, res, [yaw], [pitch])
    scal_j = pw.plane_affine(dj, ej[0], res, res)[None]
    rx_j, ry_j, _ = pw.ray_fields(rj, zj)
    scal_t = fr.plane_affine(dt, et, res, res)
    rx_t, ry_t, _ = fr.ray_fields(rt, zt)
    return (dj, rj, ej, zj, scal_j, rx_j, ry_j), (scal_t, rx_t, ry_t)


@pytest.mark.parametrize("backend", ["fat", "classic"])
def test_splat_matches_jax_pallas_kernels(monkeypatch, backend):
    """3 planes at 256^2, one view, each Pallas backend in interpret mode
    with its planned bands."""
    monkeypatch.setattr(pw, "_SPLAT_BACKEND", backend)
    n_l = 3
    (_, _, _, _, scal_j, rx_j, ry_j), (scal_t, rx_t, ry_t) = _fields(n_l)
    g = np.random.default_rng(0).standard_normal((1, n_l, 4, RES, RES)).astype(np.float32)
    plan = pw.plan_fused_render(scal_j, rx_j, ry_j)
    splat = pw.plan_splat(scal_j, ry_j, plan, RES)
    g6 = jnp.transpose(pw.flatten_pixels(jnp.asarray(g)), (0, 3, 1, 2, 4, 5))
    parts = [pw.warp_splat(g6, pw.flatten_pixels(rx_j), pw.flatten_pixels(ry_j), ry_j,
                           scal_j[:, lo:hi], bands, spl, RES, RES, interpret=True, lo=lo)
             for (lo, hi, bands), spl in zip(plan, splat)]
    ref = np.concatenate([np.asarray(p) for p in parts], axis=1)
    out = fr.warp_splat(torch.from_numpy(g), rx_t, ry_t, scal_t, RES, RES).numpy()
    assert out.shape == ref.shape == (1, n_l, 4, RES, RES)
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


def test_splat_matches_vjp_of_jax_gather_warp():
    """5 planes at 64^2 against ``jax.vjp`` of ``warp_planes``: the same taps
    and weights in fp32, 1e-4 of max|ref|."""
    n_l, res = 5, 64
    (dj, rj, ej, zj, _, _, _), (scal_t, rx_t, ry_t) = _fields(n_l, res, yaw=0.5, pitch=-0.2)
    rng = np.random.default_rng(1)
    g = rng.standard_normal((1, n_l, 4, res, res)).astype(np.float32)
    x0 = jnp.asarray(rng.random((n_l, 4, res, res)).astype(np.float32))

    def warp_all(x):
        bc = lambda a: jnp.broadcast_to(a, (n_l,) + a.shape[1:])  # noqa: E731
        rgb, _, alpha = jax_warp_planes(x, dj, bc(ej), bc(rj), bc(zj))
        return jnp.concatenate([rgb, alpha], axis=1)

    _, vjp = jax.vjp(warp_all, x0)
    (ref,) = vjp(jnp.asarray(g[0]))
    out = fr.warp_splat(torch.from_numpy(g), rx_t, ry_t, scal_t, res, res).numpy()[0]
    assert np.abs(out - np.asarray(ref)).max() <= 1e-4 * np.abs(np.asarray(ref)).max()


def test_adjoint_identity_float64_and_dead_slots():
    """``<warp(x), g> = <x, splat(g)>`` in float64 (relative 1e-12), two
    views; and a NaN-poisoned slot at ``l >= n_live`` leaves ``d_tex`` finite
    and that plane's texels exactly zero."""
    n_l, res = 4, 32
    _, (dt, rt, et, zt) = setup_both(n_l, res, [0.5, -0.3], [0.2, -0.1])
    scal = fr.plane_affine(dt, et, res, res).double()
    rx, ry, _ = (a.double() for a in fr.ray_fields(rt, zt))
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((2, n_l, 4, res, res), generator=gen, dtype=torch.float64)
    g = torch.randn((2, n_l, 4, res, res), generator=gen, dtype=torch.float64)
    warped = torch.stack([fr.sample_bilinear(
        x[:, l], scal[:, l, 0, None, None] * rx + scal[:, l, 1, None, None],
        scal[:, l, 2, None, None] * ry + scal[:, l, 3, None, None]) for l in range(n_l)], dim=1)
    lhs = float((warped * g).sum())
    rhs = float((x * fr.warp_splat(g, rx, ry, scal, res, res)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)

    n_live = torch.full((2, res, res), 3, dtype=torch.int32)
    poisoned = g.clone()
    poisoned[:, 3] = float("nan")
    d_tex = fr.warp_splat(poisoned, rx, ry, scal, res, res, n_live=n_live)
    assert torch.isfinite(d_tex).all()
    assert float(d_tex[:, 3].abs().max()) == 0.0
    assert torch.equal(d_tex[:, :3], fr.warp_splat(g, rx, ry, scal, res, res)[:, :3])
