"""Port parity: the texture-space adjoint of the warp in ``gmpi_tpu_torch``.

On the CPU ``warp_adjoint`` runs its plain PyTorch version.  It is held
against the Pallas kernel it replaces (``_adj_kernel`` run by the interpreter,
at the smallest shape its asserts admit), against ``jax.vjp`` of the JAX
gather warp (that kernel's own oracle; 1e-3 absolute) and against the port's
splat (1e-4 of max: the two differ in the last bit of a tap weight).  The CUDA
kernel cannot run here, so its search (window starts, walked window, bisected
axis) is repeated in Python on the same starts and bands and must reproduce
the plain version: that is the test of ``plan_adjoint`` and ``adjoint_starts``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmpi_tpu.core import camera as jcam
from gmpi_tpu.core import poses as jposes
from gmpi_tpu.core.renderer import warp_planes as jax_warp_planes
from gmpi_tpu.ops import pallas_warp as pw
from gmpi_tpu_torch.core.renderer import plan_fused, render_mpi, render_mpi_fused
from gmpi_tpu_torch.ops import fused_render as fr
from tests.test_torch_fused_render import CAMERA, GEOM_KW, setup_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_fields(n_planes, res, yaws, pitches, tex=None):
    tex = tex or res
    _, (dt, rt, et, zt) = setup_both(n_planes, res, yaws, pitches)
    scal = fr.plane_affine(dt, et, tex, tex)
    rx, ry, _ = fr.ray_fields(rt, zt)
    return (dt, rt, et, zt), scal, rx.contiguous(), ry.contiguous()


def test_warp_adjoint_matches_jax_pallas_kernel_interpret():
    """One plane, a 32 x 256 image onto a 16 x 256 texture: the smallest case
    the TPU kernel's asserts admit (strips of 16 texel rows, 128 texel lanes,
    a power-of-two image width of at least 128 + d_v).  1e-4 of max|ref|."""
    import gmpi_tpu.core.geometry as jgeom

    h, w, th, tw = 32, 256, 16, 256
    geom = jgeom.build_plane_geometry(n_planes=1, **GEOM_KW)
    c2w, _, _ = jposes.sample_sphere_poses(
        None, 1, jposes.SphereCameraConfig(*CAMERA), given_yaws=jnp.asarray([[0.1]]),
        given_pitches=jnp.asarray([[0.05]]))
    ray_dir, eye, z_dir = jcam.generate_rays(jcam.intrinsics_from_fov(12.6, h, w), c2w)
    scal = pw.plane_affine(jnp.asarray(geom.dhw), eye[0], th, tw)[None]
    rx, ry, _ = pw.ray_fields(ray_dir, z_dir)
    g = np.random.default_rng(0).standard_normal((1, 1, 4, h, w)).astype(np.float32)
    spans = pw._adjoint_spans(scal, rx, ry, th, tw)
    ref = np.asarray(pw.warp_adjoint(jnp.asarray(g), rx, ry, scal,
                                     pw._adjoint_bands_from_spans(*spans), th, tw,
                                     interpret=True))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    bands = fr.plan_adjoint(t(scal), t(rx), t(ry), th, tw)
    out = fr.warp_adjoint(t(g), t(rx), t(ry), t(scal), bands, th, tw).numpy()
    assert out.shape == ref.shape == (1, 1, 4, th, tw)
    assert np.abs(ref).max() > 0
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_warp_adjoint_matches_vjp_of_jax_gather_warp_and_the_splat():
    """5 planes at 64^2, a corner pose: against ``jax.vjp`` of ``warp_planes``
    (1e-3 absolute, the TPU kernel's own gate) and the port's splat's plain
    version (1e-4 of max)."""
    n_l, res = 5, 64
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(n_l, res, [0.5], [-0.2])
    scal = fr.plane_affine(dt, et, res, res)
    rx, ry, _ = fr.ray_fields(rt, zt)
    rng = np.random.default_rng(1)
    g = rng.standard_normal((1, n_l, 4, res, res)).astype(np.float32)
    x0 = jnp.asarray(rng.random((n_l, 4, res, res)).astype(np.float32))

    def warp_all(x):
        bc = lambda a: jnp.broadcast_to(a, (n_l,) + a.shape[1:])  # noqa: E731
        rgb, _, alpha = jax_warp_planes(x, dj, bc(ej), bc(rj), bc(zj))
        return jnp.concatenate([rgb, alpha], axis=1)

    (ref,) = jax.vjp(warp_all, x0)[1](jnp.asarray(g[0]))
    bands = fr.plan_adjoint(scal, rx, ry, res, res)
    out = fr.warp_adjoint(torch.from_numpy(g), rx, ry, scal, bands, res, res)
    np.testing.assert_allclose(out.numpy()[0], np.asarray(ref), rtol=0, atol=1e-3)
    splat = fr.warp_splat_ref(torch.from_numpy(g), rx, ry, scal, res, res)
    assert float((out - splat).abs().max()) <= 1e-4 * float(splat.abs().max())


def _kernel_search_in_python(d_samp, rx, ry, scal, bands, tex_h, tex_w):
    """What ``csrc/adjoint.cu`` does, thread by thread, in float32 numpy."""
    starts, scan_cols = fr.adjoint_starts(rx, ry, scal, bands, tex_h, tex_w)
    starts, g = starts.numpy(), d_samp.numpy()
    rx, ry, scal = rx.numpy(), ry.numpy(), scal.numpy()
    v_n, l_n, _, h, w = g.shape
    out = np.zeros((v_n, l_n, 4, tex_h, tex_w), np.float32)
    d_out = bands.d_v if scan_cols else bands.d_u
    one = np.float32(1.0)
    for v in range(v_n):
        for l in range(l_n):
            ax, bx, ay, by = scal[v, l, :4]
            fx, fy = ax * rx[v] + bx, ay * ry[v] + by  # [H, W]
            # "o" walked, "i" bisected; index [o, i]
            f_o, f_i, gg = (fx.T, fy.T, g[v, l].transpose(0, 2, 1)) if scan_cols else \
                (fy, fx, g[v, l])
            n_o, n_i = f_o.shape
            for u in range(tex_h):
                for x in range(tex_w):
                    t_o, t_i = (x, u) if scan_cols else (u, x)
                    s = starts[v, l, t_o]
                    acc = np.zeros(4, np.float32)
                    for o in range(s, min(s + d_out, n_o)):
                        lo = int(np.searchsorted(f_i[o], np.float32(t_i - 1), side="right"))
                        for n in range(lo, n_i):
                            if f_i[o, n] >= t_i + 1:
                                break
                            wgt = max(0.0, one - abs(f_i[o, n] - t_i)) * \
                                max(0.0, one - abs(f_o[o, n] - t_o))
                            if wgt > 0:
                                acc += np.float32(wgt) * gg[:, o, n]
                    out[v, l, :, u, x] = acc
    return out


@pytest.mark.parametrize("res,tex,yaw,pitch", [(24, 24, 0.578, 0.254), (32, 16, -0.578, 0.1),
                                               (16, 32, 0.0, -0.254)],
                         ids=["square_corner", "minified", "magnified"])
def test_kernel_search_with_planned_windows_finds_every_contribution(res, tex, yaw, pitch):
    """The kernel's search, repeated in Python with ``plan_adjoint``'s windows
    and ``adjoint_starts``, equals the plain version (1e-5 of max): no pixel
    of any texel's footprint lies outside the walked window or before the
    bisected start.  Both scan directions."""
    _, scal, rx, ry = _port_fields(2, res, [yaw, 0.0], [pitch, 0.0], tex=tex)
    bands = fr.plan_adjoint(scal, rx, ry, tex, tex)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 2, 4, res, res)).astype(np.float32))
    ref = fr.warp_adjoint_ref(g, rx, ry, scal, tex, tex).numpy()
    for b in (bands, fr.AdjointBands(d_u=bands.d_u, d_v=bands.d_u + 1),
              fr.AdjointBands(d_u=bands.d_v + 1, d_v=bands.d_v)):
        out = _kernel_search_in_python(g, rx, ry, scal, b, tex, tex)
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max(), b


def test_plan_adjoint_windows_and_non_monotone_warp():
    (dt, rt, et, zt), scal, rx, ry = _port_fields(3, 32, [0.578, -0.578, 0.0],
                                                  [0.254, -0.254, 0.0])
    bands = fr.plan_adjoint(scal, rx, ry, 32, 32)
    assert isinstance(bands, fr.AdjointBands) and 3 <= bands.d_v <= 32 and 3 <= bands.d_u <= 32
    wider = fr.plan_adjoint(scal, rx, ry, 32, 32, margin=5)
    assert wider == fr.AdjointBands(bands.d_u + 3, bands.d_v + 3)
    # twice the image on the same texture: twice the pixels per texel
    _, scal2, rx2, ry2 = _port_fields(3, 64, [0.578, -0.578, 0.0], [0.254, -0.254, 0.0], tex=32)
    big = fr.plan_adjoint(scal2, rx2, ry2, 32, 32)
    assert big.d_u > bands.d_u and big.d_v > bands.d_v
    assert plan_fused(dt, rt, et, zt, 32, 32) == (None, (bands,))
    with pytest.raises(ValueError, match="monotone"):
        fr.plan_adjoint(scal, rx.flip(2), ry, 32, 32)  # mirrored image columns
    with pytest.raises(ValueError, match="monotone"):
        fr.plan_adjoint(scal, rx, ry.flip(1), 32, 32)
    with pytest.raises(ValueError, match="behind"):
        fr.plan_adjoint(-scal, rx, ry, 32, 32)
    with pytest.raises(ValueError, match="AdjointBands"):
        fr.warp_adjoint(torch.zeros((3, 3, 4, 32, 32)), rx, ry, scal, (4, 4), 32, 32)


def test_warp_adjoint_is_the_transpose_and_ignores_nan_coordinates():
    """``<warp(x), g> = <x, adjoint(g)>`` in float64 (relative 1e-12); a pixel
    whose ray is NaN contributes nothing and poisons nothing."""
    n_l, res = 3, 32
    _, scal, rx, ry = _port_fields(n_l, res, [0.5, -0.3], [0.2, -0.1])
    scal, rx, ry = scal.double(), rx.double(), ry.double()
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((2, n_l, 4, res, res), generator=gen, dtype=torch.float64)
    g = torch.randn((2, n_l, 4, res, res), generator=gen, dtype=torch.float64)
    warped = torch.stack([fr.sample_bilinear(
        x[:, l], scal[:, l, 0, None, None] * rx + scal[:, l, 1, None, None],
        scal[:, l, 2, None, None] * ry + scal[:, l, 3, None, None]) for l in range(n_l)], dim=1)
    bands = fr.AdjointBands(8, 8)
    d_tex = fr.warp_adjoint(g, rx, ry, scal, bands, res, res)
    lhs, rhs = float((warped * g).sum()), float((x * d_tex).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    rx_nan = rx.clone()
    rx_nan[0, 5, 7] = float("nan")
    g_hole = g.clone()
    g_hole[0, :, :, 5, 7] = 0.0
    with_nan = fr.warp_adjoint(g, rx_nan, ry, scal, bands, res, res)
    assert torch.isfinite(with_nan).all()
    assert torch.equal(with_nan, fr.warp_adjoint(g_hole, rx, ry, scal, bands, res, res))


@pytest.mark.parametrize("case", ["random", "opaque_mid", "short_n_live"])
def test_adjoint_route_gives_the_splat_routes_gradient(case):
    """``render_mpi_fused(plans=plan_fused(...))`` takes the adjoint in its
    backward and gives the splat route's ``rgba`` gradient (1e-4 of max) and
    the gather renderer's (1e-3 of max): random planes, two fully opaque mid
    planes (the planes behind them are dead: ``n_live < L``), and nearly
    opaque near planes that end most pixels early."""
    n_l, res = 6, 32
    (dt, rt, et, zt), _, _, _ = _port_fields(n_l, res, [0.5, -0.3], [0.2, -0.1])
    rng = np.random.default_rng(7)
    rgba = rng.random((2, n_l, 4, res, res)).astype(np.float32)
    if case == "opaque_mid":
        rgba[:, 2:4, 3] = 1.0
    if case == "short_n_live":
        rgba[:, :2, 3] = 1.0 - 1e-6 * rng.random((2, 2, res, res)).astype(np.float32)
    cot = [torch.from_numpy(rng.standard_normal((2, c, res, res)).astype(np.float32))
           for c in (3, 1, 1)]
    plans = plan_fused(dt, rt, et, zt, res, res)
    grads = []
    for render, kw in ((render_mpi_fused, dict(plans=plans)), (render_mpi_fused, {}),
                       (render_mpi, {})):
        x = torch.from_numpy(rgba).clone().requires_grad_()
        out = render(x, dt, rt, et, zt, **kw)
        grads.append(torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), x)[0])
    adj, splat, gather = grads
    assert torch.isfinite(adj).all()
    if case != "random":  # the case does end pixels early: n_live < L
        scal = fr.plane_affine(dt, et, res, res)
        n_live = fr.warp_composite_fwd(torch.from_numpy(rgba), *fr.ray_fields(rt, zt), scal,
                                       early_out="grad")[-1]
        assert float((n_live < n_l).float().mean()) > 0.5
    assert float((adj - splat).abs().max()) <= 1e-4 * float(splat.abs().max())
    assert float((adj - gather).abs().max()) <= 1e-3 * float(gather.abs().max())
    with pytest.raises(ValueError, match="one AdjointBands"):
        render_mpi_fused(torch.from_numpy(rgba).requires_grad_(), dt, rt, et, zt,
                         plans=(None, plans[1] * 2))
