"""Port parity: the texture-space adjoint of the warp in ``gmpi_tpu_torch``.

On the CPU ``warp_adjoint`` runs its plain PyTorch version.  It is held
against the Pallas kernel it replaces (``_adj_kernel`` run by the interpreter,
at the smallest shape its asserts admit), against ``jax.vjp`` of the JAX
gather warp (that kernel's own oracle; 1e-3 absolute) and against the port's
splat (1e-4 of max: the two differ in the last bit of a tap weight).  The CUDA
kernel cannot run here, so its search (a texel tile's image box from
cooperative searches on end rows and columns, the box staged chunk by chunk,
each texel's walk through the staged rows) is repeated in Python, block by
block, and must reproduce the plain version: that is the test of the search
and of what ``plan_adjoint`` checks for it.
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
    bands = fr.plan_adjoint(t(scal), t(rx), t(ry))
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
    bands = fr.plan_adjoint(scal, rx, ry)
    out = fr.warp_adjoint(torch.from_numpy(g), rx, ry, scal, bands, res, res)
    np.testing.assert_allclose(out.numpy()[0], np.asarray(ref), rtol=0, atol=1e-3)
    splat = fr.warp_splat_ref(torch.from_numpy(g), rx, ry, scal, res, res)
    assert float((out - splat).abs().max()) <= 1e-4 * float(splat.abs().max())


def _warp_first(lo, hi, pred, lanes):
    """``warp_first`` of ``csrc/adjoint.cu``: the first n of [lo, hi) with
    pred(n), hi if none, ``lanes`` candidates a step."""
    while lo < hi:
        step = (hi - lo + lanes - 1) // lanes
        cand = [min(lo + (k + 1) * step - 1, hi - 1) for k in range(lanes)]
        hits = [k for k, n in enumerate(cand) if pred(n)]
        if not hits:
            return hi
        lo, hi = lo + hits[0] * step, cand[hits[0]]
    return lo


def _kernel_search_in_python(d_samp, rx, ry, scal, tex_h, tex_w, tile=(32, 16), chunk=(44, 20),
                             lanes=32, vec=True):
    """What ``csrc/adjoint.cu`` does, block by block and thread by thread, in
    float32 numpy: ``(d_tex, the largest number of chunks a block staged)``.
    ``tile`` (texels of a block, x by y), ``chunk`` (staged pixels, columns by
    rows) and ``lanes`` are the kernel's constants, smaller here so that small
    cases reach the multi-step search and the multi-chunk loop."""
    g = d_samp.numpy()
    rx, ry, scal = rx.numpy(), ry.numpy(), scal.numpy()
    v_n, l_n, _, h, w = g.shape
    out = np.zeros((v_n, l_n, 4, tex_h, tex_w), np.float32)
    (tile_x, tile_y), (chunk_w, chunk_h) = tile, chunk
    one, slack, most_chunks = np.float32(1.0), np.float32(1.0 / 64.0), 0
    vec = vec and w % 4 == 0
    for v in range(v_n):
        for l in range(l_n):
            ax, bx, ay, by = scal[v, l, :4]
            with np.errstate(invalid="ignore"):  # the kernel's fmaf: one rounding
                fx = (np.float64(ax) * rx[v].astype(np.float64) + bx).astype(np.float32)
                fy = (np.float64(ay) * ry[v].astype(np.float64) + by).astype(np.float32)
            for u0 in range(0, tex_h, tile_y):
                for x0 in range(0, tex_w, tile_x):
                    # 1. the tile's image box [ia, ib) x [ja, jb)
                    x_lo, x_hi = x0 - one - slack, min(x0 + tile_x, tex_w) + slack
                    u_lo, u_hi = u0 - one - slack, min(u0 + tile_y, tex_h) + slack
                    ia, ib, ja, jb = 0, h, 0, w
                    for _ in range(2):
                        # eight searches at once, all on the box as the round found it
                        cols, rows = [fy[:, ja], fy[:, jb - 1]], [fx[ia], fx[ib - 1]]
                        found = (
                            min(_warp_first(ia, ib, lambda i: not e[i] <= u_lo, lanes)
                                for e in cols),
                            max(_warp_first(ia, ib, lambda i: e[i] >= u_hi, lanes) for e in cols),
                            min(_warp_first(ja, jb, lambda j: not e[j] <= x_lo, lanes)
                                for e in rows),
                            max(_warp_first(ja, jb, lambda j: e[j] >= x_hi, lanes) for e in rows))
                        ia, ib, ja, jb = found
                        if ia >= ib or ja >= jb:
                            break
                    if ia >= ib or ja >= jb:
                        continue  # nothing of the image under this tile: zeros
                    # 2. chunks of the box, in the kernel's order
                    if vec:
                        ja &= ~3
                    chunks = [(ci, min(chunk_h, ib - ci), cj, min(chunk_w, jb - cj))
                              for ci in range(ia, ib, chunk_h) for cj in range(ja, jb, chunk_w)]
                    most_chunks = max(most_chunks, len(chunks))
                    # 3. each thread's walk through the staged rows
                    for u in range(u0, min(u0 + tile_y, tex_h)):
                        for x in range(x0, min(x0 + tile_x, tex_w)):
                            acc = np.zeros(4, np.float32)
                            below, above = np.float32(x - 1), np.float32(x + 1)
                            for ci, nr, cj, nc in chunks:
                                lo, searched = 0, False
                                for r in range(nr):
                                    # rows whose fy, bounded by the staged row's two
                                    # ends, cannot come within a texel of the thread's
                                    # two texel rows (u_a, u_a + 1) are skipped
                                    e0, e1 = fy[ci + r, cj], fy[ci + r, cj + nc - 1]
                                    u_a = u0 + 2 * ((u - u0) // 2)
                                    under, over = u_a - one - slack, u_a + 2 * one + slack
                                    if (e0 <= under and e1 <= under) or \
                                            (e0 >= over and e1 >= over):
                                        continue
                                    row = fx[ci + r, cj:cj + nc]
                                    if not searched:
                                        searched = True
                                        hi = nc
                                        while lo < hi:
                                            mid = (lo + hi) >> 1
                                            if not row[mid] <= below:
                                                hi = mid
                                            else:
                                                lo = mid + 1
                                    else:
                                        while lo > 0 and not row[lo - 1] <= below:
                                            lo -= 1
                                        while lo < nc and not row[lo] > below:
                                            lo += 1
                                    for n in range(lo, nc):
                                        if row[n] >= above:
                                            break
                                        wx = max(0.0, one - abs(row[n] - x))
                                        wgt = wx * max(0.0, one - abs(fy[ci + r, cj + n] - u))
                                        if wgt > 0:
                                            acc += np.float32(wgt) * g[v, l, :, ci + r, cj + n]
                            out[v, l, :, u, x] = acc
    return out, most_chunks


# (image, texture, yaws, pitches, texel tile, staged chunk, lanes, chunks a block must reach)
_SEARCH_CASES = {
    "square_corner": (24, 24, [0.578, 0.0], [0.254, 0.0], (8, 4), (16, 8), 4, 1),
    "minified": (32, 16, [-0.578, 0.0], [0.1, 0.0], (8, 4), (20, 12), 4, 1),
    "magnified": (16, 32, [0.0, 0.0], [-0.254, 0.0], (8, 4), (12, 8), 32, 1),
    "yaw_heavy": (24, 24, [0.9, -0.9], [0.05, 0.0], (8, 8), (16, 12), 4, 1),
    "pitch_heavy": (24, 24, [0.05, 0.0], [0.5, -0.5], (8, 8), (16, 12), 4, 1),
    "box_exceeds_staging": (32, 16, [0.578, -0.3], [-0.254, 0.2], (8, 4), (8, 4), 4, 6),
    "kernel_constants": (72, 40, [0.578, -0.578], [0.254, -0.254], (32, 16), (44, 20), 32, 2),
    "poses_outside_planned_range": (24, 24, [1.2, -1.0], [0.6, -0.5], (8, 4), (12, 8), 4, 1),
    "nan_ray": (24, 24, [0.578, 0.0], [0.254, 0.0], (8, 4), (12, 8), 4, 1),
}


@pytest.mark.parametrize("case", list(_SEARCH_CASES))
def test_kernel_search_with_planned_windows_finds_every_contribution(case):
    """The kernel's search, repeated in Python, equals the plain version (1e-5
    of max): no pixel of any texel's footprint lies outside its tile's box, a
    chunk or the walked range, and none is counted twice.  Magnified and
    minified, yaw-heavy and pitch-heavy, a box larger than the staging chunk,
    the kernel's own tile and chunk sizes, poses outside the range that was
    planned (the plan decides nothing about which pixels are visited), a NaN
    ray (weight 0, and it hides no other pixel); 16-byte and 4-byte staging."""
    res, tex, yaws, pitches, tile, chunk, lanes, want_chunks = _SEARCH_CASES[case]
    _, scal, rx, ry = _port_fields(2, res, yaws, pitches, tex=tex)
    if case == "poses_outside_planned_range":
        _, scal_p, rx_p, ry_p = _port_fields(2, res, [0.1, -0.1], [0.05, -0.05], tex=tex)
        bands = fr.plan_adjoint(scal_p, rx_p, ry_p)
    else:
        bands = fr.plan_adjoint(scal, rx, ry)  # accepts these ray fields
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 2, 4, res, res)).astype(np.float32))
    if case == "nan_ray":
        rx, ry = rx.clone(), ry.clone()
        rx[0, 5, 7] = ry[0, 5, 7] = float("nan")  # inside the image
        rx[1, 0, 0] = float("nan")                # on an end row and column of the searches
        ry[1, res - 1, res - 1] = float("nan")
    ref = fr.warp_adjoint(g, rx, ry, scal, bands, tex, tex).numpy()  # the plain version here
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    for vec in (True, False):
        out, most_chunks = _kernel_search_in_python(g, rx, ry, scal, tex, tex, tile, chunk,
                                                    lanes, vec)
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max(), vec
        assert most_chunks >= want_chunks


def test_plan_adjoint_windows_and_non_monotone_warp():
    """``plan_adjoint`` holds the poses to what the kernel's search needs
    (and measures no windows: the kernel finds its own): the corner poses
    pass, at the image's size and at twice it on the same texture, and give
    the word that ``plan_fused`` hands on; a mirrored ray field (along or
    across image rows and columns, so that ``fx`` or ``fy`` is not monotone)
    and a plane behind the eye raise; ``warp_adjoint`` takes only that
    word."""
    (dt, rt, et, zt), scal, rx, ry = _port_fields(3, 32, [0.578, -0.578, 0.0],
                                                  [0.254, -0.254, 0.0])
    bands = fr.plan_adjoint(scal, rx, ry)
    assert bands == fr.AdjointBands()
    _, scal2, rx2, ry2 = _port_fields(3, 64, [0.578, -0.578, 0.0], [0.254, -0.254, 0.0], tex=32)
    assert fr.plan_adjoint(scal2, rx2, ry2) == bands
    assert fr.plan_adjoint(scal[0], rx[:1], ry[:1]) == bands  # scal [L, 6] for one view
    assert plan_fused(dt, rt, et, zt, 32, 32) == (None, (bands,))
    with pytest.raises(ValueError, match="monotone along"):
        fr.plan_adjoint(scal, rx.flip(2), ry)  # mirrored image columns
    with pytest.raises(ValueError, match="monotone along"):
        fr.plan_adjoint(scal, rx, ry.flip(1))
    bent = rx.clone()
    bent[:, 16:] = bent[:, 16:].flip(1)  # fx rises, then falls, down a column
    with pytest.raises(ValueError, match="monotone across"):
        fr.plan_adjoint(scal, bent, ry)
    with pytest.raises(ValueError, match="behind"):
        fr.plan_adjoint(-scal, rx, ry)
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
    bands = fr.AdjointBands()
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
