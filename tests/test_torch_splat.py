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

import re
from pathlib import Path

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


# -- the kernel's tiles and texel boxes, repeated in Python -------------------------
# csrc/splat.cu cannot run here.  A block of it takes a tile of pixels of one
# (view, plane), finds the box of texels their live taps reach, sums the taps
# in that box and adds the box into d_tex; a box beyond its shared memory adds
# every tap into d_tex instead.  The repeat below must stay the kernel's (the
# kernel also sums two lanes' taps on one texel before adding them: an order
# of fp32 sums, which the repeat leaves out).

def _kernel_constants():
    src = (Path(fr.__file__).resolve().parent.parent / "csrc" / "splat.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kTileW", "kTileH", "kBoxFloats")}


TILE_W, TILE_H, BOX_FLOATS = 32, 32, 8192


def _tile_boxes(rx, ry, scal, tex_h, tex_w, n_live=None):
    """Yield ``(v, l, tile slices, live mask, (y_lo, bx0, bh, bw))`` for every
    tile with a live tap inside the texture, as the kernel finds its box: the
    taps' extremes clipped to the texture, x aligned down to 4 texels and the
    width rounded up to 4."""
    n_v, n_l = scal.shape[:2]
    h, w = rx.shape[1:]
    for v in range(n_v):
        for l in range(n_l):
            ax, bx, ay, by = (float(x) for x in scal[v, l, :4])
            fx, fy = ax * rx[v] + bx, ay * ry[v] + by
            x0f, y0f = torch.floor(fx), torch.floor(fy)
            need = (x0f >= -1) & (x0f <= tex_w - 1) & (y0f >= -1) & (y0f <= tex_h - 1)
            if n_live is not None:
                need = need & (l < n_live[v])
            for i0 in range(0, h, TILE_H):
                for j0 in range(0, w, TILE_W):
                    sl = (slice(i0, i0 + TILE_H), slice(j0, j0 + TILE_W))
                    nd = need[sl]
                    if not bool(nd.any()):
                        continue
                    x0, y0 = x0f[sl][nd].long(), y0f[sl][nd].long()
                    x_lo, x_hi = int(x0.clamp(min=0).min()), int((x0 + 1).clamp(max=tex_w - 1).max())
                    y_lo, y_hi = int(y0.clamp(min=0).min()), int((y0 + 1).clamp(max=tex_h - 1).max())
                    bx0 = x_lo & ~3
                    yield v, l, sl, nd, (fx, fy), (y_lo, bx0, y_hi + 1 - y_lo,
                                                   (x_hi + 1 - bx0 + 3) & ~3)


def _tile_splat_in_python(d_samp, rx, ry, scal, tex_h, tex_w, n_live=None, boxed=True):
    """Returns d_tex and the number of tiles that summed in their box and that
    added every tap into d_tex."""
    out = torch.zeros(d_samp.shape[:3] + (tex_h, tex_w))
    counts = {"box": 0, "direct": 0}
    for v, l, sl, nd, (fx, fy), (y_lo, bx0, bh, bw) in _tile_boxes(rx, ry, scal, tex_h, tex_w,
                                                                   n_live):
        in_box = boxed and bw * bh * 4 <= BOX_FLOATS
        counts["box" if in_box else "direct"] += 1
        fxs, fys = fx[sl][nd], fy[sl][nd]
        g = d_samp[v, l][:, sl[0], sl[1]][:, nd]
        x0f, y0f = torch.floor(fxs), torch.floor(fys)
        wx, wy = fxs - x0f, fys - y0f
        acc = torch.zeros((4, bh, bw)) if in_box else out[v, l]
        for dy, wgt_y in ((0, 1.0 - wy), (1, wy)):
            for dx, wgt_x in ((0, 1.0 - wx), (1, wx)):
                yy, xx = (y0f + dy).long(), (x0f + dx).long()
                ok = (yy >= 0) & (yy <= tex_h - 1) & (xx >= 0) & (xx <= tex_w - 1)
                yy, xx = yy[ok], xx[ok]
                if in_box:  # every tap lands in the box
                    yy, xx = yy - y_lo, xx - bx0
                    assert bool(((yy >= 0) & (yy < bh) & (xx >= 0) & (xx < bw)).all())
                vals = (wgt_y * wgt_x)[ok] * g[:, ok]
                for c in range(4):
                    acc[c].index_put_((yy, xx), vals[c], accumulate=True)
        if in_box:  # the box into d_tex, its padding columns beyond the texture dropped
            n_x = min(bw, tex_w - bx0)
            out[v, l, :, y_lo:y_lo + bh, bx0:bx0 + n_x] += acc[:, :, :n_x]
    return out, counts


def test_python_repeat_uses_the_kernels_constants():
    assert _kernel_constants() == {"kTileW": TILE_W, "kTileH": TILE_H, "kBoxFloats": BOX_FLOATS}


def test_texel_boxes_fit_at_the_training_poses_and_not_when_magnified():
    """At the FFHQ256 training shapes (32 planes, 256^2, poses at the
    truncation corners and the centre) every tile's box fits the kernel's
    shared memory (the largest is 1848 texels, 29 KB with its four channels),
    so the main path never adds a tap into d_tex directly; a
    texture five times larger than the image (the magnified edge case) does
    not fit and takes the direct path."""
    from gmpi_tpu_torch.config import get_config
    from gmpi_tpu_torch.core import camera as cam
    from gmpi_tpu_torch.core import poses

    cfg = get_config("FFHQ256")
    k, c = cfg.camera.n_truncated_stds, cfg.camera
    yaws = torch.tensor([[k * c.yaw_std], [-k * c.yaw_std], [0.0], [k * c.yaw_std]])
    pitches = torch.tensor([[k * c.pitch_std], [-k * c.pitch_std], [0.0], [-k * c.pitch_std]])
    c2w, _, _ = poses.sample_sphere_poses(None, 4, c, given_yaws=yaws, given_pitches=pitches,
                                          device="cpu")
    for (h, w), (th, tw), fits in (((256, 256), (256, 256), True),
                                   ((64, 96), (300, 520), False)):
        ray_dir, eye, z_dir = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, h, w), c2w)
        scal = fr.plane_affine(cfg.plane_geometry(device="cpu").dhw, eye, th, tw)
        rx, ry, _ = fr.ray_fields(ray_dir, z_dir)
        areas = [bh * bw for *_, (_, _, bh, bw) in _tile_boxes(rx, ry, scal, th, tw)]
        assert areas and (max(areas) * 4 <= BOX_FLOATS) == fits


@pytest.mark.parametrize("tex,tweak", [((48, 40), None), ((131, 200), "direct"),
                                       ((19, 37), "nan"), ((40, 64), "n_live"),
                                       ((240, 200), None)], ids=str)
def test_tile_layout_in_python_matches_plain_version(tex, tweak):
    """The kernel's tiles and boxes reproduce ``warp_splat_ref`` (1e-5 of max:
    another order of fp32 sums): a texture about the image's size, a larger
    one with the direct path forced, a small odd-sized one under a minifying
    warp with NaN rays, ``n_live`` masking with NaN in the dead slots, and a
    magnifying warp whose boxes outgrow the shared memory."""
    th, tw = tex
    n_l, res = 3, 40
    _, (dt, rt, et, zt) = setup_both(n_l, res, [0.5, -0.3], [0.2, -0.1])
    scal = fr.plane_affine(dt, et, th, tw)
    rx, ry, _ = (a.contiguous() for a in fr.ray_fields(rt, zt))
    gen = torch.Generator().manual_seed(4)
    d_samp = torch.randn((2, n_l, 4, res, res), generator=gen)
    n_live = None
    if tweak == "nan":
        rx[0, 5, 7] = ry[0, 5, 7] = ry[1, 9, res // 2] = float("nan")
    if tweak == "n_live":
        n_live = torch.randint(0, n_l + 1, (2, res, res), generator=gen, dtype=torch.int32)
        planes = torch.arange(n_l).reshape(1, n_l, 1, 1, 1)
        d_samp = torch.where(planes < n_live[:, None, None], d_samp, float("nan"))
    out, counts = _tile_splat_in_python(d_samp, rx, ry, scal, th, tw, n_live,
                                        boxed=tweak != "direct")
    ref = fr.warp_splat_ref(d_samp, rx, ry, scal, th, tw, n_live=n_live)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert counts["box" if tweak != "direct" and th < 200 else "direct"] > 0
