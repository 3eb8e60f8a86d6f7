"""Port parity: the fused warp+composite forward of ``gmpi_tpu_torch``.

On the CPU ``warp_composite_fwd`` runs its plain PyTorch version; it is held
against the JAX fused renderer (the Pallas kernel in interpret mode, at the
JAX default ``bf16x3`` precision: 5e-4 absolute, the gate of ``bench.py``)
and against both packages' gather renderers.  The CUDA kernel itself is
compared with the plain version by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmpi_tpu.core import camera as jcam
from gmpi_tpu.core import geometry as jgeom
from gmpi_tpu.core import poses as jposes
from gmpi_tpu.core.renderer import plan_fused
from gmpi_tpu.core.renderer import render_mpi as jax_render_mpi
from gmpi_tpu.core.renderer import render_mpi_fused as jax_render_mpi_fused
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import geometry as geom_mod
from gmpi_tpu_torch.core import poses
from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_fused
from gmpi_tpu_torch.ops import fused_render

TOL = 5e-4
GEOM_KW = dict(min_d=0.95, max_d=1.12, distance_sample_method="inverse", fov_deg=12.6,
               sphere_center_z=1.0, sphere_r=1.0, yaw_mean=0.0, yaw_std=0.289,
               pitch_mean=0.0, pitch_std=0.127, n_truncated_stds=2.0, enlarge_factor=1.001,
               confined=True)
CAMERA = (1.0, 1.0, 0.0, 0.289, 0.0, 0.127)


def setup_both(n_planes, res, yaws, pitches):
    """Same geometry and cameras in both packages: (jax, torch) tuples of
    (dhw, ray_dir, eye_pos, z_dir)."""
    y = np.asarray(yaws, np.float32).reshape(-1, 1)
    p = np.asarray(pitches, np.float32).reshape(-1, 1)
    gj = jgeom.build_plane_geometry(n_planes=n_planes, **GEOM_KW)
    gt = geom_mod.build_plane_geometry(n_planes=n_planes, **GEOM_KW, device="cpu")
    c2w_j, _, _ = jposes.sample_sphere_poses(None, len(y), jposes.SphereCameraConfig(*CAMERA),
                                             given_yaws=y, given_pitches=p)
    c2w_t, _, _ = poses.sample_sphere_poses(None, len(y), poses.SphereCameraConfig(*CAMERA),
                                            given_yaws=y, given_pitches=p, device="cpu")
    rj = jcam.generate_rays(jcam.intrinsics_from_fov(12.6, res, res), c2w_j)
    rt = cam.generate_rays(cam.intrinsics_from_fov(12.6, res, res), c2w_t)
    return (gj.dhw,) + tuple(rj), (gt.dhw,) + tuple(rt)


def random_mpi(v, n_planes, res, seed=0, opaque_plane=None):
    rgba = np.random.default_rng(seed).random((v, n_planes, 4, res, res)).astype(np.float32)
    if opaque_plane is not None:
        rgba[:, opaque_plane, 3] = 1.0
    return rgba


def _close(ref, out, tol=TOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=tol)


def test_fused_matches_jax_fused_kernel_interpret():
    """The port's fused render (plain version on the CPU) against the JAX
    Pallas kernel run by the interpreter with its planned bands."""
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(3, 256, [0.1], [0.05])
    rgba = random_mpi(1, 3, 256, seed=11)
    plans = plan_fused(dj, rj, ej, zj, 256, 256)
    ref = jax_render_mpi_fused(jnp.asarray(rgba), dj, rj, ej, zj, plans, interpret=True)
    out = render_mpi_fused(torch.from_numpy(rgba), dt, rt, et, zt, plans=plans)
    for a, b in zip(ref, out):
        _close(a, b)


@pytest.mark.parametrize("opaque_plane", [None, 1])
def test_fused_matches_gather_renderers(opaque_plane):
    """Fused vs the port's and JAX's gather renderers, two views at the
    truncation corners, disparity included; with an opaque mid plane every
    pixel behind it is cut by the early-out."""
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(4, 64, [0.578, -0.578], [0.254, -0.254])
    rgba = random_mpi(2, 4, 64, seed=3, opaque_plane=opaque_plane)
    ref = jax_render_mpi(jnp.asarray(rgba), dj, rj, ej, zj)
    gather = render_mpi(torch.from_numpy(rgba), dt, rt, et, zt)
    fused = render_mpi_fused(torch.from_numpy(rgba), dt, rt, et, zt, with_disp=True)
    for a, b, c in zip(ref, gather, fused):
        _close(a, b)
        _close(a, c)


def test_early_out_changes_nothing_measurable():
    """Early-out skips planes behind T < 1e-6: outputs move by at most the
    remaining weight (1e-6 times the values' scale)."""
    dt, rt, et, zt = setup_both(5, 32, [0.2], [0.1])[1]
    rgba = torch.from_numpy(random_mpi(1, 5, 32, seed=4, opaque_plane=1))
    scal = fused_render.plane_affine(dt, et, 32, 32)
    rx, ry, q = fused_render.ray_fields(rt, zt)
    on = fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, early_out=True)
    off = fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, early_out=False)
    for a, b in zip(on[:-1], off[:-1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    # the opaque plane drives T to ~eps behind it wherever it is hit
    assert float(on[-1].min()) < 1e-6


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    dt, rt, et, zt = setup_both(3, 16, [0.0], [0.0])[1]
    rgba = torch.from_numpy(random_mpi(1, 3, 16, seed=5))
    scal = fused_render.plane_affine(dt, et, 16, 16)
    rx, ry, q = fused_render.ray_fields(rt, zt)
    before = dict(fused_render.LAUNCHES)
    for with_disp in (False, True):
        a = fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, with_disp=with_disp)
        b = fused_render.warp_composite_fwd_ref(rgba, rx, ry, q, scal, with_disp=with_disp)
        assert len(a) == len(b) == 3 + with_disp
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert fused_render.LAUNCHES == before


def test_expanded_mpi_renders_like_a_copy():
    """One MPI expanded over views (stride 0) renders as its materialized copy."""
    dt, rt, et, zt = setup_both(3, 32, [0.3, -0.2, 0.0], [0.1, 0.0, -0.1])[1]
    one = torch.from_numpy(random_mpi(1, 3, 32, seed=6))
    a = render_mpi_fused(one.expand(3, -1, -1, -1, -1), dt, rt, et, zt)
    b = render_mpi_fused(one.repeat(3, 1, 1, 1, 1), dt, rt, et, zt)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n_stacks,n_views", [(4, 4), (1, 4), (2, 4), (2, 6)],
                         ids=["k1", "kV", "k2", "k3"])
@pytest.mark.parametrize("early_out", [True, False, "grad"])
def test_grouped_stacks_render_like_their_repeat(n_stacks, n_views, early_out):
    """``S`` stacks for ``V = S * k`` views (view ``v`` reads stack ``v // k``)
    give exactly what ``repeat_interleave(k)`` of the stacks gives, in
    ``warp_composite_fwd`` (every form) and in ``render_mpi_fused``."""
    yaws = np.linspace(-0.5, 0.5, n_views)
    dt, rt, et, zt = setup_both(3, 32, yaws, yaws[::-1] * 0.4)[1]
    stacks = torch.from_numpy(random_mpi(n_stacks, 3, 32, seed=12, opaque_plane=1))
    repeated = stacks.repeat_interleave(n_views // n_stacks, dim=0)
    scal = fused_render.plane_affine(dt, et, 32, 32)
    rx, ry, q = fused_render.ray_fields(rt, zt)
    kw = dict(early_out=early_out, with_warped=early_out != True)  # noqa: E712
    a = fused_render.warp_composite_fwd(stacks, rx, ry, q, scal, **kw)
    b = fused_render.warp_composite_fwd(repeated, rx, ry, q, scal, **kw)
    assert len(a) == len(b)
    assert all(torch.equal(x.nan_to_num(-7.0), y.nan_to_num(-7.0)) for x, y in zip(a, b))
    if early_out is True:
        c = render_mpi_fused(stacks, dt, rt, et, zt)
        d = render_mpi_fused(repeated, dt, rt, et, zt)
        assert all(torch.equal(x, y) for x, y in zip(c, d))


def test_grouped_stacks_match_jax_fused_kernel_interpret():
    """Two stacks, four views: the port's grouped render against the JAX fused
    kernel (interpret mode) on the repeated stacks, 5e-4."""
    yaws, pitches = [0.1, -0.2, 0.3, 0.0], [0.05, 0.1, -0.1, 0.0]
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(2, 256, yaws, pitches)
    rgba = random_mpi(2, 2, 256, seed=13)
    plans = plan_fused(dj, rj, ej, zj, 256, 256)
    ref = jax_render_mpi_fused(jnp.asarray(np.repeat(rgba, 2, axis=0)), dj, rj, ej, zj, plans,
                               interpret=True)
    out = render_mpi_fused(torch.from_numpy(rgba), dt, rt, et, zt)
    assert out.color.shape == (4, 3, 256, 256)
    for a, b in zip(ref, out):
        _close(a, b)


def test_bad_groupings_raise():
    """Views that are not a multiple of the stacks; a gradient through
    grouped stacks (the Function renders a stack per view)."""
    dt, rt, et, zt = setup_both(2, 16, [0.1, 0.0, -0.1], [0.0, 0.1, 0.0])[1]
    scal = fused_render.plane_affine(dt, et, 16, 16)
    rx, ry, q = fused_render.ray_fields(rt, zt)
    two = torch.from_numpy(random_mpi(2, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        fused_render.warp_composite_fwd(two, rx, ry, q, scal)
    with pytest.raises(ValueError, match="multiple"):
        render_mpi_fused(two, dt, rt, et, zt)
    one = torch.from_numpy(random_mpi(1, 2, 16)).requires_grad_()
    with pytest.raises(ValueError, match="without a\\s+gradient|gradient"):
        render_mpi_fused(one, dt, rt, et, zt)
    # the same stack expanded over its views does carry a gradient
    out = render_mpi_fused(one.expand(3, -1, -1, -1, -1), dt, rt, et, zt)
    (g,) = torch.autograd.grad(out.color.sum(), one)
    assert g.shape == one.shape and torch.isfinite(g).all()


def test_fused_is_forward_only():
    """Without a gradient to compute the fused render is forward only: the
    inference form, whose outputs carry no graph, under ``no_grad`` and for an
    input that requires none.  With one it no longer raises: it returns
    outputs that backpropagate (held against references in
    ``test_torch_fused_grad.py``)."""
    dt, rt, et, zt = setup_both(2, 16, [0.0], [0.0])[1]
    rgba = torch.from_numpy(random_mpi(1, 2, 16))
    plain = render_mpi_fused(rgba, dt, rt, et, zt)
    with torch.no_grad():
        quiet = render_mpi_fused(rgba.clone().requires_grad_(), dt, rt, et, zt)
    assert not plain.color.requires_grad and not quiet.color.requires_grad
    assert torch.equal(plain.color, quiet.color)
    out = render_mpi_fused(rgba.clone().requires_grad_(), dt, rt, et, zt)
    assert out.color.requires_grad and out.depth.requires_grad
    np.testing.assert_allclose(out.color.detach().numpy(), plain.color.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
def test_gather_render_matches_jax(align_corners):
    """The gather path for both coordinate conventions (align_corners=False
    takes the 0.95 narrow-scale rule), one dhw per view."""
    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(3, 32, [0.4, -0.2], [0.1, -0.2])
    rgba = random_mpi(2, 3, 32, seed=8)
    dhw_j = jnp.broadcast_to(dj[None], (2, 3, 3))
    ref = jax_render_mpi(jnp.asarray(rgba), dhw_j, rj, ej, zj, align_corners=align_corners)
    out = render_mpi(torch.from_numpy(rgba), dt[None].expand(2, 3, 3), rt, et, zt,
                     align_corners=align_corners)
    for a, b in zip(ref, out):
        _close(a, b)


@pytest.mark.parametrize("with_disp", [False, True])
def test_slab_partials_match_jax_and_combine(with_disp):
    """Slab partials of two plane slabs match JAX's, and combining them
    front-to-back gives the whole render."""
    from gmpi_tpu.core.renderer import render_slab_partial as jax_slab
    from gmpi_tpu_torch.core.renderer import combine_segments, render_slab_partial

    (dj, rj, ej, zj), (dt, rt, et, zt) = setup_both(4, 32, [0.2], [-0.1])
    rgba = random_mpi(1, 4, 32, seed=9)
    parts = []
    for lo, hi in ((0, 2), (2, 4)):
        ref = jax_slab(jnp.asarray(rgba[:, lo:hi]), dj[lo:hi], rj, ej, zj,
                       with_disp=with_disp)
        out = render_slab_partial(torch.from_numpy(rgba[:, lo:hi]), dt[lo:hi], rt, et, zt,
                                  with_disp=with_disp)
        assert len(ref) == len(out) == 3 + with_disp
        for a, b in zip(ref, out):
            _close(a, b)
        parts.append(out)
    whole = render_mpi(torch.from_numpy(rgba), dt, rt, et, zt)
    combined = combine_segments(*parts)
    _close(whole.color.numpy(), combined[0])
    _close(whole.depth.numpy(), combined[1])
