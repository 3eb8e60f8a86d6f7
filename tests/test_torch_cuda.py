"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it runs on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

Without a CUDA card every test skips.  Tolerance 1e-4 (absolute for the
forward, whose outputs are O(1); relative to max|plain| per field for the
backward kernels, whose alpha cotangent reaches 1e10 behind an opaque plane):
a kernel and its plain version evaluate the same fp32 formula and differ in
FMA contraction and, for the splat, in the order of its atomic sums.
"""

import dataclasses

import pytest
import torch

from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses
from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_fused
from gmpi_tpu_torch.ops import fused_render

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(dev, n_planes, res, yaws, pitches):
    cfg = get_config("FFHQ256")
    cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_planes))
    geom = cfg.plane_geometry(device=dev)
    c2w, _, _ = poses.sample_sphere_poses(None, len(yaws), cfg.camera, given_yaws=yaws,
                                          given_pitches=pitches, device=dev)
    return geom, cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, res, res), c2w)


@pytest.mark.gpu
@pytest.mark.parametrize("with_disp", [False, True])
@pytest.mark.parametrize("opaque", [None, 3])
def test_fused_fwd_kernel_matches_plain_version(cuda, with_disp, opaque):
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 8, 128, [0.5, -0.1], [0.2, 0.0])
    rgba = torch.rand((2, 8, 4, 128, 128), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(7))
    if opaque is not None:
        rgba[:, opaque, 3] = 1.0
    scal = fused_render.plane_affine(geom.dhw, eye, 128, 128).contiguous()
    rx, ry, q = (x.contiguous() for x in fused_render.ray_fields(ray_dir, z_dir))
    before = dict(fused_render.LAUNCHES)
    out = fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, with_disp=with_disp)
    ref = fused_render.warp_composite_fwd_ref(rgba, rx, ry, q, scal, with_disp=with_disp)
    torch.cuda.synchronize()
    assert fused_render.LAUNCHES["fused_fwd"] == before["fused_fwd"] + 1
    assert len(out) == len(ref) == 3 + with_disp
    for a, b in zip(out, ref):
        assert float((a - b).abs().max()) <= TOL


@pytest.mark.gpu
def test_fused_render_matches_gather_on_the_card(cuda):
    """Expanded MPI, non-square output: fused kernel vs the gather renderer
    (5e-4, the renderer gate)."""
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 6, 64, [0.3, -0.5, 0.0], [-0.2, 0.1, 0.0])
    mpi = torch.rand((1, 6, 4, 64, 64), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    mpi_v = mpi.expand(3, -1, -1, -1, -1)
    fused = render_mpi_fused(mpi_v, geom.dhw, ray_dir, eye, z_dir)
    gather = render_mpi(mpi_v, geom.dhw, ray_dir, eye, z_dir)
    for a, b in zip(fused, gather):
        assert float((a - b).abs().max()) <= 5e-4


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 2, 16, [0.0], [0.0])
    scal = fused_render.plane_affine(geom.dhw, eye, 16, 16).contiguous()
    rx, ry, q = (x.contiguous() for x in fused_render.ray_fields(ray_dir, z_dir))
    tex = torch.rand((1, 2, 4, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        fused_render.warp_composite_fwd(tex.double(), rx, ry, q, scal)
    with pytest.raises(ValueError):
        fused_render.warp_composite_fwd(tex, rx, ry, q, scal[:, :1].contiguous())
    with pytest.raises(ValueError):
        fused_render.warp_composite_fwd(tex, rx.transpose(1, 2).contiguous().transpose(1, 2), ry, q, scal)


@pytest.mark.gpu
def test_view_stride_is_zero_or_at_least_one_stack(cuda):
    """A slab of a parent stack (view stride larger than the slab) renders as
    its packed copy does; views that overlap in memory are refused."""
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 2, 16, [0.3, -0.2], [0.0, 0.1])
    scal = fused_render.plane_affine(geom.dhw, eye, 16, 16).contiguous()
    rx, ry, q = (x.contiguous() for x in fused_render.ray_fields(ray_dir, z_dir))
    parent = torch.rand((2, 4, 4, 16, 16), device=cuda)
    slab = parent[:, 1:3]
    assert slab.stride(0) == 2 * slab[0].numel()
    for a, b in zip(fused_render.warp_composite_fwd(slab, rx, ry, q, scal),
                    fused_render.warp_composite_fwd(slab.contiguous(), rx, ry, q, scal)):
        assert torch.equal(a, b)
    overlapping = parent.as_strided((2, 2, 4, 16, 16), (1024, 1024, 256, 16, 1))
    with pytest.raises(ValueError, match="view stride"):
        fused_render.warp_composite_fwd(overlapping, rx, ry, q, scal)


def _training_case(cuda, opaque):
    """V=3, L=8, 128^2: residual and n_live from the forward kernel's training
    form, dead residual slots NaN-poisoned, random cotangents."""
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 8, 128, [0.5, -0.1, 0.0], [0.2, 0.0, -0.25])
    g = torch.Generator(device=cuda).manual_seed(11)
    rgba = torch.rand((3, 8, 4, 128, 128), device=cuda, generator=g)
    for l in opaque:
        rgba[:, l, 3] = 1.0
    scal = fused_render.plane_affine(geom.dhw, eye, 128, 128).contiguous()
    rx, ry, q = (x.contiguous() for x in fused_render.ray_fields(ray_dir, z_dir))
    out = fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, early_out="grad",
                                          with_disp=True, with_warped=True)
    ref = fused_render.warp_composite_fwd_ref(rgba, rx, ry, q, scal, early_out="grad",
                                              with_disp=True, with_warped=True)
    planes = torch.arange(8, device=cuda).reshape(1, 8, 1, 1, 1)
    warped = torch.where(planes < out[-1][:, None, None], out[-2], float("nan"))
    cot = [torch.randn((3, 3, 128, 128), device=cuda, generator=g)] + [
        torch.randn((3, 128, 128), device=cuda, generator=g) for _ in range(3)]
    return rgba, (rx, ry, q, scal), out, ref, warped, cot


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("opaque", [(), (3,), (2, 3)], ids=["random", "one_opaque", "two_opaque"])
def test_training_form_and_backward_kernels_match_plain_versions(cuda, opaque):
    _, (rx, ry, q, scal), out, ref, warped, (gc, gd, gp, gt) = _training_case(cuda, opaque)
    n_live, n_live_ref = out[-1], ref[-1]
    assert int((n_live - n_live_ref).abs().max()) <= 1
    assert float((n_live != n_live_ref).float().mean()) <= 1e-4
    if len(opaque) == 2:
        # S / M collapses behind the second opaque plane wherever both are hit
        assert int(n_live.min()) == 4 and float((n_live == 4).float().mean()) > 0.5
    for a, b in zip(out[:4], ref[:4]):
        assert float((a - b).abs().max()) <= TOL
    planes = torch.arange(8, device=cuda).reshape(1, 8, 1, 1, 1)
    both = planes < torch.minimum(n_live, n_live_ref)[:, None, None]
    assert float(torch.where(both, out[-2] - ref[-2], 0.0).abs().max()) <= TOL

    before = dict(fused_render.LAUNCHES)
    for opt in ((None, None, None), (gd, gp, gt)):
        kw = dict(n_live=n_live, grad_tau=fused_render.GRAD_TAU)
        d_samp = fused_render.composite_bwd(warped, q, scal, gc, *opt, **kw)
        d_ref = fused_render.composite_bwd_ref(warped, q, scal, gc, *opt, **kw)
        assert torch.isfinite(d_samp).all()
        assert _rel(d_samp[:, :, :3], d_ref[:, :, :3]) <= TOL
        assert _rel(d_samp[:, :, 3], d_ref[:, :, 3]) <= TOL
        assert float(torch.where(planes >= n_live[:, None, None], d_samp, 0.0).abs().max()) == 0.0
        d_tex = fused_render.warp_splat(d_ref, rx, ry, scal, 128, 128, n_live=n_live)
        t_ref = fused_render.warp_splat_ref(d_ref, rx, ry, scal, 128, 128, n_live=n_live)
        assert _rel(d_tex, t_ref) <= TOL
    torch.cuda.synchronize()
    assert fused_render.LAUNCHES["composite_bwd"] == before["composite_bwd"] + 2
    assert fused_render.LAUNCHES["splat"] == before["splat"] + 2
    # without the sparsity rule (the slab form): every plane, no masks
    d_samp = fused_render.composite_bwd(ref[-2].nan_to_num(0.0), q, scal, gc, gd, gp, gt)
    d_ref = fused_render.composite_bwd_ref(ref[-2].nan_to_num(0.0), q, scal, gc, gd, gp, gt)
    assert _rel(d_samp[:, :, 3], d_ref[:, :, 3]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("opaque", [(), (0,)], ids=["random", "opaque_near_plane"])
def test_function_gradient_matches_gather_autograd_on_the_card(cuda, opaque):
    """``render_mpi_fused`` under autograd (forward kernel, composite
    backward, splat) against the gather renderer's autograd, V=3 with a
    shared (expanded) MPI and a packed one; relative 1e-3."""
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 6, 64, [0.3, -0.5, 0.0], [-0.2, 0.1, 0.0])
    g = torch.Generator(device=cuda).manual_seed(5)
    cot = [torch.randn((3, c, 64, 64), device=cuda, generator=g) for c in (3, 1, 1)]
    for shape, spread in (((1, 6, 4, 64, 64), lambda t: t.expand(3, -1, -1, -1, -1)),
                          ((3, 6, 4, 64, 64), lambda t: t)):
        mpi = torch.rand(shape, device=cuda, generator=g)
        for l in opaque:
            mpi[:, l, 3, 16:] = 1.0
        grads = []
        before = dict(fused_render.LAUNCHES)
        for render in (render_mpi_fused, render_mpi):
            x = mpi.clone().requires_grad_()
            out = render(spread(x), geom.dhw, ray_dir, eye, z_dir)
            grads.append(torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), x)[0])
        assert {k: v - before[k] for k, v in fused_render.LAUNCHES.items()} == {
            "fused_fwd": 1, "composite_bwd": 1, "splat": 1}
        assert torch.isfinite(grads[0]).all()
        assert _rel(grads[0], grads[1]) <= 1e-3


@pytest.mark.gpu
def test_backward_wrappers_reject_what_the_kernels_do_not_take(cuda):
    _, (rx, ry, q, scal), out, _, warped, (gc, gd, _, _) = _training_case(cuda, ())
    with pytest.raises(ValueError, match="grad_tau"):
        fused_render.composite_bwd(warped, q, scal, gc, n_live=out[-1])
    with pytest.raises(TypeError):
        fused_render.composite_bwd(warped, q, scal, gc, n_live=out[-1].long(),
                                   grad_tau=fused_render.GRAD_TAU)
    with pytest.raises(ValueError):
        fused_render.composite_bwd(warped, q, scal, gc[:, :2].contiguous())
    with pytest.raises(TypeError):
        fused_render.warp_splat(warped.double(), rx, ry, scal, 128, 128)
    with pytest.raises(ValueError):
        fused_render.warp_splat(warped, rx, ry, scal[:, :4].contiguous(), 128, 128)
