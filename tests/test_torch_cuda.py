"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it runs on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

Without a CUDA card every test skips.  Tolerance 1e-4 (absolute for the
forward, whose outputs are O(1); relative to max|plain| per field for the
backward kernels, whose alpha cotangent reaches 1e10 behind an opaque plane):
a kernel and its plain version evaluate the same fp32 formula and differ in
FMA contraction and, for the splat, in the order of its atomic sums.  The
patch gather is a copy and must be exact; the adjoint sums in a fixed order
and must be bitwise repeatable.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses
from gmpi_tpu_torch.core.renderer import (plan_fused, render_mpi, render_mpi_chunked,
                                          render_mpi_fused)
from gmpi_tpu_torch.ops import fused_render, patch_gather

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
            "fused_fwd": 1, "composite_bwd": 1, "splat": 1, "adjoint": 0, "patch_gather": 0,
            "patch_sample": 0, "mpi_stack": 0, "texture_sample": 0}
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


# K7's shapes: (n, t, wp, hpc, band_x, band_yc, start steps (x, y) in elements, tweak)
K7_CASES = {
    "aligned": (3, 17, 72, 640, 24, 128, (8, 16), None),
    "unaligned": (3, 17, 37, 91, 7, 13, (1, 1), None),  # odd pitches: the loop path
    "starts 4 past 8": (3, 7, 90, 1200, 30, 416, (1, 8), "plus4"),  # bf16: 8 bytes off 16
    "any start": (3, 17, 72, 640, 24, 128, (1, 1), None),
    "row of three boxes": (2, 5, 100, 1200, 37, 600, (1, 4), None),
    "one patch": (1, 1, 50, 520, 50, 520, (1, 1), None),
    "texture off 16 bytes": (2, 5, 60, 512, 20, 256, (1, 1), "offset"),  # the loop path
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("aligned", list(K7_CASES))
def test_patch_gather_kernel_is_an_exact_copy(cuda, dtype, aligned):
    """Each shape takes the path ``launch_geometry`` names (the TMA's bulk
    copies, with the warp's shift for a start off 16 bytes, or the loop for
    pitches or a texture not on 16 bytes); patches at both corners of the
    texture; out-of-range offsets raise on the host and are clamped by the
    kernel when the host check is off."""
    n, t, wp, hpc, band_x, band_yc, step, tweak = K7_CASES[aligned]
    g = torch.Generator(device=cuda).manual_seed(1)
    flat = torch.randn((n * wp * hpc + 1,), device=cuda, generator=g).to(dtype)
    texf = (flat[1:] if tweak == "offset" else flat[:-1]).view(n, wp, hpc)
    offs = torch.stack([
        torch.randint(0, (wp - band_x) // step[0] + 1, (n, t), device=cuda, generator=g) * step[0],
        torch.randint(0, (hpc - band_yc) // step[1] + 1, (n, t), device=cuda, generator=g)
        * step[1]], dim=-1).to(torch.int32)
    if tweak == "plus4":
        offs[..., 1] = (offs[..., 1] + 4).clamp(max=hpc - band_yc)
    offs[0, 0] = 0
    offs[-1, -1] = torch.tensor([wp - band_x, hpc - band_yc], device=cuda)
    geo = patch_gather.launch_geometry(hpc, band_x, band_yc, texf.element_size(),
                                       base_aligned=texf.data_ptr() % 16 == 0)
    assert geo.path == ("loop" if aligned in ("unaligned", "texture off 16 bytes") else "tma")
    before = patch_gather.LAUNCHES["patch_gather"]
    paths = dict(patch_gather.PATH_LAUNCHES)
    out = patch_gather.gather_patches(texf, offs, band_x, band_yc)
    ref = patch_gather.gather_patches_ref(texf, offs, band_x, band_yc)
    torch.cuda.synchronize()
    assert patch_gather.LAUNCHES["patch_gather"] == before + 1
    assert patch_gather.PATH_LAUNCHES[geo.path] == paths[geo.path] + 1
    assert out.dtype == dtype and torch.equal(out, ref)
    bad = offs.clone()
    bad[-1, 0] = torch.tensor([wp, -5], device=cuda)
    with pytest.raises(ValueError, match="leaves the texture"):
        patch_gather.gather_patches(texf, bad, band_x, band_yc)
    clamped = patch_gather.gather_patches(texf, bad, band_x, band_yc, validate=False)
    bad[-1, 0] = torch.tensor([wp - band_x, 0], device=cuda)
    assert torch.equal(clamped, patch_gather.gather_patches_ref(texf, bad, band_x, band_yc))
    with pytest.raises(TypeError):
        patch_gather.gather_patches(texf.double(), offs, band_x, band_yc)
    with pytest.raises(RuntimeError, match="no gradient"):
        patch_gather.gather_patches(texf.float().requires_grad_(), offs, band_x, band_yc)


# the TMA path at the limits of its ring and its jobs: (stages, stores in flight past the one
# waited for, rows a job); None keeps launch_geometry's choice
K7_GEOMETRIES = {"2 stages, lag 0": (2, 0, None), "8 stages, lag 6": (8, 6, None),
                 "one row a job": (None, None, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("geometry", list(K7_GEOMETRIES))
def test_patch_gather_kernel_at_extreme_geometries(cuda, dtype, geometry):
    """The kernel launched directly at geometries the wrapper does not pick
    (the fewest and the most stages the kernel takes, the fewest and the
    most stores left in flight, jobs of one row), on rows of three boxes and
    any starts (bf16 and fp32 starts off 16 bytes take the warp's shift):
    an exact copy."""
    n, t, wp, hpc, band_x, band_yc = 2, 5, 100, 1200, 37, 600
    g = torch.Generator(device=cuda).manual_seed(2)
    texf = torch.randn((n, wp, hpc), device=cuda, generator=g).to(dtype)
    offs = torch.stack([torch.randint(0, wp - band_x + 1, (n, t), device=cuda, generator=g),
                        torch.randint(0, hpc - band_yc + 1, (n, t), device=cuda, generator=g)],
                       dim=-1).to(torch.int32)
    offs[0, 0] = 0
    offs[-1, -1] = torch.tensor([wp - band_x, hpc - band_yc], device=cuda)
    geo = patch_gather.launch_geometry(hpc, band_x, band_yc, texf.element_size())
    stages, lag, rows = K7_GEOMETRIES[geometry]
    rows = rows or geo.rows
    geo = geo._replace(rows=rows, chunks=-(-band_x // rows), stages=stages or geo.stages,
                       lag=geo.lag if lag is None else lag)
    assert geo.path == "tma" and geo.boxes == 3
    out = torch.full((n, t, band_x, band_yc), float("nan"), dtype=dtype, device=cuda)
    patch_gather._launch(texf, offs, out, geo)
    torch.cuda.synchronize()
    assert torch.equal(out, patch_gather.gather_patches_ref(texf, offs, band_x, band_yc))


@pytest.mark.gpu
def test_banded_render_with_kernel_patches_matches_gather_on_the_card(cuda):
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 6, 128, [0.5, -0.5, 0.0], [-0.2, 0.2, 0.0])
    cfg = get_config("FFHQ256")
    from gmpi_tpu_torch.core.bands import bands_for_config
    bands = bands_for_config(cfg, img_size=128, n_planes=6)
    mpi = torch.rand((3, 6, 4, 128, 128), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    gather = render_mpi(mpi, geom.dhw, ray_dir, eye, z_dir)
    before = dict(fused_render.LAUNCHES)
    banded = render_mpi(mpi, geom.dhw, ray_dir, eye, z_dir, tiled_bands=bands)
    chunked = render_mpi_chunked(mpi, geom.dhw, ray_dir, eye, z_dir, 2, tiled_bands=bands)
    # one K10 launch a warp call (the whole render, then each of 3 slabs), no K7 or K8
    assert {k: v - before[k] for k, v in fused_render.LAUNCHES.items() if v != before[k]} == {
        "texture_sample": 1 + 3}
    # the hats: under autograd, with no tiled adjoint in the bands
    plain = render_mpi(mpi.clone().requires_grad_(), geom.dhw, ray_dir, eye, z_dir,
                       tiled_bands=bands[:2])
    for a, b, c, d in zip(gather, banded, chunked, (t.detach() for t in plain)):
        assert float((a - b).abs().max()) <= 5e-4
        assert float((a - c).abs().max()) <= 5e-4
        # the same patches; the tap kernel and the hat contractions sum in another order
        assert float((b - d).abs().max()) <= 1e-5
    # under autograd the 4-field bands keep the kernels (tiled adjoint backward)
    x = mpi.clone().requires_grad_()
    y = mpi.clone().requires_grad_()
    cot = torch.randn_like(gather.color)
    g_b = torch.autograd.grad((render_mpi(x, geom.dhw, ray_dir, eye, z_dir,
                                          tiled_bands=bands).color * cot).sum(), x)[0]
    g_g = torch.autograd.grad((render_mpi(y, geom.dhw, ray_dir, eye, z_dir).color * cot).sum(),
                              y)[0]
    assert _rel(g_b, g_g) <= 1e-3


# K8 at the banded route's shapes: (preset, planes, resolution, bands (y, x) or None for the
# grid's own, tile); the first two are the serving cell's and FFHQ1024 eval's
K8_CASES = {"ffhq256": ("FFHQ256", 96, 256, (96, 376), (8, 256)),
            "ffhq1024": ("FFHQ1024", 96, 1024, (104, 424), (8, 256)),
            "tile 1xW": ("FFHQ256", 8, 228, None, (1, 228))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", K8_CASES)
def test_patch_sample_kernel_matches_plain_version(cuda, monkeypatch, case):
    """The tap sampler (K8) after K7's patches, as the tiled warp's taps took
    them before K10 (``texture_sample.patch_taps``, the rule's tile rows a
    step), at a +2 sigma corner pose: one K8 launch a tile-row step with
    K7's; the first and last steps' launches against the plain version on
    the same inputs (1e-4 of max|plain|); the whole within 5e-4 of
    ``F.grid_sample``."""
    from gmpi_tpu_torch.core.renderer import homography_grid
    from gmpi_tpu_torch.ops import grid_sample, patch_sample, texture_sample, tiled_warp

    preset, n_planes, res, bands, tile = K8_CASES[case]
    cfg = get_config(preset)
    cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_planes))
    k = cfg.camera.n_truncated_stds
    c2w, _, _ = poses.sample_sphere_poses(None, 1, cfg.camera, given_yaws=[[k * 0.289]],
                                          given_pitches=[[k * 0.127]], device=cuda)
    ray_dir, eye, z_dir = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, res, res), c2w)
    grid, _ = homography_grid(cfg.plane_geometry(device=cuda).dhw, eye.expand(n_planes, 3),
                              ray_dir.expand(n_planes, -1, -1, -1), z_dir.expand(n_planes, 3))
    tex = torch.rand((n_planes, 4, res, res), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(8))
    bands = bands or tuple(b + 2 for b in tiled_warp.required_bands(tex.shape, grid, tile=tile))
    assert bool(tiled_warp.bands_cover(tex.shape, grid, *bands, tile=tile))
    kept, sample = [], texture_sample.sample_patches

    def keep(*args):  # the first and the last step's inputs
        kept[min(len(kept), 1):] = [args]
        return sample(*args)

    monkeypatch.setattr(texture_sample, "sample_patches", keep)
    fx_t, fy_t, nty, _ = tiled_warp._tile_coords(tex.shape, grid, True, tile)
    fx, fy = (f.transpose(2, 3).reshape(n_planes, res, res) for f in (fx_t, fy_t))
    origins = texture_sample.band_origins(fx, fy, bands, tile, res, res)
    rows = tiled_warp.tiling(res, res, tile)
    before = dict(fused_render.LAUNCHES)
    out = texture_sample.patch_taps(tex, origins, fx, fy, bands, tile,
                                    rows.rows_per_step if rows.row_scan else nty)
    torch.cuda.synchronize()
    steps = fused_render.LAUNCHES["patch_sample"] - before["patch_sample"]
    assert steps >= 1 and fused_render.LAUNCHES["patch_gather"] - before["patch_gather"] == steps
    for pm, offs, fx, fy, pad, tl, _, first in kept:
        oy, ox = patch_sample._tile_pixels(offs, res, res, tl, first)
        at = (slice(None), slice(None), oy[:, :, None], ox[:, None, :])
        got = patch_sample.sample_patches(pm, offs, fx, fy, pad, tl, torch.zeros_like(out), first)
        ref = patch_sample.sample_patches_ref(pm, offs, fx, fy, pad, tl, torch.zeros_like(out),
                                              first)
        assert float((got[at] - ref[at]).abs().max()) <= TOL * float(ref[at].abs().max())
    gather = grid_sample.grid_sample_bilinear(tex, grid)
    assert float((out - gather).abs().max()) <= 5e-4


@pytest.mark.gpu
@pytest.mark.parametrize("opaque", [(), (2, 3)], ids=["random", "two_opaque"])
@pytest.mark.parametrize("img", [128, 256, 64], ids=["same_size", "magnified", "minified"])
def test_adjoint_kernel_matches_plain_version_and_splat_bitwise_repeatable(cuda, opaque, img):
    """V=3, L=8, 128^2 texture, images of half, equal and twice its size;
    ``d_samp`` from the composite backward (exact zeros on dead slots).  Both
    scan directions of the kernel."""
    tex = 128
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 8, img, [0.578, -0.1, 0.0], [0.2, 0.0, -0.254])
    g = torch.Generator(device=cuda).manual_seed(11)
    rgba = torch.rand((3, 8, 4, tex, tex), device=cuda, generator=g)
    for l in opaque:
        rgba[:, l, 3] = 1.0
    scal = fused_render.plane_affine(geom.dhw, eye, tex, tex).contiguous()
    rx, ry, q = (x.contiguous() for x in fused_render.ray_fields(ray_dir, z_dir))
    *_, warped, n_live = fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, early_out="grad",
                                                         with_disp=False, with_warped=True)
    gc = torch.randn((3, 3, img, img), device=cuda, generator=g)
    d_samp = fused_render.composite_bwd(warped, q, scal, gc, n_live=n_live,
                                        grad_tau=fused_render.GRAD_TAU)
    bands = fused_render.plan_adjoint(scal, rx, ry)
    ref = fused_render.warp_adjoint_ref(d_samp, rx, ry, scal, tex, tex)
    splat = fused_render.warp_splat(d_samp, rx, ry, scal, tex, tex, n_live=n_live)
    before = fused_render.LAUNCHES["adjoint"]
    out = fused_render.warp_adjoint(d_samp, rx, ry, scal, bands, tex, tex)
    again = fused_render.warp_adjoint(d_samp, rx, ry, scal, bands, tex, tex)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert _rel(out, ref) <= TOL and _rel(out, splat) <= TOL
    assert fused_render.LAUNCHES["adjoint"] == before + 2
    with pytest.raises(ValueError, match="AdjointBands"):
        fused_render.warp_adjoint(d_samp, rx, ry, scal, (4, 4), tex, tex)
    with pytest.raises(TypeError):
        fused_render.warp_adjoint(d_samp.double(), rx, ry, scal, bands, tex, tex)


@pytest.mark.gpu
def test_adjoint_route_gradient_matches_splat_route_and_gather_on_the_card(cuda):
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 6, 64, [0.3, -0.5, 0.0], [-0.2, 0.1, 0.0])
    g = torch.Generator(device=cuda).manual_seed(5)
    cot = [torch.randn((3, c, 64, 64), device=cuda, generator=g) for c in (3, 1, 1)]
    mpi = torch.rand((3, 6, 4, 64, 64), device=cuda, generator=g)
    mpi[:, 0, 3, 16:] = 1.0
    plans = plan_fused(geom.dhw, ray_dir, eye, z_dir, 64, 64)
    grads = []
    for render, kw, launched in (
            (render_mpi_fused, dict(plans=plans), dict(fused_fwd=1, composite_bwd=1, adjoint=1)),
            (render_mpi_fused, dict(plans=plans), dict(fused_fwd=1, composite_bwd=1, adjoint=1)),
            (render_mpi_fused, {}, dict(fused_fwd=1, composite_bwd=1, splat=1)),
            (render_mpi, {}, {})):
        before = dict(fused_render.LAUNCHES)
        x = mpi.clone().requires_grad_()
        out = render(x, geom.dhw, ray_dir, eye, z_dir, **kw)
        grads.append(torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), x)[0])
        assert {k: v - before[k] for k, v in fused_render.LAUNCHES.items() if v != before[k]} \
            == launched
    assert torch.equal(grads[0], grads[1])  # no atomics: bitwise repeatable
    assert _rel(grads[0], grads[2]) <= 1e-3 and _rel(grads[0], grads[3]) <= 1e-3


# label -> image (H, W), texture (Th, Tw), tweak: the edges of the staged forward's and the
# adjoint's designs (tiles of 32 x 8 pixels and 32 x 16 texels, groups of 2 planes, 16-byte copies)
EDGES = {
    "ragged_tiles": ((243, 250), (131, 200), None),
    "odd_texture_width": ((244, 252), (200, 131), None),
    "unaligned_slab_of_a_parent": ((243, 250), (131, 200), "slab"),
    "texture_far_larger_than_image": ((64, 96), (300, 520), None),
    "strong_minification": ((256, 256), (40, 64), None),
    "every_tap_outside": ((243, 250), (131, 200), "outside"),
    "nan_ray": ((244, 252), (131, 200), "nan"),
}
N_EDGE_PLANES = 9  # not a multiple of the staged group


def _unaligned_copy(x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty((x.numel() + 1,), dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def _edge_scene(dev, case, cases=EDGES):
    (h, w), (th, tw), tweak = cases[case]
    cfg = get_config("FFHQ256")
    cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes,
                                                              n_planes=N_EDGE_PLANES))
    geom = cfg.plane_geometry(device=dev)
    c2w, _, _ = poses.sample_sphere_poses(None, 3, cfg.camera,
                                          given_yaws=torch.tensor([[0.5], [-0.3], [0.0]]),
                                          given_pitches=torch.tensor([[0.2], [-0.25], [0.1]]),
                                          device=dev)
    ray_dir, eye, z_dir = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, h, w), c2w)
    scal = fused_render.plane_affine(geom.dhw, eye, th, tw).contiguous()
    rx, ry, q = (x.contiguous() for x in fused_render.ray_fields(ray_dir, z_dir))
    if tweak == "outside":
        scal[..., 1] += 1e4
    if tweak == "nan":
        rx[0, 5, 7] = ry[0, 5, 7] = float("nan")
        rx[1, 0, 0] = ry[2, h - 1, w - 1] = float("nan")
    return (h, w), (th, tw), tweak, (rx, ry, q, scal)


@pytest.mark.gpu
@pytest.mark.parametrize("stack", ["uniform", "sparse", "opaque_mid"])
@pytest.mark.parametrize("case", list(EDGES))
def test_fused_fwd_kernel_matches_plain_version_at_the_edges(cuda, case, stack):
    """The forward kernel in every form (the three ``early_out`` modes, with
    and without disparity and residual) at sizes that are not multiples of the
    tiles, a texture width that is not a multiple of 4, a plane count that is
    not a multiple of the staged group, a slab of a parent stack on an
    unaligned address, boxes beyond the staging tile, every tap outside the
    texture, a NaN ray (held on the other pixels: there the kernels read zeros
    and the plain version's lerp weights turn NaN).  1e-4 absolute."""
    _, (th, tw), tweak, (rx, ry, q, scal) = _edge_scene(cuda, case)
    g = torch.Generator(device=cuda).manual_seed(5)
    parent = torch.rand((3, N_EDGE_PLANES + 4, 4, th, tw), device=cuda, generator=g)
    if stack != "uniform":
        parent[:, :, 3] *= 0.05
    if stack == "opaque_mid":
        parent[:, 5:8, 3] = 1.0
    tex = _unaligned_copy(parent)[:, 2:2 + N_EDGE_PLANES] if tweak == "slab" else \
        parent[:, 2:2 + N_EDGE_PLANES].contiguous()
    real = torch.isfinite(rx) & torch.isfinite(ry)
    planes = torch.arange(N_EDGE_PLANES, device=cuda).reshape(1, -1, 1, 1, 1)
    for early_out in (False, True, "grad"):
        for with_disp in (False, True):
            for with_warped in (False, True):
                kw = dict(early_out=early_out, with_disp=with_disp, with_warped=with_warped)
                ref = fused_render.warp_composite_fwd_ref(tex, rx, ry, q, scal, **kw)
                n_base = 4 if with_disp else 3
                out = fused_render.warp_composite_fwd(tex, rx, ry, q, scal, **kw)
                torch.cuda.synchronize()
                assert len(out) == len(ref)
                for a, b in zip(out[:n_base], ref[:n_base]):
                    assert float(torch.where(real[:, None], a - b, 0.0).abs().max()) <= TOL
                both = real[:, None, None]
                if early_out == "grad":
                    moved = (out[-1] != ref[-1]) & real
                    assert int(torch.where(real, out[-1] - ref[-1], 0).abs().max()) <= 1
                    assert float(moved.float().mean()) <= 1e-4
                    both = both & (planes < torch.minimum(out[-1], ref[-1])[:, None, None])
                if with_warped and early_out is not True:
                    diff = torch.where(both, out[n_base] - ref[n_base], 0.0)
                    assert float(diff.abs().max()) <= TOL
                if tweak == "outside":
                    assert float(out[0].abs().max()) == 0.0
                    assert float(out[n_base - 1].min()) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("stack", ["uniform", "sparse", "opaque_mid"])
@pytest.mark.parametrize("case", ["main"] + list(EDGES))
def test_fused_fwd_bf16_kernel_matches_plain_version(cuda, case, stack):
    """The forward kernel's bf16-texture form against its bf16 plain version
    (the same weights and roundings; 1e-4 absolute, the fp32 form's gate) at
    a 128^2 scene of 8 planes and at the edges above (the unaligned slab
    takes the kernel's copy of texels without 16-byte copies), in every
    ``early_out`` mode with the residual; ``n_live`` may move by a plane at
    the grad-safe threshold.  Never against the fp32 kernel: bf16 alphas may
    stop a pixel elsewhere."""
    if case == "main":
        geom, (ray_dir, eye, z_dir) = _scene(cuda, 8, 128, [0.5, -0.1, 0.2], [0.2, 0.0, -0.1])
        th = tw = 128
        scal = fused_render.plane_affine(geom.dhw, eye, th, tw).contiguous()
        rx, ry, q = (x.contiguous() for x in fused_render.ray_fields(ray_dir, z_dir))
        tweak, n_l = None, 8
    else:
        _, (th, tw), tweak, (rx, ry, q, scal) = _edge_scene(cuda, case)
        n_l = N_EDGE_PLANES
    g = torch.Generator(device=cuda).manual_seed(8)
    parent = torch.rand((3, n_l + 4, 4, th, tw), device=cuda, generator=g)
    if stack != "uniform":
        parent[:, :, 3] *= 0.05
    if stack == "opaque_mid":
        parent[:, 5:8, 3] = 1.0
    parent = parent.to(torch.bfloat16)
    tex = _unaligned_copy(parent)[:, 2:2 + n_l] if tweak == "slab" else \
        parent[:, 2:2 + n_l].contiguous()
    real = torch.isfinite(rx) & torch.isfinite(ry)
    before = fused_render.LAUNCHES["fused_fwd"]
    for early_out in (False, True, "grad"):
        kw = dict(early_out=early_out, with_disp=True, with_warped=early_out is not True)
        out = fused_render.warp_composite_fwd(tex, rx, ry, q, scal, **kw)
        ref = fused_render.warp_composite_fwd_ref(tex, rx, ry, q, scal, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out[:4], ref[:4]):
            assert float(torch.where(real[:, None], a - b, 0.0).abs().max()) <= TOL
        if early_out == "grad":
            assert int(torch.where(real, out[-1] - ref[-1], 0).abs().max()) <= 1
    assert fused_render.LAUNCHES["fused_fwd"] == before + 3
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_render.warp_composite_fwd(tex.half(), rx, ry, q, scal)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EDGES))
def test_adjoint_kernel_matches_plain_version_at_the_edges(cuda, case):
    """Random cotangents with exact zeros among them; 1e-4 of max|plain|,
    within rounding of the splat, bitwise equal across two launches.  The
    strong minification makes a texel tile's box of pixels many staged chunks."""
    (h, w), (th, tw), tweak, (rx, ry, _, scal) = _edge_scene(cuda, case)
    g = torch.Generator(device=cuda).manual_seed(6)
    d_samp = torch.randn((3, N_EDGE_PLANES, 4, h, w), device=cuda, generator=g)
    d_samp = d_samp * (torch.rand((3, N_EDGE_PLANES, 1, h, w), device=cuda, generator=g) > 0.3)
    if tweak == "slab":
        d_samp = _unaligned_copy(d_samp)
    bands = fused_render.AdjointBands() if tweak == "nan" else \
        fused_render.plan_adjoint(scal, rx, ry)
    out = fused_render.warp_adjoint(d_samp, rx, ry, scal, bands, th, tw)
    again = fused_render.warp_adjoint(d_samp, rx, ry, scal, bands, th, tw)
    ref = fused_render.warp_adjoint_ref(d_samp, rx, ry, scal, th, tw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.isfinite(out).all()
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL * scale
    if tweak == "outside":
        assert scale == 0.0 and float(out.abs().max()) == 0.0
    if tweak != "nan":  # the splat's coordinates are not NaN-safe by contract
        splat = fused_render.warp_splat(d_samp, rx, ry, scal, th, tw)
        assert float((out - splat).abs().max()) <= TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n_stacks,n_views", [(4, 4), (1, 4), (2, 4), (2, 6)],
                         ids=["k1", "kV", "k2", "k3"])
def test_grouped_stacks_on_the_card(cuda, n_stacks, n_views):
    """Stacks read by groups of views: the kernel equals itself on the
    materialized repeat bit for bit, and the plain version within 1e-4; bad
    groupings raise."""
    geom, (ray_dir, eye, z_dir) = _scene(cuda, 7, 128, torch.linspace(-0.5, 0.5, n_views)[:, None],
                                         torch.linspace(0.2, -0.2, n_views)[:, None])
    scal = fused_render.plane_affine(geom.dhw, eye, 128, 128).contiguous()
    rx, ry, q = (x.contiguous() for x in fused_render.ray_fields(ray_dir, z_dir))
    stacks = torch.rand((n_stacks, 7, 4, 128, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(8))
    repeated = stacks.repeat_interleave(n_views // n_stacks, dim=0)
    ref = fused_render.warp_composite_fwd_ref(stacks, rx, ry, q, scal)
    a = fused_render.warp_composite_fwd(stacks, rx, ry, q, scal)
    b = fused_render.warp_composite_fwd(repeated, rx, ry, q, scal)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(float((x - y).abs().max()) <= TOL for x, y in zip(a, ref))
    fused = render_mpi_fused(stacks, geom.dhw, ray_dir, eye, z_dir)
    gather = render_mpi(repeated, geom.dhw, ray_dir, eye, z_dir)
    assert all(float((x - y).abs().max()) <= 5e-4 for x, y in zip(fused, gather))
    if n_views % 3:
        with pytest.raises(ValueError, match="multiple"):
            fused_render.warp_composite_fwd(stacks[:1].expand(3, -1, -1, -1, -1).contiguous(),
                                            rx, ry, q, scal)


# label -> image (H, W), texture (Th, Tw), tweak: the splat's tiles and texel boxes
SPLAT_CASES = {
    "same_size": ((128, 128), (128, 128), None),
    "ragged_tiles": ((243, 250), (131, 200), None),
    "odd_texture_width": ((244, 252), (200, 131), None),
    "magnified_beyond_the_box": ((64, 96), (300, 520), None),
    "strong_minification": ((256, 256), (40, 64), None),
    "every_tap_outside": ((243, 250), (131, 200), "outside"),
    "unaligned_slab": ((243, 250), (131, 200), "slab"),
    "nan_ray": ((244, 252), (131, 200), "nan"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["all_live", "n_live"])
@pytest.mark.parametrize("case", list(SPLAT_CASES))
def test_splat_kernel_paths_match_plain_version(cuda, case, masked):
    """Both paths of the splat kernel (a tile's taps summed in its texel box
    in shared memory, then 16- or 4-byte reductions into ``d_tex``; and every
    tap added into ``d_tex``, which a box beyond the shared memory takes, as
    the magnified case's boxes do) against ``warp_splat_ref``, 1e-4 of
    max|plain|.  With ``n_live`` the dead slots hold NaN: they must not be read."""
    (h, w), (th, tw), tweak, (rx, ry, _, scal) = _edge_scene(cuda, case, SPLAT_CASES)
    g = torch.Generator(device=cuda).manual_seed(9)
    n_l = N_EDGE_PLANES
    d_samp = torch.randn((3, n_l, 4, h, w), device=cuda, generator=g)
    d_samp = d_samp * (torch.rand((3, n_l, 1, h, w), device=cuda, generator=g) > 0.3)
    n_live = None
    if masked:
        n_live = torch.randint(0, n_l + 1, (3, h, w), device=cuda, generator=g, dtype=torch.int32)
        planes = torch.arange(n_l, device=cuda).reshape(1, n_l, 1, 1, 1)
        d_samp = torch.where(planes < n_live[:, None, None], d_samp, float("nan"))
    if tweak == "slab":
        d_samp = _unaligned_copy(d_samp)
    ref = fused_render.warp_splat_ref(d_samp, rx, ry, scal, th, tw, n_live=n_live)
    before = fused_render.LAUNCHES["splat"]
    outs = [fused_render.warp_splat(d_samp, rx, ry, scal, th, tw, n_live=n_live),
            fused_render._launch_splat(d_samp, rx, ry, scal, n_live, th, tw, boxed=False)]
    torch.cuda.synchronize()
    assert fused_render.LAUNCHES["splat"] == before + 2
    scale = float(ref.abs().max())
    for out in outs:
        assert torch.isfinite(out).all()
        assert float((out - ref).abs().max()) <= TOL * scale
    if tweak == "outside":
        assert scale == 0.0 and float(outs[0].abs().max()) == 0.0


COMPOSITE_CASES = {  # label -> L, image (H, W), opaque planes, unaligned
    "one_plane": (1, (24, 20), (), False),
    "chunk_minus_one": (3, (24, 20), (1,), False),
    "chunk_plus_one": (5, (24, 20), (1, 3), False),
    "between_chunks": (9, (24, 20), (2, 5), False),
    "serving_depth": (96, (24, 20), (40,), False),
    "deep_stack": (600, (16, 24), (300, 301), False),
    "odd_pixel_count": (9, (15, 13), (2, 5), False),
    "unaligned_slab": (33, (24, 20), (7,), True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("optional", [False, True], ids=["color_only", "all_cotangents"])
@pytest.mark.parametrize("case", list(COMPOSITE_CASES))
def test_composite_bwd_kernel_matches_plain_version(cuda, case, optional):
    """Plane counts around the kernel's chunk of 4 and beyond one checkpoint a
    chunk (600 planes: a checkpoint every 20), an odd pixel count and an
    unaligned slab (the scalar path), opaque planes (one: the planes behind keep
    their cotangents; two: the grad_tau cut falls inside a chunk), with
    and without the optional cotangents; random n_live with NaN in the dead
    slots, and the slab form (no mask).  1e-4 of max|plain| per field."""
    n_l, (h, w), opaque, unaligned = COMPOSITE_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(12)
    warped = torch.rand((2, n_l, 4, h, w), device=cuda, generator=g)
    warped[:, :, 3] *= 0.1  # transmittance lasts through the deep stack
    for l in opaque:
        warped[:, l, 3] = 1.0
    scal = torch.zeros((2, n_l, 6), device=cuda)
    scal[..., 4] = torch.rand((2, n_l), device=cuda, generator=g) + 0.5
    q = torch.rand((2, h, w), device=cuda, generator=g) + 0.9
    gc = torch.randn((2, 3, h, w), device=cuda, generator=g)
    opt = tuple(torch.randn((2, h, w), device=cuda, generator=g) if optional else None
                for _ in range(3))
    n_live = torch.randint(0, n_l + 1, (2, h, w), device=cuda, generator=g, dtype=torch.int32)
    n_live[0, :4] = n_l  # whole pixel rows reach every plane
    planes = torch.arange(n_l, device=cuda).reshape(1, n_l, 1, 1, 1)
    poisoned = torch.where(planes < n_live[:, None, None], warped, float("nan"))
    if unaligned:
        poisoned, warped = _unaligned_copy(poisoned), _unaligned_copy(warped)
    before = fused_render.LAUNCHES["composite_bwd"]
    for x, kw in ((poisoned, dict(n_live=n_live, grad_tau=fused_render.GRAD_TAU)),
                  (warped, dict(grad_tau=fused_render.GRAD_TAU)), (warped, {})):
        out = fused_render.composite_bwd(x, q, scal, gc, *opt, **kw)
        ref = fused_render.composite_bwd_ref(x, q, scal, gc, *opt, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert _rel(out[:, :, :3], ref[:, :, :3]) <= TOL
        assert _rel(out[:, :, 3], ref[:, :, 3]) <= TOL
        if "n_live" in kw:
            assert float(torch.where(planes >= n_live[:, None, None], out, 0.0).abs().max()) == 0
        if len(opaque) == 2 and opaque[1] == opaque[0] + 1 and kw:
            assert float(out[:, opaque[1] + 1:].abs().max()) == 0.0  # S / M collapsed
    assert fused_render.LAUNCHES["composite_bwd"] == before + 3


@pytest.mark.gpu
def test_training_loop_on_the_card(cuda, tmp_path):
    """The training loop at a tiny width on the card: the fused kernels run
    (per step ``batch_split`` forward launches for the D phase's fakes, one
    for worst-view selection, ``batch_split`` for the G phase, and
    ``batch_split`` composite backward and splat launches; one MPI-stack
    launch a block of each G call without a gradient, the D phase's
    ``batch_split`` and worst-view selection's), the weights stay
    finite, the checkpoint loads bitwise."""
    from gmpi_tpu_torch import config as tcfg
    from gmpi_tpu_torch.core.poses import SphereCameraConfig
    from gmpi_tpu_torch.train import checkpoint, init_train_state
    from gmpi_tpu_torch.train.loop import LoopStats, train

    bs, split = 4, 2
    cfg = tcfg.ExperimentConfig(
        name="tiny", resolution=16, fov_deg=12.6,
        camera=SphereCameraConfig(sphere_center_z=1.0, sphere_r=1.0, yaw_mean=0.0,
                                  yaw_std=0.289, pitch_mean=0.0, pitch_std=0.127),
        planes=tcfg.PlaneConfig(n_planes=4, min_d=0.95, max_d=1.12),
        hparams=tcfg.StepHparams(batch_size=bs, img_size=16, tex_size=16, batch_split=split,
                                 gen_lr=0.002, disc_lr=0.002),
        train=tcfg.TrainHparams(z_dim=32, w_dim=32, n_view_per_z=2, aug_with_lighting=False),
        model=tcfg.ModelPreset(channel_base=512, channel_max=32, num_bf16_res=0,
                               conv_clamp=None, gen_alpha_largest_res=16, mbstd_group_size=2))
    rng = np.random.default_rng(0)
    batches = [(rng.uniform(-1, 1, (bs, 3, 16, 16)).astype(np.float32),
                rng.standard_normal((bs, 16)).astype(np.float32)) for _ in range(3)]
    before = dict(fused_render.LAUNCHES)
    stats = LoopStats()
    state = train(cfg, iter(batches), str(tmp_path), total_iters=3, sample_interval=100,
                  model_save_interval=100, seed=0, stats=stats)
    launched = {k: fused_render.LAUNCHES[k] - before[k] for k in before}
    assert state.step == 3 and len(stats.step_ms) == 3
    assert launched == {**dict.fromkeys(launched, 0), "fused_fwd": (2 * split + 1) * 3,
                        "composite_bwd": split * 3, "splat": split * 3,
                        "mpi_stack": (split + 1) * 3 * 3}  # G's blocks 4, 8, 16 a call
    assert all(torch.isfinite(p).all() for p in state.G.parameters())
    loaded = checkpoint.load_checkpoint(str(tmp_path / "checkpoints"),
                                        init_train_state(cfg, device=cuda))
    assert loaded.step == 3
    for a, b in zip(loaded.G.state_dict().values(), state.G.state_dict().values()):
        assert torch.equal(a, b)
    for key in state.ema:
        assert torch.equal(loaded.ema[key], state.ema[key])


@pytest.fixture
def cuda_default_tf32():
    """The card under PyTorch's default TF32 settings (cuDNN convolutions may
    take TF32; matmuls not), restored afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
def test_inception_features_on_the_card_are_fp32(cuda_default_tf32):
    """The feature function runs its forward in fp32 whatever the caller's
    TF32 setting: the card's features match the CPU's within 1e-4 x max, and
    the caller's setting is left as it was."""
    import copy

    from gmpi_tpu_torch.eval import inception

    model = inception.InceptionV3()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           inception.random_params(seed=1).items()}, strict=True)
    x = np.random.default_rng(0).random((6, 3, 256, 256), np.float32)
    ref = inception.make_feature_fn(copy.deepcopy(model), batch=4, device="cpu")(x)
    fn = inception.make_feature_fn(model, batch=4, device=cuda_default_tf32)
    out, again = fn(x), fn(x)
    assert torch.backends.cudnn.allow_tf32
    assert out.shape == (6, 2048) and np.array_equal(out, again)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.gpu
def test_fused_harness_render_at_224_matches_banded(cuda):
    """``FakeImageGenerator(use_fused=True)`` at the geometry task's 224^2
    (ragged tiles) at full FFHQ256 width: one forward launch per render call,
    and the banded render of the same MPI and views within 5e-4."""
    from gmpi_tpu_torch.eval.harness import FakeImageGenerator
    from gmpi_tpu_torch.models.generator import Generator

    cfg = get_config("FFHQ256")
    g = Generator(cfg.generator_cfg(), generator=torch.Generator().manual_seed(3))
    fused = FakeImageGenerator(cfg, g, img_size=224, use_fused=True, device=cuda)
    banded = FakeImageGenerator(cfg, g, img_size=224, use_fused=False, device=cuda)
    assert banded.tiled_bands is not None
    mpi = fused.sample_mpi(seed=5).expand(2, -1, -1, -1, -1)
    yaws, pitches = fused.sample_views(seed=5, n_views=2)
    before = dict(fused_render.LAUNCHES)
    color, depth = fused.render(mpi, yaws, pitches)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fused_render.LAUNCHES.items() if v != before[k]} == {
        "fused_fwd": 1}
    color_b, depth_b = banded.render(mpi, yaws, pitches)
    assert color.shape == (2, 3, 224, 224)
    assert float((color - color_b).abs().max()) <= 5e-4
    assert float((depth - depth_b).abs().max()) <= 5e-4
