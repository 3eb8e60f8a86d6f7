"""The port's full-scale tier on the card: the counterpart of
``tests/test_tpu_full_scale.py``.

A kernel can be right at a few planes of 256^2 on the CPU and wrong at the
production shape on the card (the JAX package shipped such a fused VJP once),
so this tier runs the renderer at 96 planes of 1024^2 on a CUDA card:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_full_scale.py

It imports only torch and the port (the card's machine has no JAX); without
a card every test skips.  Covered, in the JAX file's order:

* the fused renderer's forward and ``rgba`` gradient under autograd at the
  JAX bench pose and at a +2 sigma corner of the pose range, 5e-4 of
  max|oracle| (the bench gate), against ``render_mpi_chunked(plane_chunk=4)``'s
  function evaluated in float64 from the same inputs: at the corner the
  float32 chunked gather's own texel coordinates are up to 3e-4 of a texel
  off, the fused kernels' up to 2e-4, and the two float32 renders sit 5.0e-4
  apart in the gradient (on an H100), so the float32 oracle would charge its
  own roundoff to the kernels; in place of the JAX file's third case, its
  ``HIGHEST`` MXU mode (the port has no precision modes), the bf16-texture
  form at the JAX package's bf16 gate, 2e-2;
* the banded route (``render_mpi(tiled_bands=bands_for_config(...))``, its
  taps read from the texture by the texture-sample kernel) against ``render_mpi_chunked(plane_chunk=4)`` itself, whose float32
  coordinates it shares, 5e-4;
* the G phase's renderer gradient with a pose-conditioned D, fused against
  the gather renderer: the loss, and the renderer's vector-Jacobian product
  of D's cotangent, 5e-4.
"""

import dataclasses
import types

import pytest
import torch

from chip_smoke import chunked_gather_fp64
from gmpi_tpu_torch.config import get_config
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses
from gmpi_tpu_torch.core.bands import bands_for_config
from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_chunked, render_mpi_fused
from gmpi_tpu_torch.ops import fused_render

pytestmark = pytest.mark.gpu

N_PLANES = 96
RES = 1024
TOL = 5e-4
BF16_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _config(n_planes=N_PLANES):
    cfg = get_config("FFHQ1024")
    return dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_planes))


def _rays(cfg, dev, yaws, pitches, res):
    c2w, _, _ = poses.sample_sphere_poses(None, len(yaws), cfg.camera,
                                          given_yaws=torch.tensor(yaws).reshape(-1, 1),
                                          given_pitches=torch.tensor(pitches).reshape(-1, 1),
                                          device=dev)
    return cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, res, res), c2w)


def _setup(dev, yaw, pitch):
    """FFHQ geometry at 96 planes, uniform rgba ``[1, 96, 4, 1024, 1024]`` and
    a normal colour cotangent, both seeded on the card."""
    cfg = _config()
    g = torch.Generator(device=dev).manual_seed(0)
    rgba = torch.rand((1, N_PLANES, 4, RES, RES), device=dev, generator=g)
    cot = torch.randn((1, 3, RES, RES), device=dev, generator=g)
    return cfg, cfg.plane_geometry(device=dev), rgba, _rays(cfg, dev, [yaw], [pitch], RES), cot


def _color_and_grad(render, rgba, cot):
    x = rgba.clone().requires_grad_()
    color = render(x).color
    return color.detach(), torch.autograd.grad((color * cot).sum(), x)[0]


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("yaw,pitch,compute_dtype,tol", [
    (0.1, 0.05, None, TOL),               # the bench pose
    (0.578, 0.254, None, TOL),            # +2 sigma corner of the pose range
    (0.1, 0.05, torch.bfloat16, BF16_TOL),  # bf16 textures
], ids=["bench_pose", "corner", "bf16_textures"])
def test_fused_full_scale_fwd_and_grad_allclose(cuda, yaw, pitch, compute_dtype, tol):
    _, geom, rgba, rays, cot = _setup(cuda, yaw, pitch)
    before = dict(fused_render.LAUNCHES)
    color, grad = _color_and_grad(lambda x: render_mpi_fused(
        x, geom.dhw, *rays, with_disp=False, compute_dtype=compute_dtype), rgba, cot)
    torch.cuda.synchronize()
    assert {k: fused_render.LAUNCHES[k] - before[k] for k in before} == {
        "fused_fwd": 1, "composite_bwd": 1, "splat": 1, "adjoint": 0, "patch_gather": 0,
        "patch_sample": 0, "mpi_stack": 0, "texture_sample": 0}
    color_o, grad_o = (t.float() for t in _color_and_grad(
        lambda x: types.SimpleNamespace(color=chunked_gather_fp64(x, geom.dhw, *rays)), rgba,
        cot))
    assert _rel(color, color_o) <= tol, f"fwd rel err at yaw={yaw} pitch={pitch}"
    assert _rel(grad, grad_o) <= tol, f"grad rel err at yaw={yaw} pitch={pitch}"


@pytest.mark.parametrize("yaw,pitch", [(0.1, 0.05), (0.578, 0.254)], ids=["bench_pose", "corner"])
def test_banded_full_scale_matches_oracle(cuda, yaw, pitch):
    cfg, geom, rgba, rays, cot = _setup(cuda, yaw, pitch)
    bands = bands_for_config(cfg, img_size=RES, n_planes=N_PLANES)
    before = dict(fused_render.LAUNCHES)
    color, grad = _color_and_grad(lambda x: render_mpi(
        x, geom.dhw, *rays, tiled_bands=bands), rgba, cot)
    torch.cuda.synchronize()
    # the forward's taps: one K10 launch, no K7 or K8
    assert {k: fused_render.LAUNCHES[k] - before[k] for k in ("texture_sample", "patch_gather",
                                                              "patch_sample")} == {
        "texture_sample": 1, "patch_gather": 0, "patch_sample": 0}
    color_o, grad_o = _color_and_grad(
        lambda x: render_mpi_chunked(x, geom.dhw, *rays, plane_chunk=4), rgba, cot)
    assert _rel(color, color_o) <= TOL
    assert _rel(grad, grad_o) <= TOL


def test_fused_train_gradient_matches_gather_path(cuda):
    """The gradient the G phase sends through the renderer at the MPI
    boundary (everything upstream then agrees by the chain rule), with D
    conditioned on the pose: 128^2, 8 planes, a narrow D, as the JAX file's
    case.  The loss ``sum softplus(-D(render(mpi) * 2 - 1))`` of the two
    renderers, and the renderers' gradient of D's cotangent at the gather
    render, both within 5e-4.  D's own gradient is not compared across the
    two renders: its leaky ReLUs are piecewise linear, and the 4e-5 between
    the renders moves a few pre-activations across zero, which changes d
    D / d image there by up to 2e-2 of max (on the CPU; 4.3e-3 on an H100)
    while the renderers' products of one cotangent agree within 1.7e-5."""
    from gmpi_tpu_torch.config import (ExperimentConfig, ModelPreset, PlaneConfig,
                                       StepHparams, TrainHparams)
    from gmpi_tpu_torch.core.poses import SphereCameraConfig
    from gmpi_tpu_torch.models.discriminator import Discriminator
    from gmpi_tpu_torch.train import flat_pose_from_c2w

    res = 128
    cfg = ExperimentConfig(
        name="fused_grad_check", resolution=res, fov_deg=12.6,
        camera=SphereCameraConfig(1.0, 1.0, 0.0, 0.289, 0.0, 0.127),
        planes=PlaneConfig(n_planes=8, min_d=0.95, max_d=1.12),
        hparams=StepHparams(batch_size=2, img_size=res, tex_size=res, batch_split=1,
                            gen_lr=0.002, disc_lr=0.002),
        train=TrainHparams(z_dim=32, w_dim=32, n_view_per_z=2, total_iters=1),
        model=ModelPreset(channel_base=1024, channel_max=64, num_bf16_res=0, conv_clamp=None,
                          gen_alpha_largest_res=res, mbstd_group_size=2))
    geom = cfg.plane_geometry(device=cuda)
    D = Discriminator(cfg.discriminator_cfg(), generator=torch.Generator().manual_seed(0)).to(cuda)
    g = torch.Generator().manual_seed(5)
    mpi = torch.rand((2, 8, 4, res, res), generator=g).to(cuda)
    c2w, _, _ = poses.sample_sphere_poses(g, 2, cfg.camera, device=cuda)
    rays = cam.generate_rays(cam.intrinsics_from_fov(cfg.fov_deg, res, res), c2w)
    flat_pose = flat_pose_from_c2w(c2w, cfg.train.d_cond_pose_dim)

    def loss_of(imgs):
        return torch.nn.functional.softplus(-D(imgs, flat_pose)).sum()

    with torch.no_grad():
        losses = [float(loss_of(render(mpi, geom.dhw, *rays).color * 2.0 - 1.0))
                  for render in (render_mpi_fused, render_mpi)]
    assert abs(losses[0] - losses[1]) <= TOL * abs(losses[1])
    img = (render_mpi(mpi, geom.dhw, *rays).color * 2.0 - 1.0).requires_grad_()
    cot, = torch.autograd.grad(loss_of(img), img)

    def grad_of(render):
        x = mpi.clone().requires_grad_()
        return torch.autograd.grad(((render(x, geom.dhw, *rays).color * 2.0 - 1.0)
                                    * cot).sum(), x)[0]

    grad_fused, grad_gather = grad_of(render_mpi_fused), grad_of(render_mpi)
    assert torch.isfinite(grad_fused).all()
    assert _rel(grad_fused, grad_gather) <= TOL
