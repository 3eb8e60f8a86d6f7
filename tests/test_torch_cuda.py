"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it runs on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

Without a CUDA card every test skips.  Tolerance 1e-4 absolute: the kernel
and its plain version evaluate the same fp32 formula and differ only in FMA
contraction.
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
    before = fused_render.LAUNCHES
    out = fused_render.warp_composite_fwd(rgba, rx, ry, q, scal, with_disp=with_disp)
    ref = fused_render.warp_composite_fwd_ref(rgba, rx, ry, q, scal, with_disp=with_disp)
    torch.cuda.synchronize()
    assert fused_render.LAUNCHES == before + 1
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
