"""Port parity: camera, poses and plane geometry of ``gmpi_tpu_torch`` against
``gmpi_tpu`` on the CPU.  The RNG streams differ between the packages, so
poses are compared at explicit ``given_yaws`` / ``given_pitches``.
Tolerance 1e-6 (float32 values of order 1; one ulp of a normalization)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmpi_tpu import config as jcfg
from gmpi_tpu.core import camera as jcam
from gmpi_tpu.core import geometry as jgeom
from gmpi_tpu.core import poses as jposes
from gmpi_tpu.ops.pallas_warp import plane_affine as jplane_affine
from gmpi_tpu.ops.pallas_warp import ray_fields as jray_fields
from gmpi_tpu_torch import config as tcfg
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses
from gmpi_tpu_torch.ops.fused_render import plane_affine, ray_fields
from gmpi_tpu_torch.utils.device import resolve_device

TOL = 1e-6
ANGLES = np.array([[0.0, 0.0], [0.578, 0.254], [-0.578, -0.254], [0.1, 0.05], [-0.3, 0.2]],
                  np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("preset", ["FFHQ256", "AFHQCat"])
def test_poses_and_rays_match_jax(preset):
    cj, ct = jcfg.get_config(preset), tcfg.get_config(preset)
    y, p = ANGLES[:, :1], ANGLES[:, 1:]
    c2w_j, yj, pj = jposes.sample_sphere_poses(None, len(y), cj.camera, given_yaws=y,
                                               given_pitches=p)
    c2w_t, yt, pt = poses.sample_sphere_poses(None, len(y), ct.camera, given_yaws=y,
                                              given_pitches=p, device="cpu")
    _close(c2w_j, c2w_t)
    _close(yj, yt)
    intr_j = jcam.intrinsics_from_fov(cj.fov_deg, 24, 32)
    intr_t = cam.intrinsics_from_fov(ct.fov_deg, 24, 32)
    assert tuple(intr_j) == tuple(intr_t)
    for a, b in zip(jcam.generate_rays(intr_j, c2w_j), cam.generate_rays(intr_t, c2w_t)):
        _close(a, b)


@pytest.mark.parametrize("horizontal", [True, False])
def test_linspace_poses_match_jax(horizontal):
    cj, ct = jcfg.get_config("FFHQ256"), tcfg.get_config("FFHQ256")
    for a, b in zip(jposes.linspace_sphere_poses(7, cj.camera, horizontal),
                    poses.linspace_sphere_poses(7, ct.camera, horizontal, device="cpu")):
        _close(a, b)


@pytest.mark.parametrize("preset,n_planes", [("FFHQ256", 96), ("FFHQ256", 5), ("AFHQCat", 32)])
def test_plane_geometry_and_xyz_match_jax(preset, n_planes):
    cj, ct = jcfg.get_config(preset), tcfg.get_config(preset)
    cj = dataclasses.replace(cj, planes=dataclasses.replace(cj.planes, n_planes=n_planes))
    ct = dataclasses.replace(ct, planes=dataclasses.replace(ct.planes, n_planes=n_planes))
    gj, gt = cj.plane_geometry(), ct.plane_geometry(device="cpu")
    _close(gj.dhw, gt.dhw)
    assert (gj.min_d, gj.max_d) == (gt.min_d, gt.max_d)
    xj, xt = cj.multi_res_xyz(gj, 32), ct.multi_res_xyz(gt, 32)
    assert sorted(xj) == sorted(xt) == [4, 8, 16, 32]
    for r in xj:
        _close(xj[r], xt[r])


@pytest.mark.parametrize("ztype,value_range", [("disparity", "-11"), ("depth", "01")])
def test_multi_res_xyz_options_match_jax(ztype, value_range):
    cj, ct = jcfg.get_config("FFHQ256"), tcfg.get_config("FFHQ256")
    gj, gt = cj.plane_geometry(), ct.plane_geometry(device="cpu")
    xj = jgeom.multi_res_xyz(gj, 16, value_range=value_range, ztype=ztype)
    from gmpi_tpu_torch.core.geometry import multi_res_xyz

    xt = multi_res_xyz(gt, 16, value_range=value_range, ztype=ztype)
    for r in xj:
        _close(xj[r], xt[r])


def test_plane_affine_and_ray_fields_match_jax():
    cj, ct = jcfg.get_config("FFHQ256"), tcfg.get_config("FFHQ256")
    gj, gt = cj.plane_geometry(), ct.plane_geometry(device="cpu")
    y, p = ANGLES[:, :1], ANGLES[:, 1:]
    c2w_j, _, _ = jposes.sample_sphere_poses(None, len(y), cj.camera, given_yaws=y,
                                             given_pitches=p)
    c2w_t, _, _ = poses.sample_sphere_poses(None, len(y), ct.camera, given_yaws=y,
                                            given_pitches=p, device="cpu")
    rj = jcam.generate_rays(jcam.intrinsics_from_fov(12.6, 16, 16), c2w_j)
    rt = cam.generate_rays(cam.intrinsics_from_fov(12.6, 16, 16), c2w_t)
    scal_t = plane_affine(gt.dhw, rt[1], 64, 64)
    for v in range(len(y)):
        # texel coordinates reach ~64: 1e-6 relative
        np.testing.assert_allclose(np.asarray(jplane_affine(gj.dhw, rj[1][v], 64, 64)),
                                   scal_t[v].numpy(), rtol=TOL, atol=TOL)
    for a, b in zip(jray_fields(*[jnp.asarray(x) for x in (rj[0], rj[2])]),
                    ray_fields(rt[0], rt[2])):
        _close(a, b)


def test_truncated_normal_keeps_first_in_range_candidate():
    g = torch.Generator().manual_seed(5)
    cand = torch.randn((200, 1, 4), generator=torch.Generator().manual_seed(5)) * 0.3 + 0.1
    out = poses.truncated_normal(g, (200, 1), 0.1, 0.3, 1.0)
    lo, hi = 0.1 - 0.3, 0.1 + 0.3
    expect = []
    for row in cand.reshape(200, 4).numpy():
        ok = [c for c in row if lo < c < hi]
        expect.append(ok[0] if ok else np.clip(row[0], lo, hi))
    np.testing.assert_allclose(out.reshape(-1).numpy(), np.asarray(expect, np.float32), atol=0)


@pytest.mark.parametrize("method", ["uniform", "gaussian", "truncated_gaussian"])
def test_sample_yaw_pitch_is_seeded_and_in_range(method):
    c = tcfg.get_config("FFHQ256").camera._replace(sample_method=method)
    a = poses.sample_yaw_pitch(torch.Generator().manual_seed(1), 64, c, device="cpu")
    b = poses.sample_yaw_pitch(torch.Generator().manual_seed(1), 64, c, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (64, 1) and a[0].dtype == torch.float32
    if method != "gaussian":
        assert float(a[0].abs().max()) <= c.n_truncated_stds * c.yaw_std + 1e-6


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tcfg.get_config("FFHQ256").plane_geometry()
