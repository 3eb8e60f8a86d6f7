"""The port's viz modules (``gmpi_tpu_torch/viz``) and ``render_gmpi_torch.py``
against the JAX package's, on the CPU.

The tiny config (resolution 16, 4 planes).  ``render_camera_path`` draws its
z from each package's own generator, so both modules' ``generate_mpi`` are
replaced by one that returns the same numpy MPI; then frames and depth frames
agree within 1 level of 255 (renders within 5e-4 can land a level apart at a
truncation edge) and ``sweep_angles`` exactly.  Sheets, frame directories,
meshes and ``.ply`` files are compared byte for byte.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import render_gmpi_torch
from gmpi_tpu.viz import mesh as jax_mesh
from gmpi_tpu.viz import render_video as jax_render_video
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.train import checkpoint, init_train_state
from gmpi_tpu_torch.viz import mesh, render_video
from tests.test_torch_train_step import tiny_config
from tests.test_train import tiny_config as jax_tiny_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_mpi(seed=0, n_planes=4, res=16):
    """A seeded MPI with structure: random colours, alpha rising front to back."""
    rng = np.random.default_rng(seed)
    mpi = rng.random((1, n_planes, 4, res, res)).astype(np.float32)
    mpi[:, :, 3] *= np.linspace(0.2, 1.0, n_planes, dtype=np.float32)[None, :, None, None]
    mpi[:, -1, 3] = 1.0
    return mpi


@pytest.mark.parametrize("horizontal", [True, False])
def test_sweep_angles_equal_jax(horizontal):
    np.testing.assert_array_equal(
        render_video.sweep_angles(tiny_config(), 7, horizontal),
        jax_render_video.sweep_angles(jax_tiny_config(), 7, horizontal))


@pytest.mark.parametrize("horizontal", [True, False])
def test_render_camera_path_matches_jax(monkeypatch, horizontal):
    mpi = _tiny_mpi()
    monkeypatch.setattr(jax_render_video, "generate_mpi", lambda *a, **k: jnp.asarray(mpi))
    monkeypatch.setattr(render_video, "generate_mpi", lambda *a, **k: torch.from_numpy(mpi))
    cfg, cfg_j = tiny_config(), jax_tiny_config()
    kw = dict(seed=0, n_frames=5, horizontal=horizontal, n_planes=4, img_size=24,
              render_plane_chunk=2)
    frames, depths, mpi_out = render_video.render_camera_path(
        cfg, Generator(cfg.generator_cfg()), device="cpu", **kw)
    frames_j, depths_j, mpi_j = jax_render_video.render_camera_path(cfg_j, {}, {}, **kw)
    assert frames.shape == frames_j.shape == (5, 24, 24, 3) and frames.dtype == np.uint8
    assert depths.shape == depths_j.shape == (5, 24, 24) and depths.dtype == np.uint8
    np.testing.assert_array_equal(mpi_out, mpi_j)
    for ours, theirs in ((frames, frames_j), (depths, depths_j)):
        diff = np.abs(ours.astype(int) - theirs.astype(int))
        assert diff.max() <= 1, diff.max()
    assert len(np.unique(frames)) > 10  # the frames are not blank


def test_sheets_and_frame_directory_bytes_equal_jax(tmp_path, monkeypatch):
    mpi = _tiny_mpi(seed=1, n_planes=40)[0]  # more planes than a sheet shows
    render_video.save_mpi_sheets(str(tmp_path / "a"), mpi)
    jax_render_video.save_mpi_sheets(str(tmp_path / "b"), mpi)
    for name in ("mpi_rgb.png", "mpi_alpha.png", "mpi_rgba.png"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    assert Image.open(tmp_path / "a" / "mpi_rgb.png").size == (32 * 16, 16)

    frames = (np.random.default_rng(2).random((3, 8, 8, 3)) * 255).astype(np.uint8)
    monkeypatch.setitem(sys.modules, "imageio", None)  # as on a machine without imageio
    out = render_video.save_video(str(tmp_path / "a" / "rgb.mp4"), frames)
    out_j = jax_render_video.save_video(str(tmp_path / "b" / "rgb.mp4"), frames)
    assert out == str(tmp_path / "a" / "rgb_frames")
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(out_j)) == ["0000.png", "0001.png", "0002.png"]
    for name in names:
        assert (tmp_path / "a" / "rgb_frames" / name).read_bytes() == \
            (tmp_path / "b" / "rgb_frames" / name).read_bytes()
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(out, name))),
                                      frames[names.index(name)])


def _sphere(n=20, radius=6.0):
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    r = np.sqrt(((g - (n - 1) / 2.0) ** 2).sum(axis=0))
    return np.clip(radius + 0.5 - r, 0.0, 1.0).astype(np.float32)


def test_mesh_bitwise_equal_jax(tmp_path):
    vol = _sphere()
    verts, faces = mesh.marching_tetrahedra(vol, 0.5)
    verts_j, faces_j = jax_mesh.marching_tetrahedra(vol, 0.5)
    assert len(verts) > 100 and len(faces) > 100
    np.testing.assert_array_equal(verts, verts_j)
    np.testing.assert_array_equal(faces, faces_j)

    vmin, vmax = np.array([-1.0, -1.0, 0.5]), np.array([1.0, 1.0, 2.5])
    v, f = mesh.extract_mesh_from_alpha(vol, vmin, vmax, iso=0.1)
    v_j, f_j = jax_mesh.extract_mesh_from_alpha(vol, vmin, vmax, iso=0.1)
    np.testing.assert_array_equal(v, v_j)
    np.testing.assert_array_equal(f, f_j)
    empty = mesh.extract_mesh_from_alpha(np.zeros((4, 4, 4), np.float32), vmin, vmax)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)

    mesh.save_ply(str(tmp_path / "a.ply"), v, f)
    jax_mesh.save_ply(str(tmp_path / "b.ply"), v_j, f_j)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_volume_bounds_equal_jax():
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=6))
    geom = cfg.plane_geometry(device="cpu")
    dhw = geom.dhw.numpy()
    ours = mesh.mpi_mesh_volume_bounds(dhw, 0.95, 1.12)
    theirs = jax_mesh.mpi_mesh_volume_bounds(dhw, 0.95, 1.12)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mesh.smooth_volume(_sphere(), 1.5),
                                  jax_mesh.smooth_volume(_sphere(), 1.5))


def test_render_cli_on_a_tiny_checkpoint(tmp_path):
    cfg = tiny_config()
    state = init_train_state(cfg, torch.Generator().manual_seed(4), device="cpu")
    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    checkpoint.save_checkpoint(ckpt_dir, state)
    out_dir = str(tmp_path / "vis")
    out = render_gmpi_torch.main(["--ckpt", ckpt_dir, "--out", out_dir, "--device", "cpu",
                                  "--n_frames", "3", "--nplanes", "4", "--mesh",
                                  "--mesh_planes", "8", "--seed", "2"], cfg=cfg)
    for name in ("rendered.png", "mpi_rgb.png", "mpi_alpha.png", "mpi_rgba.png", "mesh.ply"):
        assert os.path.isfile(os.path.join(out_dir, name)), name
    for key in ("rgb", "depth"):
        assert os.path.exists(out[key])
        if os.path.isdir(out[key]):
            assert len(os.listdir(out[key])) == 3
    assert np.asarray(Image.open(os.path.join(out_dir, "rendered.png"))).shape == (16, 16, 3)
    with open(out["mesh"], "rb") as f:
        head = f.read(200).split(b"end_header\n")[0].decode()
    assert f"element vertex {out['n_verts']}" in head
    assert f"element face {out['n_faces']}" in head
    # the CLI renders the EMA weights: the same frames as render_camera_path on them
    g = checkpoint.load_generator(ckpt_dir, cfg, device="cpu")
    frames, _, _ = render_video.render_camera_path(cfg, g, seed=2, n_frames=3, n_planes=4,
                                                   device="cpu")
    np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(out_dir, "rendered.png"))),
                                  frames[1])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            render_gmpi_torch.main(["--ckpt", ckpt_dir, "--out", out_dir], cfg=cfg)
