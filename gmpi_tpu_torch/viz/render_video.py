"""Camera-path rendering: single images, horizontal/vertical sweeps, videos,
and MPI plane sheets (port of ``gmpi_tpu/viz/render_video.py``).

Capability parity with ``gmpi/eval/vis/render_video.py``: generate ONE MPI
(optionally plane-chunked), render a sweep of cameras through it, save
``rendered.png`` / ``mpi_{rgb,alpha,rgba}.png`` sheets, and rgb+depth mp4s
(imageio-ffmpeg when available, else a PNG frame directory).  Frames render
through ``render_mpi_chunked`` without tile bands (the per-pixel gather), as
in the JAX package, so no custom kernel runs here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

from gmpi_tpu_torch.config import ExperimentConfig
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses as poses_mod
from gmpi_tpu_torch.core.renderer import render_mpi_chunked
from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.utils.device import resolve_device


def sweep_angles(cfg: ExperimentConfig, n_frames: int, horizontal: bool = True) -> np.ndarray:
    """±n_truncated_stds sweep around the pose mean (``render_video.py`` path
    construction): ``[n_frames, 2]`` (yaw, pitch)."""
    c = cfg.camera
    sweep = np.linspace(-c.n_truncated_stds, c.n_truncated_stds, n_frames)
    if horizontal:
        yaws = sweep * c.yaw_std + c.yaw_mean
        pitches = np.full(n_frames, c.pitch_mean)
    else:
        yaws = np.full(n_frames, c.yaw_mean)
        pitches = sweep * c.pitch_std + c.pitch_mean
    return np.stack([yaws, pitches], axis=1)


@torch.no_grad()
def render_camera_path(
    cfg: ExperimentConfig,
    generator: Generator,
    seed: int = 0,
    n_frames: int = 100,
    horizontal: bool = True,
    n_planes: Optional[int] = None,
    img_size: Optional[int] = None,
    chunk_n_planes: int = -1,
    render_plane_chunk: Optional[int] = None,
    truncation_psi: float = 1.0,
    angles: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One MPI from the z of ``seed`` rendered along a camera path: returns
    (frames [N,H,W,3] uint8, depth_frames [N,H,W] uint8, mpi [L,4,T,T]).
    ``generator`` moves to ``device`` and into eval mode."""
    dev = resolve_device(device)
    G = generator.to(dev).eval()
    n_planes = n_planes or cfg.eval_n_planes
    img_size = img_size or cfg.resolution
    eval_cfg = dataclasses.replace(cfg, planes=dataclasses.replace(cfg.planes, n_planes=n_planes))
    geom = eval_cfg.plane_geometry(device=dev)
    xyz_dict = cfg.multi_res_xyz(geom)
    intr = cam.intrinsics_from_fov(cfg.fov_deg, img_size, img_size)

    z = torch.randn((1, cfg.train.z_dim), generator=torch.Generator().manual_seed(seed))
    mpi = generate_mpi(G, z.to(dev), xyz_dict, n_planes, chunk_n_planes=chunk_n_planes,
                       truncation_psi=truncation_psi, noise_mode="const")

    if angles is None:
        angles = sweep_angles(cfg, n_frames, horizontal)
    rchunk = render_plane_chunk or n_planes
    frames, depths = [], []
    for yaw, pitch in angles:
        c2w, _, _ = poses_mod.sample_sphere_poses(
            None, 1, cfg.camera, given_yaws=torch.tensor([[yaw]], dtype=torch.float32),
            given_pitches=torch.tensor([[pitch]], dtype=torch.float32), device=dev)
        ray_dir, eye, z_dir = cam.generate_rays(intr, c2w)
        out = render_mpi_chunked(mpi, geom.dhw, ray_dir, eye, z_dir, plane_chunk=rchunk,
                                 align_corners=cfg.planes.align_corners)
        color, depth = out.color[0].cpu().numpy(), out.depth[0, 0].cpu().numpy()
        frames.append(np.clip(color.transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8))
        dn = (depth - cfg.planes.min_d) / (cfg.planes.max_d - cfg.planes.min_d)
        depths.append((np.clip(dn, 0, 1) * 255).astype(np.uint8))
    return np.stack(frames), np.stack(depths), mpi[0].cpu().numpy()


def save_mpi_sheets(out_dir: str, mpi: np.ndarray, max_planes: int = 32) -> None:
    """Save concatenated per-plane rgb / alpha / rgba sheets
    (``render_video.py`` mpi_{rgb,alpha,rgba}.png)."""
    os.makedirs(out_dir, exist_ok=True)
    sel = np.linspace(0, mpi.shape[0] - 1, min(max_planes, mpi.shape[0])).astype(int)
    rgb = np.concatenate([mpi[i, :3].transpose(1, 2, 0) for i in sel], axis=1)
    alpha = np.concatenate([mpi[i, 3] for i in sel], axis=1)
    rgba_premult = np.concatenate(
        [(mpi[i, :3] * mpi[i, 3:4]).transpose(1, 2, 0) for i in sel], axis=1)
    for name, sheet in (("mpi_rgb.png", rgb), ("mpi_alpha.png", alpha),
                        ("mpi_rgba.png", rgba_premult)):
        Image.fromarray((np.clip(sheet, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(out_dir, name))


def save_video(path: str, frames: np.ndarray, fps: int = 25) -> str:
    """mp4 via imageio-ffmpeg; without imageio or its ffmpeg backend, a PNG
    frame directory beside ``path`` (the JAX package's behaviour).  Returns
    what was written."""
    try:
        import imageio

        imageio.mimwrite(path, list(frames), fps=fps, quality=8)
        return path
    except (ImportError, ValueError, RuntimeError):  # no imageio, or no ffmpeg backend
        frame_dir = os.path.splitext(path)[0] + "_frames"
        os.makedirs(frame_dir, exist_ok=True)
        for i, fr in enumerate(frames):
            Image.fromarray(fr).save(os.path.join(frame_dir, f"{i:04d}.png"))
        return frame_dir


def render_video_artifacts(
    cfg: ExperimentConfig,
    generator: Generator,
    out_dir: str,
    seed: int = 0,
    n_frames: int = 100,
    horizontal: bool = True,
    **kwargs,
) -> Tuple[str, str]:
    """Full ``render_video.py`` artifact set: rendered.png + sheets + mp4s
    (or frame directories); returns where the rgb and depth videos went."""
    os.makedirs(out_dir, exist_ok=True)
    frames, depths, mpi = render_camera_path(
        cfg, generator, seed=seed, n_frames=n_frames, horizontal=horizontal, **kwargs)
    Image.fromarray(frames[len(frames) // 2]).save(os.path.join(out_dir, "rendered.png"))
    save_mpi_sheets(out_dir, mpi)
    rgb = save_video(os.path.join(out_dir, "rgb.mp4"), frames)
    depth = save_video(os.path.join(out_dir, "depth.mp4"),
                       np.repeat(depths[..., None], 3, axis=-1))
    return rgb, depth
