"""Eval-time image generation (port of ``FakeImageGenerator`` from
``gmpi_tpu/eval/harness.py``): seeded MPIs from the generator, views rendered
at given or sampled poses.  FID/KID and the image dumps come in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gmpi_tpu_torch.config import ExperimentConfig
from gmpi_tpu_torch.core import camera as cam
from gmpi_tpu_torch.core import poses as poses_mod
from gmpi_tpu_torch.core.renderer import render_mpi, render_mpi_fused
from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.models.generator import Generator
from gmpi_tpu_torch.utils.device import resolve_device


class FakeImageGenerator:
    """Seeded eval-time sampler around (generator, renderer) for one config.

    ``generator`` is moved to ``device`` (CUDA by default) and put in eval
    mode.  ``use_fused`` renders through the fused warp+composite kernel (on
    the CPU, its plain PyTorch version); otherwise through the gather path.
    ``sanity_full_alpha`` forces every plane opaque, so the render collapses
    to the nearest plane's RGB (the reference's StyleGAN2 sanity mode).
    """

    def __init__(self, cfg: ExperimentConfig, generator: Generator,
                 n_planes: Optional[int] = None, img_size: Optional[int] = None,
                 chunk_n_planes: int = -1, truncation_psi: float = 1.0,
                 sanity_full_alpha: bool = False, use_fused: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.G = generator.to(self.device).eval()
        self.n_planes = n_planes or cfg.eval_n_planes
        self.img_size = img_size or cfg.resolution
        self.chunk = chunk_n_planes
        self.psi = truncation_psi
        self.sanity_full_alpha = sanity_full_alpha
        # eval-time plane geometry at the eval plane count
        eval_cfg = dataclasses.replace(
            cfg, planes=dataclasses.replace(cfg.planes, n_planes=self.n_planes))
        self.geom = eval_cfg.plane_geometry(device=self.device)
        self.xyz_dict = cfg.multi_res_xyz(self.geom)
        self.intr = cam.intrinsics_from_fov(cfg.fov_deg, self.img_size, self.img_size)
        self.use_fused = use_fused and cfg.planes.align_corners

    @torch.no_grad()
    def sample_mpi(self, seed: int, batch: int = 1) -> torch.Tensor:
        """MPI ``[batch, L, 4, R, R]`` from the z of ``seed``."""
        z = torch.randn((batch, self.cfg.train.z_dim),
                        generator=torch.Generator().manual_seed(seed))
        mpi = generate_mpi(self.G, z.to(self.device), self.xyz_dict, self.n_planes,
                           chunk_n_planes=self.chunk, truncation_psi=self.psi,
                           noise_mode="const")
        if self.sanity_full_alpha:
            mpi = torch.cat([mpi[:, :, :3], torch.ones_like(mpi[:, :, 3:4])], dim=2)
        return mpi

    def sample_views(self, seed: int, n_views: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[n_views, 1]`` yaws and pitches from the pose distribution."""
        g = torch.Generator().manual_seed(seed * 1_000_003 + 17)
        return poses_mod.sample_yaw_pitch(g, n_views, self.cfg.camera, device=self.device)

    @torch.no_grad()
    def render(self, mpi: torch.Tensor, yaws, pitches) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render ``mpi [V, L, 4, R, R]`` (one view each; may be an expand of
        one MPI) at the given angles: ``(color [V,3,H,W] in [-1,1], depth)``."""
        c2w, _, _ = poses_mod.sample_sphere_poses(
            None, mpi.shape[0], self.cfg.camera, given_yaws=yaws, given_pitches=pitches,
            device=self.device)
        ray_dir, eye, z_dir = cam.generate_rays(self.intr, c2w)
        if self.use_fused:
            out = render_mpi_fused(mpi, self.geom.dhw, ray_dir, eye, z_dir)
        else:
            out = render_mpi(mpi, self.geom.dhw, ray_dir, eye, z_dir,
                             self.cfg.planes.align_corners)
        return out.color * 2.0 - 1.0, out.depth
