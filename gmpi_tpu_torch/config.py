"""Typed experiment configuration (port of ``gmpi_tpu/config.py``).

The same frozen dataclass presets as the JAX package, field for field, so a
configuration reads the same in both.  Serving (``eval.harness``), the
train step (``train.step``) and the training loop (``train.loop``, which
reads ``total_iters``) read them.  Every field acts (``renderer_plane_chunk``
and ``debug_ray_check`` on the step's non-fused routes) except two kinds
that raise ``NotImplementedError``: ``fused_compute_dtype`` in
``make_train_step`` (bf16 textures in the fused kernels, ``ROADMAP`` Queue
A4) and ``renderer_plane_shards`` / ``renderer_tile_shards`` > 1 in
``train.loop.train`` (the sharded renderers, Queue A9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from gmpi_tpu_torch.core.poses import SphereCameraConfig


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    n_planes: int = 32
    min_d: float = 0.95
    max_d: float = 1.12
    distance_sample_method: str = "inverse"
    enlarge_factor: float = 1.001
    confined: bool = True
    align_corners: bool = True


@dataclasses.dataclass(frozen=True)
class StepHparams:
    batch_size: int
    img_size: int
    tex_size: int
    batch_split: int
    gen_lr: float
    disc_lr: float


@dataclasses.dataclass(frozen=True)
class TrainHparams:
    """Optimization and loss settings of the train step.
    ``use_fused_renderer=None`` means the fused kernels on a CUDA device and
    the gather path on the CPU.  See the module docstring for the fields that
    still raise."""

    betas: Tuple[float, float] = (0.0, 0.9)
    weight_decay: float = 0.0
    r1_lambda: float = 10.0
    grad_clip: float = 10.0
    mapping_lr_mult: float = 5e-2
    z_dim: int = 512
    w_dim: int = 512
    n_view_per_z: int = 4
    select_worst_view: bool = True
    worst_view_render_res: int = 0
    g_iters: int = 1
    train_d: bool = True
    ema_decay: float = 0.999
    ema2_decay: float = 0.9999
    d_cond_on_pose: bool = True
    d_cond_pose_dim: int = 16
    truncation_psi: float = 1.0
    total_iters: int = 5001
    aug_with_lighting: bool = True
    lighting_max_ka: float = 0.9
    lighting_max_kd: float = 0.1
    lighting_start_iter: int = 1000
    lighting_grow_n_iters: int = 1000
    train_mapping: bool = True
    train_trunk: bool = True
    renderer_plane_chunk: Optional[int] = None
    d_batch_split: bool = True
    r1_remat: bool = False
    debug_ray_check: bool = False
    use_fused_renderer: Optional[bool] = None
    fused_compute_dtype: Optional[str] = None
    fused_remat: bool = False
    renderer_plane_shards: int = 0
    renderer_tile_shards: int = 0
    use_edge_aware_loss: bool = False
    edge_aware_loss_w: float = 1.0
    edge_aware_loss_e_min: float = 0.05
    edge_aware_loss_g_min: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    cond_mode: str = "normalize_add_z"
    embed_func: str = "modulated_lrelu"
    pos_enc_multires: int = 0
    sep_background: bool = True
    build_bg_from_rgb: bool = True
    bg_ratio: float = 0.05
    only_alpha: bool = True
    gen_alpha_largest_res: int = 256
    background_alpha_full: bool = True
    final_img_act: str = "tanh"
    channel_base: int = 32768
    channel_max: int = 512
    num_bf16_res: int = 4
    conv_clamp: Optional[float] = 256.0
    cmap_dim: int = 16
    mbstd_group_size: int = 4
    xyz_ztype: str = "depth"  # "depth" | "disparity"
    use_normalized_xyz: bool = True
    normalized_xyz_range: str = "01"  # "01" | "-11"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    resolution: int
    camera: SphereCameraConfig
    planes: PlaneConfig
    hparams: StepHparams
    train: TrainHparams
    model: ModelPreset
    fov_deg: float = 12.6
    eval_n_planes: int = 96

    def multi_res_xyz(self, geom, tex_size: Optional[int] = None):
        """Conditioning grids with this preset's xyz options, on ``geom``'s device."""
        from gmpi_tpu_torch.core.geometry import multi_res_xyz

        return multi_res_xyz(
            geom, tex_size or self.hparams.tex_size,
            normalized=self.model.use_normalized_xyz,
            value_range=self.model.normalized_xyz_range,
            ztype=self.model.xyz_ztype,
        )

    def generator_cfg(self):
        from gmpi_tpu_torch.models.generator import GeneratorCfg, SynthesisNetworkCfg

        fmaps = 0.5 if self.resolution == 256 else 1.0  # STYLEGAN2_CFG_SPECS
        return GeneratorCfg(
            z_dim=self.train.z_dim,
            w_dim=self.train.w_dim,
            img_resolution=self.resolution,
            background_alpha_full=self.model.background_alpha_full,
            final_img_act=self.model.final_img_act,
            synthesis=SynthesisNetworkCfg(
                w_dim=self.train.w_dim,
                img_resolution=self.resolution,
                channel_base=int(self.model.channel_base * fmaps),
                channel_max=self.model.channel_max,
                num_bf16_res=self.model.num_bf16_res if self.resolution > 128 else 0,
                conv_clamp=self.model.conv_clamp if self.resolution > 128 else None,
                pos_enc_multires=self.model.pos_enc_multires,
                cond_mode=self.model.cond_mode,
                embed_func=self.model.embed_func,
                sep_background=self.model.sep_background,
                build_bg_from_rgb=self.model.build_bg_from_rgb,
                bg_ratio=self.model.bg_ratio,
                only_alpha=self.model.only_alpha,
                gen_alpha_largest_res=self.model.gen_alpha_largest_res,
            ),
        )

    def discriminator_cfg(self):
        from gmpi_tpu_torch.models.discriminator import DiscriminatorCfg

        fmaps = 0.5 if self.resolution == 256 else 1.0
        return DiscriminatorCfg(
            c_dim=self.train.d_cond_pose_dim if self.train.d_cond_on_pose else 0,
            img_resolution=self.resolution,
            channel_base=int(self.model.channel_base * fmaps),
            channel_max=self.model.channel_max,
            num_bf16_res=self.model.num_bf16_res if self.resolution > 128 else 0,
            conv_clamp=self.model.conv_clamp if self.resolution > 128 else None,
            cmap_dim=self.model.cmap_dim,
            mbstd_group_size=self.model.mbstd_group_size,
        )

    def plane_geometry(self, device="cuda"):
        from gmpi_tpu_torch.core.geometry import build_plane_geometry

        return build_plane_geometry(
            n_planes=self.planes.n_planes,
            min_d=self.planes.min_d,
            max_d=self.planes.max_d,
            distance_sample_method=self.planes.distance_sample_method,
            fov_deg=self.fov_deg,
            sphere_center_z=self.camera.sphere_center_z,
            sphere_r=self.camera.sphere_r,
            yaw_mean=self.camera.yaw_mean,
            yaw_std=self.camera.yaw_std,
            pitch_mean=self.camera.pitch_mean,
            pitch_std=self.camera.pitch_std,
            n_truncated_stds=self.camera.n_truncated_stds,
            enlarge_factor=self.planes.enlarge_factor,
            confined=self.planes.confined,
            device=device,
        )


def _ffhq(resolution: int, batch_size: int, batch_split: int) -> ExperimentConfig:
    return ExperimentConfig(
        name=f"FFHQ{resolution}",
        resolution=resolution,
        fov_deg=12.6,
        camera=SphereCameraConfig(
            sphere_center_z=1.0, sphere_r=1.0,
            yaw_mean=0.0, yaw_std=0.289, pitch_mean=0.0, pitch_std=0.127,
            n_truncated_stds=2.0, sample_method="truncated_gaussian",
        ),
        planes=PlaneConfig(min_d=0.95, max_d=1.12),
        hparams=StepHparams(batch_size, resolution, resolution, batch_split, 0.002, 0.002),
        train=TrainHparams(),
        model=ModelPreset(),
    )


PRESETS: Dict[str, ExperimentConfig] = {
    "FFHQ256": _ffhq(256, 8, 1),
    "FFHQ512": _ffhq(512, 4, 1),
    "FFHQ1024": _ffhq(1024, 4, 2),
    "AFHQCat": ExperimentConfig(
        name="AFHQCat",
        resolution=512,
        fov_deg=13.39,
        camera=SphereCameraConfig(
            sphere_center_z=2.7, sphere_r=2.7,
            yaw_mean=0.0, yaw_std=0.19, pitch_mean=0.0, pitch_std=0.15,
            n_truncated_stds=3.0, sample_method="truncated_gaussian",
        ),
        planes=PlaneConfig(min_d=2.55, max_d=2.8),
        hparams=StepHparams(4, 512, 512, 1, 0.002, 0.002),
        train=TrainHparams(),
        model=ModelPreset(),
    ),
    "MetFaces": ExperimentConfig(
        name="MetFaces",
        resolution=1024,
        fov_deg=12.6,
        camera=SphereCameraConfig(
            sphere_center_z=1.0, sphere_r=1.0,
            yaw_mean=0.0, yaw_std=0.339, pitch_mean=0.0, pitch_std=0.133,
            n_truncated_stds=2.0, sample_method="truncated_gaussian",
        ),
        planes=PlaneConfig(min_d=0.95, max_d=1.12),
        hparams=StepHparams(4, 1024, 1024, 2, 0.002, 0.002),
        train=TrainHparams(),
        model=ModelPreset(),
    ),
}


def get_config(name: str, **overrides) -> ExperimentConfig:
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
