"""Vanilla and depth2alpha MPI generators (port of
``gmpi_tpu/models/generator_vanilla.py``).

The reference's other two generator families:

* **vanilla** (``gmpi/models/networks/networks_vanilla.py``): each skip head
  emits everything at once: 3 shared-RGB channels, with ``sep_background``
  3 background channels (the boundary-interpolated feature through the same
  ``torgb``), and ``L`` per-plane alphas from one ``toalpha``.  The plane
  count is baked into the head: no depth conditioning, no other plane count
  at eval time.
* **depth2alpha** (``networks_vanilla_depth2alpha.py``): the head
  (``todepth``) emits one depth channel; a plane's alpha is
  ``clamp(z_plane - depth, +-range / n_bins)`` rescaled to [0, 1]
  (``:612-661``), a near step function of depth.

Both share the mapping network and the synthesis trunk of
``models/generator.py``, so their state-dict names are the main
generator's and the same converter loads them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gmpi_tpu_torch.models.generator import MappingNetwork, SynthesisBlockCfg, SynthesisTrunk
from gmpi_tpu_torch.models.layers import ToRGB
from gmpi_tpu_torch.ops.upfirdn2d import upsample2d


@dataclasses.dataclass(frozen=True)
class VanillaBlockCfg(SynthesisBlockCfg):
    """Skip block whose head emits [3 rgb (+3 bg) + head_channels] at once."""

    n_planes_fixed: int = 32
    head_type: str = "vanilla"  # vanilla -> L alphas; depth2alpha -> 1 depth

    @property
    def head_channels(self) -> int:
        return self.n_planes_fixed if self.head_type == "vanilla" else 1

    @property
    def head_key(self) -> str:
        # the reference's names: ``toalpha`` (L alphas) or ``todepth`` (1 depth)
        return "toalpha" if self.head_type == "vanilla" else "todepth"


class VanillaBlock(SynthesisTrunk):
    def __init__(self, cfg: VanillaBlockCfg, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        if cfg.head_type not in ("vanilla", "depth2alpha"):
            raise ValueError(f"head_type {cfg.head_type!r}")
        c = cfg.out_channels
        self.torgb = ToRGB(c, 3, cfg.w_dim, conv_clamp=cfg.conv_clamp, generator=generator)
        setattr(self, cfg.head_key, ToRGB(c, cfg.head_channels, cfg.w_dim,
                                          conv_clamp=cfg.conv_clamp, generator=generator))

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                block_ws: torch.Tensor, noise_mode: str = "const",
                generator: Optional[torch.Generator] = None, stop_trunk_grad: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x, _, w_idx = self.trunk(x, block_ws, noise_mode, generator, stop_trunk_grad)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        w_rgba = block_ws[:, w_idx]
        parts = [self.torgb(x, w_rgba)]
        if cfg.sep_background:
            parts.append(self.torgb(self._background_feature(x), w_rgba))
        parts.append(getattr(self, cfg.head_key)(x, w_rgba))
        y = torch.cat([p.to(torch.float32) for p in parts], dim=1)
        img = img + y if img is not None else y
        return x, img


@dataclasses.dataclass(frozen=True)
class VanillaGeneratorCfg:
    """Generator over vanilla / depth2alpha heads."""

    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 256
    n_planes: int = 32
    head_type: str = "vanilla"  # or "depth2alpha"
    channel_base: int = 32768
    channel_max: int = 512
    num_bf16_res: int = 0
    conv_clamp: Optional[float] = None
    sep_background: bool = True
    bg_ratio: float = 0.05
    # the reference's vanilla variants accept but never apply this flag
    # (``networks_vanilla.py:567``); applied here, off by default
    background_alpha_full: bool = False
    final_img_act: str = "tanh"
    mapping_num_layers: int = 8
    depth2alpha_z_range: float = 1.0
    depth2alpha_n_z_bins: int = 256

    @property
    def block_resolutions(self):
        return [2**i for i in range(2, int(np.log2(self.img_resolution)) + 1)]

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def bf16_resolution(self) -> int:
        return max(2 ** (int(np.log2(self.img_resolution)) + 1 - self.num_bf16_res), 8)

    def block_cfg(self, res: int) -> VanillaBlockCfg:
        return VanillaBlockCfg(
            in_channels=self.channels(res // 2) if res > 4 else 0,
            out_channels=self.channels(res),
            w_dim=self.w_dim,
            resolution=res,
            is_last=(res == self.img_resolution),
            use_bf16=(self.num_bf16_res > 0 and res >= self.bf16_resolution),
            conv_clamp=self.conv_clamp,
            sep_background=self.sep_background,
            build_bg_from_rgb=self.sep_background,
            bg_ratio=self.bg_ratio,
            n_planes_fixed=self.n_planes,
            head_type=self.head_type,
        )

    @property
    def num_ws(self) -> int:
        n = 0
        for res in self.block_resolutions:
            b = self.block_cfg(res)
            n += b.num_conv + (b.num_torgb if b.is_last else 0)
        return n


class VanillaGenerator(nn.Module):
    """z -> MPI ``[B, n_planes, 4, R, R]`` in [0, 1] at the fixed plane
    count; ``VanillaGenerator(cfg, generator)`` draws its initial weights
    from ``generator`` (CPU), then ``.to(device)``."""

    def __init__(self, cfg: VanillaGeneratorCfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork(cfg.z_dim, cfg.c_dim, cfg.w_dim, cfg.num_ws,
                                      cfg.mapping_num_layers, generator=generator)
        self.synthesis = nn.ModuleDict({f"b{res}": VanillaBlock(cfg.block_cfg(res), generator)
                                        for res in cfg.block_resolutions})

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor],
                xyz_dict: Optional[Dict[int, torch.Tensor]], n_planes: Optional[int] = None,
                truncation_psi: float = 1.0, noise_mode: str = "const",
                generator: Optional[torch.Generator] = None, stop_mapping_grad: bool = False,
                stop_trunk_grad: bool = False) -> torch.Tensor:
        """depth2alpha reads each plane's z from ``xyz_dict[img_resolution]``."""
        cfg = self.cfg
        n_planes = n_planes or cfg.n_planes
        assert n_planes == cfg.n_planes, "vanilla heads bake in the plane count"
        ws = self.mapping(z, c, truncation_psi)
        if stop_mapping_grad:
            ws = ws.detach()
        ws = ws.to(torch.float32)

        x = img = None
        w_idx = 0
        for res in cfg.block_resolutions:
            block = self.synthesis[f"b{res}"]
            block_ws = ws[:, w_idx:w_idx + block.cfg.num_conv + block.cfg.num_torgb]
            w_idx += block.cfg.num_conv
            x, img = block(x, img, block_ws, noise_mode, generator, stop_trunk_grad)

        if cfg.final_img_act == "none":
            img = (torch.clamp(img, -1.0, 1.0) + 1.0) / 2.0
        elif cfg.final_img_act == "sigmoid":
            img = torch.sigmoid(img)
        elif cfg.final_img_act == "tanh":
            img = (torch.tanh(img) + 1.0) / 2.0
        else:
            raise ValueError(cfg.final_img_act)

        bs, res = img.shape[0], cfg.img_resolution
        rgb = img[:, :3]
        ch = 3
        if cfg.sep_background:
            ch = 6
            fg = rgb[:, None].expand(bs, n_planes - 1, 3, res, res)
            rgb_planes = torch.cat([fg, img[:, 3:6][:, None]], dim=1)
        else:
            rgb_planes = rgb[:, None].expand(bs, n_planes, 3, res, res)
        if cfg.head_type == "vanilla":
            alpha = img[:, ch:ch + n_planes][:, :, None]  # [B, L, 1, H, W]
        else:
            depth = img[:, ch:ch + 1]  # [B, 1, H, W]
            z_diff_max = cfg.depth2alpha_z_range / cfg.depth2alpha_n_z_bins
            tex_z = xyz_dict[res][..., 2].to(torch.float32)  # [L, H, W]
            z_diff = torch.clamp(tex_z[None] - depth, -z_diff_max, z_diff_max)
            alpha = ((z_diff + z_diff_max) / (2 * z_diff_max + 1e-8))[:, :, None]
        if cfg.background_alpha_full:
            alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], dim=1)
        return torch.cat([rgb_planes, alpha], dim=2)
