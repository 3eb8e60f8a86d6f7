"""Pose-conditioned StyleGAN2 discriminator (port of
``gmpi_tpu/models/discriminator.py``).

Downsampling blocks in one of StyleGAN2's three architectures (``resnet``,
the paper's; ``skip``, which also feeds each block the downsampled image
through its own ``fromrgb``; ``orig``, neither), a minibatch-stddev
epilogue, and projection conditioning on the flattened world-to-camera
matrix: ``score = (out . cmap) / sqrt(cmap_dim)`` with ``cmap =
normalize_2nd_moment(Linear(flat_pose))``.  Blocks at the top
``num_bf16_res`` resolutions run in bfloat16; the epilogue is always
float32.  The same frozen dataclass configs as the JAX package;
``Discriminator(cfg)`` is the ``nn.Module`` built from them, with state-dict
keys equal to the JAX param-tree paths (``b256.conv0.weight``,
``mapping.bias``, ``b4.fc.weight``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from gmpi_tpu_torch.models.layers import (Conv2d, FullyConnected, minibatch_std,
                                          normalize_2nd_moment)
from gmpi_tpu_torch.ops.upfirdn2d import downsample2d, setup_filter

ARCHITECTURES = ("orig", "skip", "resnet")


@dataclasses.dataclass(frozen=True)
class DiscriminatorBlockCfg:
    in_channels: int  # 0 = first block (uses fromrgb)
    tmp_channels: int
    out_channels: int
    resolution: int
    img_channels: int = 3
    architecture: str = "resnet"
    activation: str = "lrelu"
    conv_clamp: Optional[float] = None
    use_bf16: bool = False


class DiscriminatorBlock(nn.Module):
    """One resolution: ``fromrgb`` (on the first block, and on every block
    under ``skip``), conv0, conv1 with 2x downsampling; under ``resnet`` the
    downsampled 1x1 skip, both halves scaled by sqrt(0.5); under ``skip``
    the image goes on downsampled with the [1, 3, 3, 1] filter."""

    def __init__(self, cfg: DiscriminatorBlockCfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.architecture not in ARCHITECTURES:
            raise ValueError(f"architecture {cfg.architecture!r} is none of {ARCHITECTURES}")
        self.cfg = cfg
        kw = dict(activation=cfg.activation, conv_clamp=cfg.conv_clamp, generator=generator)
        if cfg.in_channels == 0 or cfg.architecture == "skip":
            self.fromrgb = Conv2d(cfg.img_channels, cfg.tmp_channels, 1, **kw)
        self.conv0 = Conv2d(cfg.tmp_channels, cfg.tmp_channels, 3, **kw)
        self.conv1 = Conv2d(cfg.tmp_channels, cfg.out_channels, 3, down=2, **kw)
        if cfg.architecture == "resnet":
            self.skip = Conv2d(cfg.tmp_channels, cfg.out_channels, 1, bias=False, down=2,
                               generator=generator)
        self.register_buffer("resample_filter", torch.from_numpy(setup_filter([1, 3, 3, 1])),
                             persistent=False)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(x, img)`` -> ``(x, img)``; ``img`` is None past the first block
        unless the architecture is ``skip``."""
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        if x is not None:
            x = x.to(dtype)
        if cfg.in_channels == 0 or cfg.architecture == "skip":
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = downsample2d(img, self.resample_filter) if cfg.architecture == "skip" else None
        if cfg.architecture == "resnet":
            y = self.skip(x, gain=np.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=np.sqrt(0.5))
            return y + x, img
        return self.conv1(self.conv0(x)), img


@dataclasses.dataclass(frozen=True)
class DiscriminatorEpilogueCfg:
    in_channels: int
    cmap_dim: int
    resolution: int = 4
    img_channels: int = 3
    architecture: str = "resnet"
    mbstd_group_size: Optional[int] = 4
    mbstd_num_channels: int = 1
    activation: str = "lrelu"
    conv_clamp: Optional[float] = None
    use_mbstd: bool = True


class DiscriminatorEpilogue(nn.Module):
    """Minibatch stddev, 3x3 conv, two dense layers and the pose projection."""

    def __init__(self, cfg: DiscriminatorEpilogueCfg,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        c = cfg.in_channels
        self.conv = Conv2d(c + cfg.mbstd_num_channels, c, 3, activation=cfg.activation,
                           conv_clamp=cfg.conv_clamp, generator=generator)
        self.fc = FullyConnected(c * cfg.resolution**2, c, activation=cfg.activation,
                                 generator=generator)
        self.out = FullyConnected(c, 1 if cfg.cmap_dim == 0 else cfg.cmap_dim,
                                  generator=generator)

    def forward(self, x: torch.Tensor, cmap: Optional[torch.Tensor],
                mbstd_group=None) -> torch.Tensor:
        cfg = self.cfg
        x = x.to(torch.float32)
        if cfg.use_mbstd and cfg.mbstd_num_channels > 0:
            x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_num_channels, mbstd_group)
        else:
            n, _, h, w = x.shape
            x = torch.cat([x, x.new_zeros((n, cfg.mbstd_num_channels, h, w))], dim=1)
        x = self.conv(x)
        x = self.fc(x.flatten(1))
        x = self.out(x)
        if cfg.cmap_dim > 0:
            x = torch.sum(x * cmap, dim=1, keepdim=True) * (1.0 / np.sqrt(cfg.cmap_dim))
        return x


@dataclasses.dataclass(frozen=True)
class DiscriminatorCfg:
    c_dim: int  # flattened-pose dim (16 or 9); 0 = unconditional
    img_resolution: int
    img_channels: int = 3
    architecture: str = "resnet"
    channel_base: int = 32768
    channel_max: int = 512
    num_bf16_res: int = 0
    conv_clamp: Optional[float] = None
    cmap_dim: Optional[int] = 16
    mbstd_group_size: Optional[int] = 4
    use_mbstd: bool = True

    @property
    def block_resolutions(self):
        return [2**i for i in range(int(np.log2(self.img_resolution)), 2, -1)]

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def bf16_resolution(self) -> int:
        return max(2 ** (int(np.log2(self.img_resolution)) + 1 - self.num_bf16_res), 8)

    @property
    def resolved_cmap_dim(self) -> int:
        if self.c_dim == 0:
            return 0
        return self.channels(4) if self.cmap_dim is None else self.cmap_dim

    def block_cfg(self, res: int) -> DiscriminatorBlockCfg:
        return DiscriminatorBlockCfg(
            in_channels=self.channels(res) if res < self.img_resolution else 0,
            tmp_channels=self.channels(res),
            out_channels=self.channels(res // 2),
            resolution=res,
            img_channels=self.img_channels,
            architecture=self.architecture,
            conv_clamp=self.conv_clamp,
            use_bf16=(self.num_bf16_res > 0 and res >= self.bf16_resolution),
        )

    @property
    def epilogue_cfg(self) -> DiscriminatorEpilogueCfg:
        return DiscriminatorEpilogueCfg(
            in_channels=self.channels(4),
            cmap_dim=self.resolved_cmap_dim,
            img_channels=self.img_channels,
            architecture=self.architecture,
            mbstd_group_size=self.mbstd_group_size,
            conv_clamp=self.conv_clamp,
            use_mbstd=self.use_mbstd,
        )


class Discriminator(nn.Module):
    """img ``[B, 3, R, R]`` in [-1, 1] and flat_pose ``[B, c_dim]`` -> score
    ``[B, 1]``; ``Discriminator(cfg, generator)`` draws its initial weights
    from ``generator`` (CPU), then ``.to(device)``."""

    def __init__(self, cfg: DiscriminatorCfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        for res in cfg.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(cfg.block_cfg(res), generator=generator))
        if cfg.c_dim > 0:
            # a plain nn.Linear in the reference: uniform in +-1/sqrt(fan_in)
            self.mapping = nn.Linear(cfg.c_dim, cfg.resolved_cmap_dim)
            bound = 1.0 / np.sqrt(cfg.c_dim)
            with torch.no_grad():
                for p in self.mapping.parameters():
                    p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)
        self.b4 = DiscriminatorEpilogue(cfg.epilogue_cfg, generator=generator)

    def forward(self, img: torch.Tensor, flat_pose: Optional[torch.Tensor] = None,
                mbstd_group=None) -> torch.Tensor:
        """Scores ``[N, 1]`` of ``img [N, 3, R, R]`` in [-1, 1].  ``mbstd_group``:
        the process group of data-parallel ranks whose batches together form
        the batch the minibatch std groups (``layers.minibatch_std``)."""
        x = None
        for res in self.cfg.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img)
        cmap = None
        if self.cfg.c_dim > 0:
            cmap = normalize_2nd_moment(self.mapping(flat_pose.to(torch.float32)))
        return self.b4(x, cmap, mbstd_group)
