"""MPI generator — StyleGAN2 backbone whose toRGB path emits multiplane images
(port of ``gmpi_tpu/models/generator.py``).

Static architecture choices live in the same frozen dataclass configs as in
the JAX package (``GeneratorCfg`` -> ``SynthesisNetworkCfg`` ->
``SynthesisBlockCfg``); the networks are ``nn.Module``s built from them:
``Generator(cfg)`` holds ``mapping`` and ``synthesis`` (blocks ``b4`` ...
``b{res}``), with state-dict keys equal to the JAX param-tree paths.

Every variant of the JAX package is built: the conditioning modes
(``cond_mode``) ``add_z``, ``normalize_add_z`` (the paper's), ``add_xyz``,
``normalize_add_xyz``, ``cat_xyz``, ``cond_z`` and ``cond_xyz``; the depth
embeddings (``embed_func``) ``mlp``, ``conv_<act>``, ``modulated_<act>`` (the
paper's ``modulated_lrelu``) and ``learnable_param`` (a learned token per
training plane, re-sampled to another plane count by ``z_interpolation_ws``);
the shared-RGB ``toalpha`` head (``only_alpha``) or the per-plane ``torgba``
head; label conditioning (``c_dim > 0``); the separately synthesized
background built from the shared RGB; const or random noise; truncation.
Blocks at the top ``num_bf16_res`` resolutions run in bfloat16; the MPI
accumulator and output stay float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gmpi_tpu_torch.models.layers import (
    FLOATING_EPS,
    Conv2d,
    FullyConnected,
    SynthesisLayer,
    ToRGB,
    ToRGBDeeperModulated,
    instance_mean_std,
    normalize_2nd_moment,
)
from gmpi_tpu_torch.ops.upfirdn2d import setup_filter, upsample2d

COND_MODES = ("add_z", "normalize_add_z", "add_xyz", "normalize_add_xyz", "cat_xyz", "cond_z",
              "cond_xyz")


def pos_enc_dim(multires: int) -> int:
    return 1 + 2 * multires


def apply_pos_enc(x: torch.Tensor, multires: int) -> torch.Tensor:
    """NeRF positional encoding along the last axis (identity for 0)."""
    if multires == 0:
        return x
    outs = [x]
    for k in range(multires):
        outs += [torch.sin(x * 2.0**k), torch.cos(x * 2.0**k)]
    return torch.cat(outs, dim=-1)


class MappingNetwork(nn.Module):
    """z, and with ``c_dim > 0`` the label ``c`` (its ``embed`` layer,
    normalized, concatenated after z), -> broadcast w's."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, num_ws: int, num_layers: int = 8,
                 lr_multiplier: float = 0.01, w_avg_beta: float = 0.995,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.num_ws, self.num_layers, self.w_avg_beta = num_ws, num_layers, w_avg_beta
        if c_dim > 0:
            self.embed = FullyConnected(c_dim, w_dim, generator=generator)
        feats = [z_dim + (w_dim if c_dim > 0 else 0)] + [w_dim] * num_layers
        for i in range(num_layers):
            setattr(self, f"fc{i}", FullyConnected(feats[i], feats[i + 1], activation="lrelu",
                                                   lr_multiplier=lr_multiplier,
                                                   generator=generator))
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z: Optional[torch.Tensor], c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0, truncation_cutoff: Optional[int] = None
                ) -> torch.Tensor:
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.to(torch.float32))
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.to(torch.float32)))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        ws = x[:, None, :].expand(x.shape[0], self.num_ws, self.w_dim)
        if truncation_psi != 1.0:
            if truncation_cutoff is None:
                ws = self.w_avg + truncation_psi * (ws - self.w_avg)
            else:
                trunc = self.w_avg + truncation_psi * (ws[:, :truncation_cutoff] - self.w_avg)
                ws = torch.cat([trunc, ws[:, truncation_cutoff:]], dim=1)
        return ws

    @torch.no_grad()
    def updated_w_avg(self, ws: torch.Tensor) -> torch.Tensor:
        """New ``w_avg`` after seeing a batch of ws: ``mean(w).lerp(w_avg, beta)``."""
        batch_mean = ws[:, 0, :].mean(dim=0)
        return batch_mean + self.w_avg_beta * (self.w_avg - batch_mean)


@dataclasses.dataclass(frozen=True)
class SynthesisBlockCfg:
    in_channels: int  # 0 = first block (learned const input)
    out_channels: int
    w_dim: int
    resolution: int
    is_last: bool
    use_bf16: bool = False
    architecture: str = "skip"
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    conv_clamp: Optional[float] = None
    pos_enc_multires: int = 0
    cond_mode: str = "normalize_add_z"
    embed_func: str = "modulated_lrelu"
    sep_background: bool = True
    build_bg_from_rgb: bool = True
    bg_ratio: float = 0.05
    only_alpha: bool = True
    gen_alpha_largest_res: int = 256
    img_channels: int = 4
    n_planes_train: int = 32  # token count of embed_func="learnable_param"

    @property
    def gen_alpha_this_res(self) -> bool:
        return self.gen_alpha_largest_res >= self.resolution

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    @property
    def num_torgb(self) -> int:
        return 1

    @property
    def pos_enc_total_ch(self) -> int:
        per_axis = pos_enc_dim(self.pos_enc_multires)
        if self.cond_mode in ("cond_xyz", "cat_xyz"):
            return per_axis * 3
        return per_axis


class SynthesisTrunk(nn.Module):
    """The trunk of one resolution (learned const or 2x-up ``conv0``, then
    ``conv1``) and its boundary-interpolated background feature; the heads
    are the subclasses'."""

    def __init__(self, cfg: SynthesisBlockCfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        g = generator
        c, res = cfg.out_channels, cfg.resolution
        if cfg.in_channels == 0:
            self.const = nn.Parameter(torch.randn((c, res, res), generator=g))
        else:
            self.conv0 = SynthesisLayer(cfg.in_channels, c, cfg.w_dim, res, up=2,
                                        resample_filter=cfg.resample_filter,
                                        conv_clamp=cfg.conv_clamp, generator=g)
        self.conv1 = SynthesisLayer(c, c, cfg.w_dim, res, conv_clamp=cfg.conv_clamp, generator=g)
        self.register_buffer("resample_filter",
                             torch.from_numpy(setup_filter(list(cfg.resample_filter))),
                             persistent=False)

    def trunk(self, x: Optional[torch.Tensor], block_ws: torch.Tensor, noise_mode: str,
              generator: Optional[torch.Generator], stop_trunk_grad: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """``(x, conv1's w, index of the head's w in block_ws)``."""
        cfg = self.cfg
        bs, res = block_ws.shape[0], cfg.resolution
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        if cfg.in_channels == 0:
            x = self.const.to(dtype)[None].expand(bs, cfg.out_channels, res, res)
            w_conv1, w_idx = block_ws[:, 0], 1
        else:
            x = self.conv0(x.to(dtype), block_ws[:, 0], noise_mode, generator)
            w_conv1, w_idx = block_ws[:, 1], 2
        x = self.conv1(x, w_conv1, noise_mode, generator)
        return (x.detach() if stop_trunk_grad else x), w_conv1, w_idx

    def _background_feature(self, x: torch.Tensor) -> torch.Tensor:
        """Linearly interpolate between the boundary columns of the (detached)
        feature map."""
        res = self.cfg.resolution
        xd = x.detach()
        pad = max(1, int(np.floor(self.cfg.bg_ratio * res)))
        start, end = pad, res - pad
        left, right = xd[:, :, :, :pad], xd[:, :, :, res - pad:]
        if start < end:
            cols = torch.arange(start, end, dtype=torch.float32, device=x.device).reshape(1, 1, 1, -1)
            ratios = (cols - start) / (end - start + FLOATING_EPS)
            lf = xd[:, :, :, start:start + 1]
            rf = xd[:, :, :, end - 1:end]
            mid = (1.0 - ratios) * lf + ratios * rf
            # mid is float32 (ratios promote it), so a bf16 block builds its
            # background feature in float32, as the JAX package does
            return torch.cat([left.to(mid.dtype), mid, right.to(mid.dtype)], dim=3)
        return torch.cat([left, right], dim=3)


class SynthesisBlock(SynthesisTrunk):
    """One resolution of the skip-architecture trunk plus its MPI head."""

    def __init__(self, cfg: SynthesisBlockCfg, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        if cfg.cond_mode not in COND_MODES:
            raise ValueError(f"cond_mode {cfg.cond_mode!r} is none of {COND_MODES}")
        if cfg.sep_background and not (cfg.build_bg_from_rgb and cfg.only_alpha):
            raise ValueError("sep_background needs build_bg_from_rgb and only_alpha")
        g = generator
        c = cfg.out_channels
        if cfg.gen_alpha_this_res and cfg.cond_mode != "cat_xyz":
            for name in self.embed_names:
                if cfg.embed_func == "learnable_param":
                    # a learned token per training plane
                    self.register_parameter(name + "_learnable_param", nn.Parameter(
                        torch.rand((1, cfg.n_planes_train, c, 1, 1), generator=g)))
                    self.register_buffer(name + "_learnable_param_left_append",
                                         torch.zeros((1, 1, c, 1, 1)))
                else:
                    setattr(self, name, self._embed_head(g))
        # cat_xyz widens the alpha / rgba head's input by the encoded xyz
        head_in = c + (cfg.pos_enc_total_ch if cfg.cond_mode == "cat_xyz" else 0)
        if cfg.only_alpha:
            self.torgb = ToRGB(c, 3, cfg.w_dim, conv_clamp=cfg.conv_clamp, generator=g)
            if cfg.gen_alpha_this_res:
                self.toalpha = ToRGB(head_in, 1, cfg.w_dim, conv_clamp=cfg.conv_clamp, generator=g)
        else:
            self.torgba = ToRGB(head_in, cfg.img_channels, cfg.w_dim, conv_clamp=cfg.conv_clamp,
                                generator=g)

    @property
    def embed_names(self) -> Tuple[str, ...]:
        """The embedding heads: one per axis for ``add_xyz`` and
        ``normalize_add_xyz``, else one."""
        mode = self.cfg.cond_mode
        if "xyz" in mode and mode.startswith(("add", "normalize")):
            return ("pos_enc_embed_x", "pos_enc_embed_y", "pos_enc_embed_z")
        return ("pos_enc_embed",)

    def _embed_head(self, g: Optional[torch.Generator]) -> nn.Module:
        """One head from pos-enc channels to feature channels."""
        cfg = self.cfg
        c, ch = cfg.out_channels, cfg.pos_enc_total_ch
        if cfg.embed_func == "mlp":
            return FullyConnected(ch, c, activation="linear", generator=g)
        if cfg.embed_func.startswith("conv"):
            act = cfg.embed_func.split("_")[1]
            return nn.Sequential(*[
                Conv2d(cin, cout, 1, bias=False, activation=act, conv_clamp=cfg.conv_clamp,
                       generator=g)
                for cin, cout in ((ch, c // 4), (c // 4, c // 2), (c // 2, c))])
        if cfg.embed_func.startswith("modulated"):
            act = cfg.embed_func.split("_")[1]
            return ToRGBDeeperModulated(ch, c, cfg.w_dim, (c // 4, c // 2, c),
                                        conv_clamp=cfg.conv_clamp, act_name=act, generator=g)
        raise ValueError(cfg.embed_func)

    @staticmethod
    def _apply_head(head: nn.Module, x: torch.Tensor, w: torch.Tensor, n_planes: int
                    ) -> torch.Tensor:
        """Run one embedding head on NCHW ``x``."""
        if isinstance(head, FullyConnected):
            n, c, hh, ww = x.shape
            out = head(x.permute(0, 2, 3, 1).reshape(-1, c))
            return out.reshape(n, hh, ww, -1).permute(0, 3, 1, 2)
        if isinstance(head, nn.Sequential):
            return head(x)
        return head(x, w, splitted=True, n_planes=n_planes)

    def _embed_z(self, z_vals: torch.Tensor, w: torch.Tensor, bs: int, n_planes: int,
                 name: str = "pos_enc_embed",
                 z_interpolation_ws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-plane depth embedding -> ``[bs * L, C, 1, 1]``."""
        cfg = self.cfg
        if cfg.embed_func == "learnable_param":
            tokens = getattr(self, name + "_learnable_param")  # [1, L_train, C, 1, 1]
            if z_interpolation_ws is not None:
                # blend neighbouring tokens, with the boundary sentinels
                left = getattr(self, name + "_learnable_param_left_append")
                ext = torch.cat([left, tokens, tokens[:, -1:]], dim=1)  # [1, L_train + 2, ...]
                n_tgt, n_src = z_interpolation_ws.shape
                ws_r = z_interpolation_ws.to(ext).reshape(1, n_tgt, n_src, 1, 1, 1)
                tokens = torch.sum(ext[:, None] * ws_r, dim=2)  # [1, n_tgt, C, 1, 1]
            assert tokens.shape[1] == n_planes, (tuple(tokens.shape), n_planes)
            return tokens.expand(bs, n_planes, *tokens.shape[2:]).reshape(bs * n_planes, -1, 1, 1)
        head = getattr(self, name)
        enc = apply_pos_enc(z_vals.reshape(n_planes, 1), cfg.pos_enc_multires)  # [L, pos_ch]
        if isinstance(head, ToRGBDeeperModulated):
            inp = enc[None].expand(bs, n_planes, enc.shape[-1]).reshape(bs * n_planes, -1, 1, 1)
            return head(inp, w, splitted=True, n_planes=n_planes)
        out = self._apply_head(head, enc.reshape(n_planes, -1, 1, 1), w, n_planes)
        return out.repeat(bs, 1, 1, 1)

    def _embed_axis(self, vals: torch.Tensor, w: torch.Tensor, bs: int, n_planes: int,
                    name: str, horizontal: bool) -> torch.Tensor:
        """Per-plane x (or y) line embedding -> ``[bs * L, C, 1, W]`` (or
        ``[bs * L, C, H, 1]``)."""
        res = self.cfg.resolution
        enc = apply_pos_enc(vals.reshape(n_planes * res, 1), self.cfg.pos_enc_multires)
        head = getattr(self, name)
        if isinstance(head, ToRGBDeeperModulated):
            # the reference's layout: [res, L, pos_ch] per sample, w repeated per line
            enc_rl = enc.reshape(n_planes, res, -1).permute(1, 0, 2)
            inp = enc_rl[None].expand(bs, res, n_planes, enc.shape[-1]).reshape(
                bs * res * n_planes, -1, 1, 1)
            w_rep = w[:, None, :].expand(bs, res, w.shape[-1]).reshape(bs * res, -1)
            out = head(inp, w_rep, splitted=True, n_planes=n_planes)[..., 0, 0]
            out = out.reshape(bs, res, n_planes, -1).permute(0, 2, 3, 1).reshape(
                bs * n_planes, -1, res)
        else:
            out = self._apply_head(head, enc.reshape(n_planes * res, -1, 1, 1), w,
                                   n_planes)[..., 0, 0]
            out = out.reshape(n_planes, res, -1).permute(0, 2, 1).repeat(bs, 1, 1)
        return out[:, :, None, :] if horizontal else out[:, :, :, None]

    def _conditioned(self, x: torch.Tensor, xyz: torch.Tensor, w_conv1: torch.Tensor,
                     n_planes: int, z_interpolation_ws: Optional[torch.Tensor]) -> torch.Tensor:
        """The trunk feature conditioned on each plane -> ``[bs * L, C', res, res]``."""
        cfg = self.cfg
        mode = cfg.cond_mode
        bs, res = x.shape[0], cfg.resolution
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        xyz = xyz.to(torch.float32)

        def per_plane(t):
            return t[:, None].expand(bs, n_planes, *t.shape[1:]).reshape(
                bs * n_planes, -1, res, res)

        def normalized(t):
            mean, std = instance_mean_std(t.to(torch.float32))
            return ((t.to(torch.float32) - mean) / (std + FLOATING_EPS)).to(dtype)

        if mode in ("add_z", "normalize_add_z"):
            z_vals = xyz[:, 0, 0, 2] if xyz.ndim == 4 else xyz.reshape(n_planes)
            embeds = self._embed_z(z_vals.to(dtype), w_conv1, bs, n_planes,
                                   z_interpolation_ws=z_interpolation_ws)
            cond_x = normalized(x) if mode == "normalize_add_z" else x
            return per_plane(cond_x) + embeds.to(dtype)
        if mode in ("add_xyz", "normalize_add_xyz"):
            ex = self._embed_axis(xyz[:, 0, :, 0].to(dtype), w_conv1, bs, n_planes,
                                  "pos_enc_embed_x", horizontal=True)
            ey = self._embed_axis(xyz[:, :, 0, 1].to(dtype), w_conv1, bs, n_planes,
                                  "pos_enc_embed_y", horizontal=False)
            ez = self._embed_z(xyz[:, 0, 0, 2].to(dtype), w_conv1, bs, n_planes,
                               "pos_enc_embed_z")
            cond_x = normalized(x) if mode == "normalize_add_xyz" else x
            return per_plane(cond_x) + ex.to(dtype) + ey.to(dtype) + ez.to(dtype)
        enc = apply_pos_enc(xyz.reshape(n_planes, res, res, 3, 1), cfg.pos_enc_multires)
        if mode == "cat_xyz":
            enc = enc.reshape(n_planes, res, res, -1).permute(0, 3, 1, 2)  # [L, 3 * pos, res, res]
            return torch.cat([per_plane(x), enc.repeat(bs, 1, 1, 1).to(dtype)], dim=1)
        # cond_z / cond_xyz: AdaIN, the instance-normalized trunk feature takes
        # the per-plane embedding map's spatial statistics.  The reference has
        # only mlp and conv heads here.  The division is by instance_mean_std's
        # std (eps inside the variance), with no outer FLOATING_EPS, unlike
        # normalize_add_*.
        head = self.pos_enc_embed
        assert isinstance(head, (FullyConnected, nn.Sequential)), (
            "cond_z/cond_xyz support mlp/conv embed functions only (reference parity)")
        enc = enc[:, :, :, 2, :] if mode == "cond_z" else enc.reshape(n_planes, res, res, -1)
        embeds = self._apply_head(head, enc.permute(0, 3, 1, 2).to(dtype), w_conv1, n_planes)
        e_mean, e_std = instance_mean_std(embeds.to(torch.float32))  # [L, C, 1, 1]
        mean, std = instance_mean_std(x.to(torch.float32))
        cond_x = per_plane((x.to(torch.float32) - mean) / std)
        return (cond_x * e_std.repeat(bs, 1, 1, 1) + e_mean.repeat(bs, 1, 1, 1)).to(dtype)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                block_ws: torch.Tensor, xyz: Optional[torch.Tensor], n_planes: int,
                noise_mode: str = "const", generator: Optional[torch.Generator] = None,
                foreground_only: bool = False, stop_trunk_grad: bool = False,
                z_interpolation_ws: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``foreground_only`` disables the background path: every plane slot
        is foreground (shared RGB + depth-conditioned alpha).
        ``stop_trunk_grad`` detaches the trunk feature, so only the MPI head
        trains."""
        cfg = self.cfg
        bs, res = block_ws.shape[0], cfg.resolution
        sep_background = cfg.sep_background and not foreground_only
        x, w_conv1, w_idx = self.trunk(x, block_ws, noise_mode, generator, stop_trunk_grad)

        if img is not None:
            img = upsample2d(img, self.resample_filter)
        w_rgba = block_ws[:, w_idx]

        cond_x = None
        if cfg.gen_alpha_this_res:
            assert xyz is not None, "conditioning coordinates required at alpha resolutions"
            cond_x = self._conditioned(x, xyz, w_conv1, n_planes, z_interpolation_ws)

        if cfg.only_alpha:
            single_rgb = self.torgb(x, w_rgba)  # [bs, 3, res, res]
            if sep_background:
                background = self.torgb(self._background_feature(x), w_rgba)
                fg = single_rgb[:, None].expand(bs, n_planes - 1, 3, res, res)
                cur_rgb = torch.cat([fg.to(background.dtype), background[:, None]], dim=1)
            else:
                cur_rgb = single_rgb[:, None].expand(bs, n_planes, 3, res, res)
            cur_rgb = cur_rgb.reshape(bs * n_planes, 3, res, res)
            if cfg.gen_alpha_this_res:
                cur_alpha = self.toalpha(cond_x, w_rgba, splitted=True, n_planes=n_planes)
            else:
                cur_alpha = torch.zeros((bs * n_planes, 1, res, res), dtype=cur_rgb.dtype,
                                        device=cur_rgb.device)
            y = torch.cat([cur_rgb, cur_alpha.to(cur_rgb.dtype)], dim=1)
        else:
            # per-plane RGBA from the conditioned feature
            y = self.torgba(cond_x, w_rgba, splitted=True, n_planes=n_planes)
        y = y.reshape(bs, n_planes * cfg.img_channels, res, res).to(torch.float32)
        img = img + y if img is not None else y
        return x, img


@dataclasses.dataclass(frozen=True)
class SynthesisNetworkCfg:
    w_dim: int
    img_resolution: int
    channel_base: int = 32768
    channel_max: int = 512
    num_bf16_res: int = 0
    conv_clamp: Optional[float] = None
    pos_enc_multires: int = 0
    cond_mode: str = "normalize_add_z"
    embed_func: str = "modulated_lrelu"
    sep_background: bool = True
    build_bg_from_rgb: bool = True
    bg_ratio: float = 0.05
    only_alpha: bool = True
    gen_alpha_largest_res: int = 256
    n_planes_train: int = 32

    @property
    def block_resolutions(self):
        return [2**i for i in range(2, int(np.log2(self.img_resolution)) + 1)]

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def bf16_resolution(self) -> int:
        return max(2 ** (int(np.log2(self.img_resolution)) + 1 - self.num_bf16_res), 8)

    def block_cfg(self, res: int) -> SynthesisBlockCfg:
        return SynthesisBlockCfg(
            in_channels=self.channels(res // 2) if res > 4 else 0,
            out_channels=self.channels(res),
            w_dim=self.w_dim,
            resolution=res,
            is_last=(res == self.img_resolution),
            use_bf16=(self.num_bf16_res > 0 and res >= self.bf16_resolution),
            conv_clamp=self.conv_clamp,
            pos_enc_multires=self.pos_enc_multires,
            cond_mode=self.cond_mode,
            embed_func=self.embed_func,
            sep_background=self.sep_background,
            build_bg_from_rgb=self.build_bg_from_rgb,
            bg_ratio=self.bg_ratio,
            only_alpha=self.only_alpha,
            gen_alpha_largest_res=self.gen_alpha_largest_res,
            n_planes_train=self.n_planes_train,
        )

    @property
    def num_ws(self) -> int:
        n = 0
        for res in self.block_resolutions:
            b = self.block_cfg(res)
            n += b.num_conv + (b.num_torgb if b.is_last else 0)
        return n


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: SynthesisNetworkCfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        for res in cfg.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlock(cfg.block_cfg(res), generator=generator))

    def forward(self, ws: torch.Tensor, xyz_dict: Optional[Dict[int, torch.Tensor]],
                n_planes: int, noise_mode: str = "const",
                generator: Optional[torch.Generator] = None,
                foreground_only: bool = False, stop_trunk_grad: bool = False,
                z_interpolation_ws: Optional[torch.Tensor] = None) -> torch.Tensor:
        ws = ws.to(torch.float32)
        x = img = None
        w_idx = 0
        for res in self.cfg.block_resolutions:
            block = getattr(self, f"b{res}")
            bcfg = block.cfg
            block_ws = ws[:, w_idx:w_idx + bcfg.num_conv + bcfg.num_torgb]
            w_idx += bcfg.num_conv
            xyz = xyz_dict.get(res) if xyz_dict is not None else None
            x, img = block(x, img, block_ws, xyz, n_planes, noise_mode=noise_mode,
                           generator=generator, foreground_only=foreground_only,
                           stop_trunk_grad=stop_trunk_grad, z_interpolation_ws=z_interpolation_ws)
        return img


@dataclasses.dataclass(frozen=True)
class GeneratorCfg:
    """Flagship MPI generator (paper defaults)."""

    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 256
    synthesis: SynthesisNetworkCfg = None  # filled in __post_init__ if None
    mapping_num_layers: int = 8
    background_alpha_full: bool = True
    final_img_act: str = "tanh"  # none | sigmoid | tanh

    def __post_init__(self):
        if self.synthesis is None:
            object.__setattr__(self, "synthesis",
                               SynthesisNetworkCfg(self.w_dim, self.img_resolution))
        assert self.synthesis.img_resolution == self.img_resolution

    @property
    def num_ws(self) -> int:
        return self.synthesis.num_ws


class Generator(nn.Module):
    """z -> MPI ``[B, L, 4, R, R]`` in [0, 1]; ``Generator(cfg, generator)``
    draws its initial weights from ``generator`` (CPU), then ``.to(device)``."""

    def __init__(self, cfg: GeneratorCfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork(cfg.z_dim, cfg.c_dim, cfg.w_dim, cfg.num_ws,
                                      cfg.mapping_num_layers, generator=generator)
        self.synthesis = SynthesisNetwork(cfg.synthesis, generator=generator)

    def synthesize(self, ws: torch.Tensor, xyz_dict: Optional[Dict[int, torch.Tensor]],
                   n_planes: int, noise_mode: str = "const",
                   generator: Optional[torch.Generator] = None,
                   foreground_only: bool = False, stop_trunk_grad: bool = False,
                   z_interpolation_ws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ws -> MPI ``[B, L, 4, R, R]``.  ``foreground_only`` generates every
        slot as foreground (no background plane, no forced background alpha).
        ``z_interpolation_ws`` (``core.geometry.plane_interp_weights``)
        re-samples ``learnable_param``'s training-plane tokens to ``n_planes``."""
        cfg = self.cfg
        img = self.synthesis(ws, xyz_dict, n_planes, noise_mode=noise_mode,
                             generator=generator, foreground_only=foreground_only,
                             stop_trunk_grad=stop_trunk_grad,
                             z_interpolation_ws=z_interpolation_ws)
        if cfg.final_img_act == "none":
            img = (torch.clamp(img, -1.0, 1.0) + 1.0) / 2.0
        elif cfg.final_img_act == "sigmoid":
            img = torch.sigmoid(img)
        elif cfg.final_img_act == "tanh":
            img = (torch.tanh(img) + 1.0) / 2.0
        else:
            raise ValueError(cfg.final_img_act)
        if cfg.background_alpha_full and not foreground_only:
            ones = torch.ones_like(img[:, :1])
            img = torch.cat([img[:, :-1], ones], dim=1)
        res = cfg.img_resolution
        return img.reshape(img.shape[0], n_planes, 4, res, res)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor],
                xyz_dict: Optional[Dict[int, torch.Tensor]], n_planes: int,
                truncation_psi: float = 1.0, truncation_cutoff: Optional[int] = None,
                noise_mode: str = "const", generator: Optional[torch.Generator] = None,
                stop_mapping_grad: bool = False, stop_trunk_grad: bool = False,
                z_interpolation_ws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full forward: z (and the label ``c`` when ``c_dim > 0``) -> MPI
        ``[B, L, 4, R, R]``.  ``stop_mapping_grad`` / ``stop_trunk_grad``
        freeze the mapping network / the synthesis trunk (their parameters get
        no gradient)."""
        ws = self.mapping(z, c, truncation_psi, truncation_cutoff)
        if stop_mapping_grad:
            ws = ws.detach()
        return self.synthesize(ws, xyz_dict, n_planes, noise_mode=noise_mode,
                               generator=generator, stop_trunk_grad=stop_trunk_grad,
                               z_interpolation_ws=z_interpolation_ws)
