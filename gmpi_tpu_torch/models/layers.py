"""StyleGAN2 layer library as ``nn.Module``s (port of ``gmpi_tpu/models/layers.py``).

Parameter names and storage conventions (``weight`` stored as
``randn / lr_multiplier``, runtime gains, bias before activation) are those
of StyleGAN2-ADA and of the JAX package's param trees, so a JAX tree maps onto
``state_dict`` keys by joining its path with dots
(``gmpi_tpu_torch.models.converter``).  Constructors draw initial weights from
an optional ``torch.Generator`` on the CPU; move the built module with
``.to(device)``.  ``resample_filter`` is a non-persistent buffer: a constant,
not part of the state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from gmpi_tpu_torch.ops.bias_act import activation_funcs, bias_act
from gmpi_tpu_torch.ops.conv2d import conv2d_resample
from gmpi_tpu_torch.ops.modulated_conv import modulated_conv2d
from gmpi_tpu_torch.ops.upfirdn2d import setup_filter
from gmpi_tpu_torch.utils.inspect import profile_scope

FLOATING_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class BatchShare:
    """A random generator for a process that holds share ``share`` of
    ``n_shares`` equal shares of a batch: passed to the generator's forward in
    place of ``generator``, it has ``SynthesisLayer`` draw the random noise of
    the whole batch and keep this share's, so that data-parallel ranks, each
    running its share from a generator in the same state, draw exactly the
    noise that one process running the whole batch draws."""

    generator: Optional[torch.Generator]
    share: int
    n_shares: int


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + eps)


def instance_mean_std(feat: torch.Tensor, eps: float = FLOATING_EPS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) spatial mean and std, unbiased variance."""
    n, c = feat.shape[:2]
    flat = feat.reshape(n, c, -1)
    m = flat.shape[2]
    mean = torch.mean(flat, dim=2).reshape(n, c, 1, 1)
    var = torch.var(flat, dim=2, correction=0) * (m / max(m - 1, 1)) + eps
    return mean, torch.sqrt(var).reshape(n, c, 1, 1)


def minibatch_std(x: torch.Tensor, group_size: Optional[int], num_channels: int = 1,
                  process_group=None) -> torch.Tensor:
    """Append cross-sample stddev channels (``MinibatchStdLayer``): the std
    over each group of ``group_size`` samples, averaged over channels and
    pixels.  ``group_size`` must divide the batch.  With ``process_group``
    (data-parallel ranks, each holding its share of the batch in rank order)
    the groups are those of the whole batch: the features are gathered
    differentiably over the ranks and each keeps its own samples' channels."""
    if process_group is not None:
        from gmpi_tpu_torch.parallel import mesh as mesh_mod

        n = x.shape[0]
        full = minibatch_std(mesh_mod.gather_batch(x, process_group), group_size,
                             num_channels)
        r = mesh_mod.group_rank(process_group)
        return torch.cat([x, full[r * n:(r + 1) * n, x.shape[1]:]], dim=1)
    n, c, h, w = x.shape
    g = min(group_size, n) if group_size is not None else n
    f = num_channels
    y = x.reshape(g, -1, f, c // f, h, w)
    y = y - y.mean(dim=0)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4)).reshape(-1, f, 1, 1)
    return torch.cat([x, y.repeat(g, 1, h, w).to(x.dtype)], dim=1)


def _randn(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32)


def _filter_buffer(module: nn.Module, taps: Sequence[int]) -> None:
    module.register_buffer("resample_filter", torch.from_numpy(setup_filter(list(taps))),
                           persistent=False)


class FullyConnected(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(_randn((out_features, in_features), generator) / lr_multiplier)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init))) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype) * (self.lr_multiplier / np.sqrt(self.in_features))
        b = self.bias
        if b is not None:
            b = b.to(x.dtype)
            if self.lr_multiplier != 1.0:
                b = b * self.lr_multiplier
        x = x @ w.t()
        if self.activation == "linear":
            return x + b if b is not None else x
        return bias_act(x, b, axis=x.ndim - 1, act=self.activation)


class Conv2d(nn.Module):
    """Conv2dLayer: weight-gain conv, optional up/down FIR, bias_act."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, bias: bool = True,
                 activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter: Tuple[int, ...] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.kernel_size = in_channels, kernel_size
        self.activation, self.up, self.down, self.conv_clamp = activation, up, down, conv_clamp
        self.weight = nn.Parameter(_randn((out_channels, in_channels, kernel_size, kernel_size),
                                          generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        _filter_buffer(self, resample_filter)

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        k = self.kernel_size
        w = self.weight.to(x.dtype) * (1.0 / np.sqrt(self.in_channels * k * k))
        f = self.resample_filter if (self.up > 1 or self.down > 1) else None
        x = conv2d_resample(x, w, f=f, up=self.up, down=self.down, padding=k // 2,
                            flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        b = None if self.bias is None else self.bias.to(x.dtype)
        return bias_act(x, b, act=self.activation, gain=act_gain, clamp=act_clamp)


class SynthesisLayer(nn.Module):
    """Modulated 3x3 conv + noise + lrelu, optional 2x upsample."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, use_noise: bool = True,
                 activation: str = "lrelu", resample_filter: Tuple[int, ...] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resolution, self.kernel_size, self.up = resolution, kernel_size, up
        self.use_noise, self.activation, self.conv_clamp = use_noise, activation, conv_clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(_randn((out_channels, in_channels, kernel_size, kernel_size),
                                          generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if use_noise:
            self.noise_strength = nn.Parameter(torch.zeros(()))
            self.register_buffer("noise_const", _randn((resolution, resolution), generator))
        _filter_buffer(self, resample_filter)

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise_mode: str = "const",
                generator: Union[torch.Generator, BatchShare, None] = None,
                gain: float = 1.0) -> torch.Tensor:
        assert noise_mode in ("random", "const", "none")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            n, share, n_shares = x.shape[0], 0, 1
            if isinstance(generator, BatchShare):
                share, n_shares, generator = generator.share, generator.n_shares, generator.generator
            with profile_scope("host_draw.noise"):
                noise = _randn((n * n_shares, 1, self.resolution, self.resolution),
                               generator)[share * n:(share + 1) * n].to(x.device)
            noise = noise * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = self.noise_const * self.noise_strength
        x = modulated_conv2d(
            x, self.weight, styles, noise=noise, up=self.up, padding=self.kernel_size // 2,
            resample_filter=self.resample_filter if self.up > 1 else None,
            flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias.to(x.dtype), act=self.activation, gain=act_gain,
                        clamp=act_clamp)


def _expand_styles_per_plane(styles: torch.Tensor, n_planes: int) -> torch.Tensor:
    """[B, C] -> [B * n_planes, C], plane-major within each sample."""
    bs, c = styles.shape
    return styles[:, None, :].expand(bs, n_planes, c).reshape(bs * n_planes, c)


class ToRGB(nn.Module):
    """1x1 modulated conv without demodulation + bias + clamp; ``splitted``
    repeats the style per plane so one call covers every (sample, plane)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, kernel_size: int = 1,
                 conv_clamp: Optional[float] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.kernel_size, self.conv_clamp = in_channels, kernel_size, conv_clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(_randn((out_channels, in_channels, kernel_size, kernel_size),
                                          generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor, splitted: bool = False,
                n_planes: int = 1) -> torch.Tensor:
        k = self.kernel_size
        styles = self.affine(w) * (1.0 / np.sqrt(self.in_channels * k * k))
        if splitted:
            styles = _expand_styles_per_plane(styles, n_planes)
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias.to(x.dtype), clamp=self.conv_clamp)


class ToRGBDeeperModulated(nn.Module):
    """4-layer stack of style-modulated 1x1 convs (no demodulation), each
    followed by activation + clamp: the paper's ``modulated_lrelu`` depth
    embedding head.  Parameters ``affine{i}``, ``weight{i}``, ``bias{i}``."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 intermediate_channels: Tuple[int, int, int], kernel_size: int = 1,
                 conv_clamp: Optional[float] = None, act_name: str = "lrelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = [in_channels, *intermediate_channels, out_channels]
        self.chans = list(zip(c[:-1], c[1:]))
        self.kernel_size, self.conv_clamp, self.act_name = kernel_size, conv_clamp, act_name
        for i, (cin, cout) in enumerate(self.chans, start=1):
            setattr(self, f"affine{i}", FullyConnected(w_dim, cin, bias_init=1.0,
                                                       generator=generator))
            setattr(self, f"weight{i}", nn.Parameter(
                _randn((cout, cin, kernel_size, kernel_size), generator)))
            setattr(self, f"bias{i}", nn.Parameter(torch.zeros(cout)))

    def forward(self, x: torch.Tensor, w: torch.Tensor, splitted: bool = False,
                n_planes: int = 1) -> torch.Tensor:
        k = self.kernel_size
        for i, (cin, _cout) in enumerate(self.chans, start=1):
            styles = getattr(self, f"affine{i}")(w) * (1.0 / np.sqrt(cin * k * k))
            if splitted:
                styles = _expand_styles_per_plane(styles, n_planes)
            x = modulated_conv2d(x, getattr(self, f"weight{i}"), styles, demodulate=False)
            x = bias_act(x, getattr(self, f"bias{i}").to(x.dtype), clamp=self.conv_clamp,
                         act=self.act_name)
        return x
