"""InceptionV3 pool3 feature extractor as an ``nn.Module`` (port of
``gmpi_tpu/eval/inception.py``).

The same network as the JAX package: torchvision's InceptionV3 with
pytorch-fid's FID blocks (``fid_variant=True``: average pools that exclude
padding in the A, C and E_1 blocks, a 3x3 max pool in E_2), fed images in
[0, 1] that are resized to 299^2 and scaled to [-1, 1] by ``2x - 1`` (no
ImageNet normalisation), pooled globally to 2048 features.

Module names are the torchvision / pytorch-fid state-dict names
(``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_var``), so
``load_state_dict`` takes a converted torchvision or pytorch-fid checkpoint:
:func:`convert_torch_state_dict` only drops ``fc.*``, ``AuxLogits.*`` and
``num_batches_tracked``.  Batch norm runs in its eval form only (running
statistics, eps 1e-3).

The resize antialiases, as ``jax.image.resize(..., "bilinear")`` does when it
downsamples; pytorch-fid's own resize does not.  The repository holds no
weights: pass a local ``.npz`` or ``.pth`` to :func:`load_params`.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gmpi_tpu_torch.utils.device import resolve_device


class _BatchNorm(nn.Module):
    """``BatchNorm2d`` in its eval form: running statistics, eps 1e-3."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-3)


class BasicConv2d(nn.Module):
    """torchvision's ``BasicConv2d``: conv (no bias), batch norm, relu."""

    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x, count_include_pad: bool):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid: bool):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        # pytorch-fid: avg_pool count_include_pad=False
        bp = self.branch_pool(_avg_pool(x, count_include_pad=not self.fid))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid: bool):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool(x, count_include_pad=not self.fid))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool``: ``"avg"`` (torchvision), ``"avg_fid"`` (pytorch-fid's
    ``FIDInceptionE_1``: padding excluded) or ``"max"`` (``FIDInceptionE_2``)."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)  # pads with -inf
        else:
            bp = _avg_pool(x, count_include_pad=self.pool == "avg")
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
    """InceptionV3 trunk up to pool3: ``x [N, 3, H, W]`` in [0, 1] ->
    ``[N, 2048]``.  ``fid_variant=False`` selects the plain torchvision
    blocks.  Its parameters hold PyTorch's default init until a state dict is
    loaded."""

    def __init__(self, fid_variant: bool = True):
        super().__init__()
        fid = fid_variant
        self.fid_variant = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_fid" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg")

    def forward(self, x):
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=True)
        x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def convert_torch_state_dict(sd: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """A torchvision / pytorch-fid state dict -> the module's: float32 CPU
    tensors, without ``fc.*``, ``AuxLogits.*`` and ``num_batches_tracked``."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked" or parts[0] in ("fc", "AuxLogits"):
            continue
        if isinstance(val, torch.Tensor):
            out[key] = val.detach().to("cpu", torch.float32)
        else:
            out[key] = torch.from_numpy(np.array(val, np.float32))
    return out


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Weights from ``.npz`` (flat torch naming) or a torch ``.pth`` state
    dict, converted by :func:`convert_torch_state_dict`."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            sd = {k: data[k] for k in data.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torch_state_dict(sd)


def load_inception(path: str, fid_variant: bool = True) -> InceptionV3:
    """An :class:`InceptionV3` holding the weights of ``path`` (CPU)."""
    model = InceptionV3(fid_variant)
    model.load_state_dict(load_params(path), strict=True)
    return model.eval()


def state_dict_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's nested parameter tree (numpy leaves) -> the module's
    state dict, exactly."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out[".".join(prefix + (k,))] = torch.from_numpy(np.array(v, np.float32))

    walk(tree, ())
    return out


def random_params(seed: int = 0, fid_variant: bool = True) -> Dict[str, np.ndarray]:
    """Seeded random weights under the module's names, drawn with numpy (for
    tests and smoke runs): He-scaled conv weights and batch-norm statistics
    away from the identity, so every branch contributes."""
    rng = np.random.default_rng(seed)
    out = {}
    with torch.device("meta"):
        shapes = {k: tuple(t.shape) for k, t in InceptionV3(fid_variant).state_dict().items()}
    for key, shape in shapes.items():
        if key.endswith("conv.weight"):
            fan_in = int(np.prod(shape[1:]))
            val = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif key.endswith("running_mean") or key.endswith("bias"):
            val = rng.standard_normal(shape) * 0.1
        else:  # running_var, weight
            val = rng.uniform(0.5, 1.5, shape)
        out[key] = val.astype(np.float32)
    return out


def make_feature_fn(model: InceptionV3, batch: int = 32, device="cuda"
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """Batched numpy-in / numpy-out pool3 extractor for the eval harness:
    ``images [N, 3, H, W]`` in [0, 1] -> ``[N, 2048]`` float32.  ``model``
    moves to ``device``.  On a card the forward runs in fp32 whatever the
    caller's TF32 settings (cuDNN's default would take TF32 convolutions) and
    with deterministic cuDNN algorithms, so a rerun repeats its features."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.no_grad()
    def feature_fn(images: np.ndarray) -> np.ndarray:
        out = []
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            for i in range(0, len(images), batch):
                x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch], np.float32))
                out.append(model(x.to(dev)).cpu().numpy())
        return np.concatenate(out)

    return feature_fn
