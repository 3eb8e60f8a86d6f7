"""The benchmark's fixed arithmetic: the card's peaks, the least work of a
render, the FLOPs of the configurations' steps and requests, and the
reduction of a ``torch.profiler`` trace to busy time and spans.

Nothing here reads the program: a later change to the program cannot move
these counts, so a share of them bounds any gain it claims.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 80 GB data sheet: dense rates, no sparsity, at 700 W.
PEAKS = {
    "hbm_bytes_s": 3.35e12,
    "bf16": 989e12,   # tensor cores
    "tf32": 495e12,  # tensor cores; float32 convolutions under cuDNN's TF32 default
    "fp32": 67e12,  # outside the tensor cores (TF32 off)
}
# (the PCIe part: 2.0 TB/s, 756 / 378 / 51.2 TFLOP/s)
PEAKS_PCIE = {"hbm_bytes_s": 2.0e12, "bf16": 756e12, "tf32": 378e12, "fp32": 51.2e12}


def peaks_for(device_name: str) -> Dict[str, float]:
    return PEAKS_PCIE if "PCIe" in device_name else PEAKS


def render_cost(n_views: int, n_planes: int, img_h: int, img_w: int, tex_h: int, tex_w: int,
                bytes_per_el: int = 4) -> Dict[str, float]:
    """Least traffic and arithmetic of a forward MPI render (warp and
    over-composite), frozen from the port's ``utils/roofline.render_cost`` at
    ``patch_overread=1``: every texel read once, the image (3 colour channels
    and depth) written once, ~11 operations a bilinear tap and ~10 a plane and
    pixel of the composite, for 4 channels."""
    samples = n_views * n_planes * img_h * img_w
    tex_bytes = n_views * n_planes * 4 * tex_h * tex_w * bytes_per_el
    out_bytes = n_views * 4 * img_h * img_w * bytes_per_el
    return {"bytes": float(tex_bytes + out_bytes), "flops": float(samples * 4 * (11 + 10))}


def least_seconds_render(cost: Dict[str, float], peaks: Dict[str, float]) -> float:
    """The render's least time: the larger of its memory and its arithmetic
    bound (float32 arithmetic outside the tensor cores)."""
    return max(cost["bytes"] / peaks["hbm_bytes_s"], cost["flops"] / peaks["fp32"])


def least_seconds_flops(flops: Dict[str, float], peaks: Dict[str, float]) -> float:
    """Σ FLOPs of each precision ÷ that precision's peak."""
    return sum(n / peaks[kind] for kind, n in flops.items())


# ---- FLOPs by precision ------------------------------------------------------------

_CONV = {"convolution", "_convolution", "convolution_backward", "cudnn_convolution",
         "_slow_conv2d_forward", "convolution_overrideable"}
_MM = {"mm", "addmm", "bmm", "baddbmm"}


class FlopsByPrecision(TorchDispatchMode):
    """Counts the FLOPs of convolutions and matrix products (PyTorch's own
    formulas, ``torch.utils.flop_counter``) by the precision they run in: a
    bfloat16 operand makes it ``bf16``; a float32 convolution is ``tf32``
    (cuDNN's default for float32 convolutions, which the program keeps); a
    float32 matrix product ``fp32`` (PyTorch's default, TF32 off)."""

    def __init__(self):
        super().__init__()
        self.flops = {"bf16": 0, "tf32": 0, "fp32": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            dtypes = {a.dtype for a in args if isinstance(a, torch.Tensor)}
            name = packet.__name__
            if torch.bfloat16 in dtypes or torch.float16 in dtypes:
                self.flops["bf16"] += n
            elif name in _CONV:
                self.flops["tf32"] += n
            elif name in _MM:
                self.flops["fp32"] += n
            else:
                raise ValueError(f"no precision rule for {name}")
        return out


@contextlib.contextmanager
def count_flops():
    """``with count_flops() as c: ...`` then ``c.flops``; run the reference
    under ``precision.mode(stated=True)`` on meta tensors inside it."""
    mode = FlopsByPrecision()
    with mode:
        yield mode


def fid_request_flops(exp: dict) -> Dict[str, int]:
    """FLOPs of one FID request: the generator at batch 1 and the eval plane
    count (the render has no convolution or matrix product)."""
    from benchmark.reference import gmpi, precision

    with precision.mode(stated=True):
        G = _meta_model(gmpi.Generator, gmpi.generator_cfg(exp))
        sampler = gmpi.Sampler(exp, G, "meta")
        with count_flops() as c:
            sampler.mpi(0)
    return c.flops


def train_step_flops(exp: dict) -> Dict[str, int]:
    """FLOPs of one train step (D phase with R1, worst views, G phase)."""
    from benchmark.reference import gmpi, precision

    h, res = exp["hparams"], exp["resolution"]
    with precision.mode(stated=True):
        G = _meta_model(gmpi.Generator, gmpi.generator_cfg(exp))
        D = _meta_model(gmpi.Discriminator, gmpi.discriminator_cfg(exp))
        step = gmpi.TrainStep(exp, G, D, "meta")
        real = torch.empty((h["batch_size"], 3, res, res), device="meta")
        pose = torch.empty((h["batch_size"], exp["train"]["d_cond_pose_dim"]), device="meta")
        with count_flops() as c:
            step(exp["train"]["lighting_start_iter"] + exp["train"]["lighting_grow_n_iters"],
                 real, pose, torch.Generator().manual_seed(0))
    return c.flops


def _meta_model(cls, cfg):
    """A reference model of ``cfg`` on meta tensors: shapes, no values."""
    from benchmark.reference.gmpi import _materialize

    with torch.device("meta"):
        module = cls(cfg)
    return _materialize(module, "meta")


# ---- the trace ---------------------------------------------------------------------


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_between(busy: Sequence[Tuple[float, float]], starts: List[float], lo: float,
                 hi: float) -> float:
    """Busy time of the merged, sorted intervals ``busy`` (with their
    ``starts``) inside ``[lo, hi)``."""
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    total = 0.0
    while i < len(busy) and busy[i][0] < hi:
        s, e = busy[i]
        total += max(0.0, min(e, hi) - max(s, lo))
        i += 1
    return total


def spans_busy(trace, names: Sequence[str]) -> float:
    """Device-busy microseconds inside the device ranges of the annotations
    whose names start with any of ``names`` (overlaps counted once)."""
    ranges = merged((s, e) for name, s, e in trace.annotations if name.startswith(tuple(names)))
    return sum(busy_between(trace.busy, trace.busy_starts, s, e) for s, e in ranges)


def train_phases(trace):
    """Mean device-busy microseconds a step of the D phase (from the step's
    ``train_step.d_fakes`` to its G phase's first span) and of the G phase
    (from there to the next step's D phase, or the window's end).  A
    backward's kernels, launched from the autograd engine's thread, fall
    between their neighbouring spans and count with them.  None when the
    trace holds no whole step."""
    d = sorted(s for name, s, _ in trace.annotations if name == "train_step.d_fakes")
    g_all = sorted(s for name, s, _ in trace.annotations
                   if name in ("train_step.worst_views", "train_step.g_forward"))
    if not d:
        return None
    d_ms, g_ms = [], []
    for k, ds in enumerate(d):
        nxt = d[k + 1] if k + 1 < len(d) else trace.window[1]
        gs = next((s for s in g_all if ds < s < nxt), None)
        if gs is None:
            return None
        d_ms.append(busy_between(trace.busy, trace.busy_starts, ds, gs))
        g_ms.append(busy_between(trace.busy, trace.busy_starts, gs, nxt))
    return sum(d_ms) / len(d_ms), sum(g_ms) / len(g_ms)
