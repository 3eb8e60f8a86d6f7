"""Banded patch gather of the tile-banded warp (port of
``gmpi_tpu/ops/pallas_patch.py``).

:func:`gather_patches` copies, for every texture ``n`` and output tile ``t``,
the ``band_x`` x ``band_yc`` window of the x-major fused texture ``texf[n]``
that starts at ``offs[n, t]``.  On a CUDA tensor it launches the hand-written
kernel of ``csrc/patch_gather.cu`` (or raises); on a CPU tensor it runs the
plain version :func:`gather_patches_ref`, one advanced index.  Each kernel
launch adds one to ``LAUNCHES["patch_gather"]`` and to ``PATH_LAUNCHES`` under
the path it took.

:func:`launch_geometry` is how a launch cuts the patches into jobs of a few
rows (and, on the TMA path, boxes across a row), and which of the kernel's
two paths it takes, by shape: the Tensor Memory Accelerator's bulk copies
wherever the row pitches and the base address are 16-byte multiples, a
thread loop otherwise.

Unlike the TPU kernel, this one takes any in-range offsets: the alignment of
the patch starts to (8, 128) tiles is a rule of that machine's DMA, so the
port neither rounds the starts down nor widens the bands to pay for it.

There is no gradient through the kernel, as there is none through
``pallas_call``: on a tensor that requires one (outside the tiled warp's own
autograd Function, whose backward is the tiled adjoint) the call raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gmpi_tpu_torch.ops import _build
from gmpi_tpu_torch.ops._build import LAUNCHES  # noqa: F401  (launches by kernel; re-exported)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P] + [_I] * 13 + [_P]  # of gmpi_patch_gather; the last is the stream
_DTYPES = (torch.float32, torch.bfloat16)

TMA_BOX = 256  # elements a side of a TMA box, at most
# by element size: (bytes a box as stored holds at most, stages in a block's
# ring, stores in flight past the one waited for); the fastest of a sweep of
# 4-32 KB stages, 2-8 stages and 0-6 stores in flight at both of the banded
# route's input sizes (PERF.md).  bf16 wants many small blocks: half its
# starts need the warp's shift.
TMA_GEOMETRY = {4: (8 * 1024, 6, 4), 2: (4 * 1024, 4, 1)}
LOOP_ROWS = 16  # rows of a job on the loop path
PATH_LAUNCHES = {"tma": 0, "loop": 0}  # kernel launches by path


class LaunchGeometry(NamedTuple):
    """How one launch cuts each patch into jobs: ``chunks`` row chunks of
    ``rows`` rows (the last one clipped at ``band_x``), each of ``boxes``
    boxes of ``box_cols`` elements across a row (the last one clipped at
    ``band_yc``).  ``path`` is ``"tma"`` (a ring of ``stages`` shared-memory
    stages, a stage reloaded once its store has read it while the ``lag``
    newer stores stay in flight) or ``"loop"`` (``stages`` and ``lag`` 0; one
    box the row's width)."""
    path: str
    rows: int
    chunks: int
    box_cols: int
    boxes: int
    stages: int
    lag: int


def _even_split(n: int, most: int):
    """``(size, count)``: ``n`` cut into ``count`` pieces of ``size``, each at
    most ``most``, as few and as even as possible (the last may be short)."""
    count = -(-n // max(1, min(most, n)))
    size = -(-n // count)
    return size, count


def launch_geometry(hpc: int, band_x: int, band_yc: int, elem_size: int,
                    base_aligned: bool = True) -> LaunchGeometry:
    """The kernel's launch geometry for a texture of row pitch ``hpc``
    elements of ``elem_size`` bytes and patches of ``band_x`` x ``band_yc``.

    The TMA path needs 16-byte row pitches of the texture and the patches and
    a 16-byte aligned texture (``base_aligned``); any other shape takes the
    loop path.  On the TMA path a row is cut into the fewest boxes of at most
    ``TMA_BOX`` elements less one 16-byte word (a start that is not 16-byte
    aligned is loaded from the boundary below it, one word wider), each a
    multiple of 16 bytes wide, and a patch into the fewest even row chunks
    whose box fits the stage bytes of ``TMA_GEOMETRY[elem_size]``, which also
    gives the stages and the stores in flight."""
    stage_bytes, stages, lag = TMA_GEOMETRY[elem_size]
    vec = 16 // elem_size
    if not (base_aligned and hpc % vec == 0 and band_yc % vec == 0):
        rows, chunks = _even_split(band_x, LOOP_ROWS)
        return LaunchGeometry("loop", rows, chunks, band_yc, 1, 0, 0)
    boxes = -(-band_yc // (TMA_BOX - vec))
    box_cols = -(-band_yc // boxes // vec) * vec  # <= TMA_BOX - vec, a multiple of vec
    rows, chunks = _even_split(band_x, min(TMA_BOX, stage_bytes // (box_cols * elem_size)))
    return LaunchGeometry("tma", rows, chunks, box_cols, boxes, stages, lag)


def _check_args(texf, offs, band_x, band_yc) -> None:
    if texf.ndim != 3:
        raise ValueError(f"texf: expected [N, Wp, Hp*C], got {tuple(texf.shape)}")
    if offs.dtype != torch.int32 or offs.ndim != 3 or offs.shape[0] != texf.shape[0] \
            or offs.shape[2] != 2:
        raise ValueError(f"offs: expected int32 [N={texf.shape[0]}, T, 2], got {offs.dtype} "
                         f"{tuple(offs.shape)}")
    _, wp, hpc = texf.shape
    if not (1 <= band_x <= wp and 1 <= band_yc <= hpc):
        raise ValueError(f"bands ({band_x}, {band_yc}) do not fit the texture ({wp}, {hpc})")


def _check_range(texf, offs, band_x, band_yc) -> None:
    """Raise for a patch that leaves the texture (synchronizes the device)."""
    _, wp, hpc = texf.shape
    if offs.numel():
        lo = offs.amin(dim=(0, 1))
        hi = offs.amax(dim=(0, 1))
        x_lo, y_lo, x_hi, y_hi = torch.cat([lo, hi]).tolist()
        if x_lo < 0 or y_lo < 0 or x_hi + band_x > wp or y_hi + band_yc > hpc:
            raise ValueError(f"offs: a patch leaves the texture: x {x_lo}..{x_hi} + {band_x} of "
                             f"{wp}, y {y_lo}..{y_hi} + {band_yc} of {hpc}")


def gather_patches_ref(texf: torch.Tensor, offs: torch.Tensor, band_x: int, band_yc: int
                       ) -> torch.Tensor:
    """Plain PyTorch version of the patch gather: one advanced index over
    ``(n, x_lo + r, y_lo + k)``.  Differentiable (the index's backward is a
    scatter-add).  Arguments and result as :func:`gather_patches`."""
    n = texf.shape[0]
    dev = texf.device
    offs = offs.long()
    rows = offs[..., 0, None] + torch.arange(band_x, device=dev)   # [N, T, band_x]
    cols = offs[..., 1, None] + torch.arange(band_yc, device=dev)  # [N, T, band_yc]
    n_idx = torch.arange(n, device=dev).reshape(n, 1, 1, 1)
    return texf[n_idx, rows[..., None], cols[:, :, None, :]]


def gather_patches(texf: torch.Tensor, offs: torch.Tensor, band_x: int, band_yc: int,
                   validate: bool = True) -> torch.Tensor:
    """Patches ``[N, T, band_x, band_yc]`` of the fused x-major texture:
    ``out[n, t] = texf[n, x_lo:x_lo + band_x, y_lo:y_lo + band_yc]`` with
    ``(x_lo, y_lo) = offs[n, t]``.

    texf ``[N, Wp, Hp*C]`` float32 or bfloat16, contiguous (zero-padded by the
    caller); offs ``[N, T, 2]`` int32, any in-range starts.  ``validate``
    checks the offsets on the host and raises ``ValueError`` for a patch that
    leaves the texture (one device synchronization; a caller that has clamped
    its offsets passes ``False``; the kernel clamps what it is handed and
    never reads outside ``texf``).  CPU tensors run
    :func:`gather_patches_ref`; CUDA tensors launch the kernel.  No gradient:
    raises on a tensor that requires one while autograd records.
    """
    if torch.is_grad_enabled() and texf.requires_grad:
        raise RuntimeError(
            "gather_patches has no gradient (a hand-written kernel outside autograd): "
            "differentiate through make_tiled_warp_with_adjoint (4-field tiled_bands) or "
            "through grid_sample_tiled, which takes the hat contractions under autograd")
    _check_args(texf, offs, band_x, band_yc)
    if validate:
        _check_range(texf, offs, band_x, band_yc)
    if texf.device.type == "cpu":
        return gather_patches_ref(texf, offs, band_x, band_yc)
    if texf.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {texf.device}")
    if texf.dtype not in _DTYPES:
        raise TypeError(f"texf: expected float32 or bfloat16, got {texf.dtype}")
    if offs.device != texf.device or not offs.is_contiguous() or not texf.is_contiguous():
        raise ValueError("texf and offs must be contiguous and on one device")
    n, wp, hpc = texf.shape
    n_tiles = offs.shape[1]
    if n * n_tiles >= 2 ** 31 or wp >= 2 ** 31 or hpc >= 2 ** 31:
        raise ValueError(f"gather_patches: {n} x {n_tiles} patches of a {wp} x {hpc} texture "
                         f"exceed the kernel's 32-bit counts")
    out = torch.empty((n, n_tiles, band_x, band_yc), dtype=texf.dtype, device=texf.device)
    if out.numel() == 0:
        return out
    _launch(texf, offs, out, launch_geometry(hpc, band_x, band_yc, texf.element_size(),
                                             base_aligned=texf.data_ptr() % 16 == 0))
    return out


def _launch(texf, offs, out, geo: LaunchGeometry) -> None:
    """One launch of the kernel with geometry ``geo`` on checked tensors."""
    n, wp, hpc = texf.shape
    _build.launch("patch_gather", _ARGTYPES, texf.device,
                  texf.data_ptr(), offs.data_ptr(), out.data_ptr(), n, offs.shape[1], wp, hpc,
                  out.shape[2], out.shape[3], texf.element_size(), geo.rows, geo.chunks,
                  geo.box_cols, geo.boxes, geo.stages, geo.lag)
    PATH_LAUNCHES[geo.path] += 1
