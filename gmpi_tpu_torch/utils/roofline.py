"""Roofline accounting for the renderer (port of ``gmpi_tpu/utils/roofline.py``).

:func:`render_cost` counts the least memory traffic and the arithmetic of an
MPI render at a given shape; :func:`attained` turns a measured time into
shares of a card's peaks.  The card's rates are a :class:`ChipSpec`: the two
H100 parts below, from NVIDIA's data sheets (dense rates, no sparsity, at the
full power limit).  :func:`chip_for` picks one from
``torch.cuda.get_device_name()``; ``attained`` has no default card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # memory bandwidth, GB/s
    fp32_tflops: float  # outside the tensor cores
    bf16_tflops: float


H100_SXM = ChipSpec(name="h100-sxm", hbm_gbps=3350.0, fp32_tflops=67.0, bf16_tflops=989.0)
H100_PCIE = ChipSpec(name="h100-pcie", hbm_gbps=2000.0, fp32_tflops=51.2, bf16_tflops=756.0)


def chip_for(device_name: str) -> ChipSpec:
    """The H100 part a ``torch.cuda.get_device_name()`` string names (PCIe
    when it says so, else SXM)."""
    return H100_PCIE if "PCIe" in device_name else H100_SXM


def render_cost(
    n_views: int,
    n_planes: int,
    img_h: int,
    img_w: int,
    tex_h: int,
    tex_w: int,
    backward: bool = False,
    bytes_per_el: int = 4,
    patch_overread: float = 2.5,
    tex_bytes_per_el: Optional[int] = None,
) -> Dict[str, float]:
    """Least-traffic and arithmetic model of warp + composite.

    The forward reads each plane texture at least once (``patch_overread``
    models the tile-banded warp's overlapping patches; 1 is the least),
    writes the composited image, and does ~11 operations a tap for the
    bilinear combine and ~10 a plane and pixel for the over-composite.  The
    backward about doubles the traffic (the texture gradient's writes) and
    the arithmetic.  ``tex_bytes_per_el`` (default ``bytes_per_el``) is the
    size of a texel read alone: 2 for the fused forward's bf16-texture form,
    whose images (and texture gradient) stay 4 bytes an element.
    """
    p_out = n_views * n_planes * img_h * img_w  # warped samples
    tex_bytes = n_views * n_planes * 4 * tex_h * tex_w * bytes_per_el
    out_bytes = n_views * 4 * img_h * img_w * bytes_per_el
    read_bytes = tex_bytes * patch_overread
    if tex_bytes_per_el is not None:
        read_bytes = read_bytes * tex_bytes_per_el / bytes_per_el
    write_bytes = out_bytes
    warp_flops = p_out * 4 * 11  # 4 channels, ~11 operations a bilinear sample
    composite_flops = p_out * 4 * 10

    if backward:
        read_bytes *= 2
        write_bytes += tex_bytes  # d/d(texture)
        warp_flops *= 2
        composite_flops *= 2

    return {
        "bytes": read_bytes + write_bytes,
        "flops": warp_flops + composite_flops,
        "samples": p_out,
    }


def attained(seconds: float, cost: Dict[str, float], chip: ChipSpec,
             dtype: str = "fp32") -> Dict[str, float]:
    """A measured time against ``chip``'s peaks: attained bandwidth and
    arithmetic rate, the least time (the larger of the memory and the
    arithmetic bound), its share of ``seconds`` and which bound it is."""
    peak_flops = (chip.fp32_tflops if dtype == "fp32" else chip.bf16_tflops) * 1e12
    t_mem = cost["bytes"] / (chip.hbm_gbps * 1e9)
    t_cmp = cost["flops"] / peak_flops
    sol = max(t_mem, t_cmp)
    return {
        "time_s": seconds,
        "speed_of_light_s": sol,
        "sol_fraction": sol / seconds if seconds > 0 else 0.0,
        "attained_gbps": cost["bytes"] / seconds / 1e9 if seconds > 0 else 0.0,
        "attained_tflops": cost["flops"] / seconds / 1e12 if seconds > 0 else 0.0,
        "bound": "memory" if t_mem >= t_cmp else "compute",
    }
