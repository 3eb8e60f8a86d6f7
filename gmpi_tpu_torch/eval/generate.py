"""Eval-time MPI generation with optional plane chunking (port of
``gmpi_tpu/eval/generate.py``).

The reference evaluates with 96 planes after training with 32 and bounds
memory by running the generator on plane slices.  Its chunked call emits a
background plane with alpha forced to 1 at the end of every slice, an opaque
wall mid-volume; as in the JAX package, foreground slices are generated with
the background path off and the one true background plane is generated once,
so chunked and unchunked generation agree.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gmpi_tpu_torch.models.generator import Generator


def generate_mpi(generator: Generator, z: torch.Tensor, xyz_dict: Dict[int, torch.Tensor],
                 n_planes: int, chunk_n_planes: int = -1, truncation_psi: float = 1.0,
                 noise_mode: str = "const", rng: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """z -> MPI ``[B, n_planes, 4, R, R]`` on the generator's device."""
    z = z.to(next(generator.parameters()).device)
    if chunk_n_planes == -1 or chunk_n_planes >= n_planes:
        return generator(z, None, xyz_dict, n_planes, truncation_psi=truncation_psi,
                         noise_mode=noise_mode, generator=rng)

    ws = generator.mapping(z, None, truncation_psi)
    has_background = generator.cfg.synthesis.sep_background
    n_fg = n_planes - 1 if has_background else n_planes
    slices = []
    for start in range(0, n_fg, chunk_n_planes):
        end = min(n_fg, start + chunk_n_planes)
        sub_xyz = {r: v[start:end] for r, v in xyz_dict.items()}
        slices.append(generator.synthesize(ws, sub_xyz, end - start, noise_mode=noise_mode,
                                           generator=rng, foreground_only=True))
    if has_background:
        # one 2-plane call: slot 1 is the true background
        sub_xyz = {r: v[n_planes - 2:n_planes] for r, v in xyz_dict.items()}
        tail = generator.synthesize(ws, sub_xyz, 2, noise_mode=noise_mode, generator=rng)
        slices.append(tail[:, 1:2])
    return torch.cat(slices, dim=1)
