"""Synthetic toy MPIs: renderer fixtures of known geometry (port of
``gmpi_tpu/utils/toy_mpi.py``, numpy throughout).

Capability parity with the reference's toy-MPI builders
(``gmpi/utils/mpi_utils.py:93-245`` ``mpi_from_content_imgs``, ``:302-357``
``mpi_from_plane_imgs``, ``:475-618`` ``gen_plane_imgs_from_objs``): build an
``[L, 4, H, W]`` RGBA plane stack from colored primitives placed on specific
planes, with an opaque background on the last plane — the "known geometry"
input for renderer verification (parallax/occlusion/depth are predictable).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def blank_mpi(n_planes: int, tex: int, background_rgb=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Transparent planes with an opaque constant background on the last
    plane; [L, 4, tex, tex] in [0, 1]."""
    mpi = np.zeros((n_planes, 4, tex, tex), np.float32)
    mpi[-1, :3] = np.asarray(background_rgb, np.float32).reshape(3, 1, 1)
    mpi[-1, 3] = 1.0
    return mpi


def add_rect(
    mpi: np.ndarray,
    plane: int,
    rgb: Sequence[float],
    center: Tuple[float, float] = (0.5, 0.5),
    size: Tuple[float, float] = (0.25, 0.25),
    alpha: float = 1.0,
) -> np.ndarray:
    """Place an opaque colored rectangle on one plane (fractional coords)."""
    _, _, h, w = mpi.shape
    cy, cx = center
    sy, sx = size
    r0, r1 = int((cy - sy / 2) * h), int((cy + sy / 2) * h)
    c0, c1 = int((cx - sx / 2) * w), int((cx + sx / 2) * w)
    mpi[plane, :3, r0:r1, c0:c1] = np.asarray(rgb, np.float32).reshape(3, 1, 1)
    mpi[plane, 3, r0:r1, c0:c1] = alpha
    return mpi


def add_disk(
    mpi: np.ndarray,
    plane: int,
    rgb: Sequence[float],
    center: Tuple[float, float] = (0.5, 0.5),
    radius: float = 0.15,
    alpha: float = 1.0,
) -> np.ndarray:
    _, _, h, w = mpi.shape
    yy, xx = np.mgrid[0:h, 0:w]
    mask = ((yy / h - center[0]) ** 2 + (xx / w - center[1]) ** 2) < radius**2
    mpi[plane, :3, mask] = np.asarray(rgb, np.float32).reshape(1, 3)
    mpi[plane, 3, mask] = alpha
    return mpi


def checkerboard_mpi(n_planes: int, tex: int, cells: int = 8) -> np.ndarray:
    """Per-plane offset checkerboards — dense-texture fixture for warp
    accuracy tests (every plane distinguishable)."""
    mpi = blank_mpi(n_planes, tex)
    yy, xx = np.mgrid[0:tex, 0:tex]
    for p in range(n_planes):
        board = (((yy * cells // tex) + (xx * cells // tex) + p) % 2).astype(np.float32)
        shade = 0.3 + 0.7 * (p + 1) / n_planes
        mpi[p, 0] = board * shade
        mpi[p, 1] = board * (1 - shade)
        mpi[p, 2] = (1 - board) * shade
        mpi[p, 3] = board * 0.8
    mpi[-1, 3] = 1.0
    return mpi


def layered_scene(
    n_planes: int = 4,
    tex: int = 256,
    seed: int = 0,
) -> np.ndarray:
    """A canonical verification scene: one colored square per foreground
    plane at staggered positions + gray background — near planes occlude far
    ones, parallax ordered by depth."""
    rng = np.random.default_rng(seed)
    mpi = blank_mpi(n_planes, tex, background_rgb=(0.3, 0.3, 0.3))
    colors = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1)]
    for p in range(n_planes - 1):
        cx = 0.3 + 0.4 * (p % 3) / 2 + rng.uniform(-0.03, 0.03)
        cy = 0.35 + 0.3 * (p % 2) + rng.uniform(-0.03, 0.03)
        add_rect(mpi, p, colors[p % len(colors)], center=(cy, cx), size=(0.18, 0.18))
    return mpi


def mpi_from_plane_images(
    plane_rgbas: List[np.ndarray],
    dmin: float = 1.0,
    dmax: float = 10.0,
    method: str = "inverse",
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Build an MPI from explicit per-plane RGBA images
    (``mpi_utils.py:302-357`` ``mpi_from_plane_imgs``).

    ``plane_rgbas``: list of ``[H, W, 4]`` uint8 images **back-to-front**
    (first element = furthest plane).  Plane spatial extents follow the
    reference's convention ``(h, w) = (d, 1.3 d)``.

    Returns ``(rgba [L,4,H,W] float in [0,1] front-to-back, dhw [L,3],
    fg_range)`` where ``fg_range`` is the row/col bounding box of the front
    plane's nonzero alpha.
    """
    from gmpi_tpu_torch.core.geometry import sample_distance

    assert plane_rgbas and all(p.ndim == 3 and p.shape[2] == 4 for p in plane_rgbas)
    n = len(plane_rgbas)
    d = np.sort(sample_distance(dmin, dmax, n, method))
    front_to_back = list(reversed(plane_rgbas))
    rgba = np.stack(
        [p.astype(np.float32).transpose(2, 0, 1) / 255.0 for p in front_to_back]
    )
    dhw = np.stack([d, d, 1.3 * d], axis=1).astype(np.float32)
    rows, cols = np.nonzero(front_to_back[0][..., 3] > 0)
    fg_range = {
        "min_row": int(rows.min()), "max_row": int(rows.max()),
        "min_col": int(cols.min()), "max_col": int(cols.max()),
    } if rows.size else {}
    return rgba, dhw, fg_range


def mpi_from_content_images(
    tex: int,
    contents: List[Optional[np.ndarray]],
    content_hws: List[Optional[Tuple[int, int]]],
    positions: Optional[List[Optional[Tuple[int, int]]]] = None,
    dmin: float = 1.0,
    dmax: float = 10.0,
    method: str = "inverse",
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Paste RGBA content images onto plane canvases
    (``mpi_utils.py:93-245`` ``mpi_from_content_imgs``, simplified surface).

    One entry per plane, front-to-back; ``None`` content = fully transparent
    plane.  Each content image (``[h, w, 4]`` uint8) is nearest-resized to
    ``content_hws[i]`` and pasted at ``positions[i]`` (top-left pixel; random
    in-bounds if ``None``).  The last plane is made opaque (background).

    Returns ``(rgba [L,4,tex,tex] float in [0,1], dhw [L,3])``.
    """
    from gmpi_tpu_torch.core.geometry import sample_distance

    rng = np.random.default_rng(seed)
    n = len(contents)
    positions = positions or [None] * n
    d = np.sort(sample_distance(dmin, dmax, n, method))
    rgba = np.zeros((n, 4, tex, tex), np.float32)
    for i, (content, hw, pos) in enumerate(zip(contents, content_hws, positions)):
        if content is None:
            continue
        h, w = hw if hw is not None else content.shape[:2]
        ys = (np.arange(h) * content.shape[0] / h).astype(int)
        xs = (np.arange(w) * content.shape[1] / w).astype(int)
        patch = content[ys][:, xs].astype(np.float32) / 255.0  # [h, w, 4]
        if pos is None:
            pos = (int(rng.integers(0, max(1, tex - h))), int(rng.integers(0, max(1, tex - w))))
        r0, c0 = pos
        h = min(h, tex - r0)
        w = min(w, tex - c0)
        rgba[i, :, r0 : r0 + h, c0 : c0 + w] = patch[:h, :w].transpose(2, 0, 1)
    rgba[-1, 3] = 1.0
    dhw = np.stack([d, d, 1.3 * d], axis=1).astype(np.float32)
    return rgba, dhw
