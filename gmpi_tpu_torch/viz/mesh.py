"""Mesh extraction from MPI alpha volumes — self-contained (no mcubes/trimesh).
The port's own copy of ``gmpi_tpu/viz/mesh.py`` (numpy and scipy, the same
arithmetic, so meshes and ``.ply`` bytes are equal).

Capability parity with ``gmpi/eval/vis/extract_mesh.py:18-58``: smooth the
alpha volume, extract the iso-surface at 0.01, permute axes into the MPI world
frame (+X right, +Y down, +Z forward), scale vertices into the world volume,
write a ``.ply``.

The iso-surfacer is *marching tetrahedra* (each cell split into 6 tets, the
standard 16-case table): simpler than marching cubes' 256-case table, no
vendored lookup data, and produces a watertight triangulation of the same
iso-surface.  Volume smoothing uses a Gaussian filter (the reference's
``mcubes.smooth`` constrained-smoothing analogue).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

# 6-tetrahedra decomposition of a cube (vertex ids 0..7 = binary zyx corners)
_CUBE_OFFSETS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ]
)
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
])

# tetra edge list: pairs of local vertex indices 0..3
_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_E01, _E02, _E03, _E12, _E13, _E23 = range(6)

# triangles (as edge-index triples) for cases 1..7; cases 8..14 are the
# complements with reversed winding
_CASE_TRIS = {
    0x1: [(_E01, _E02, _E03)],
    0x2: [(_E01, _E13, _E12)],
    0x3: [(_E02, _E03, _E13), (_E02, _E13, _E12)],
    0x4: [(_E02, _E12, _E23)],
    0x5: [(_E01, _E12, _E23), (_E01, _E23, _E03)],
    0x6: [(_E01, _E13, _E23), (_E01, _E23, _E02)],
    0x7: [(_E03, _E13, _E23)],
}


def smooth_volume(vol: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    return ndimage.gaussian_filter(np.asarray(vol, np.float32), sigma=sigma)


def _emit_tet_triangles(pos: np.ndarray, val: np.ndarray, iso: float) -> np.ndarray:
    """pos [N,4,3] float, val [N,4] -> triangle vertices [M,3,3]."""
    inside = val > iso
    case = (inside * np.array([1, 2, 4, 8])).sum(axis=1)
    tris = []
    for c in range(1, 15):
        base = c if c <= 7 else 15 - c
        if base not in _CASE_TRIS:
            continue
        sel = np.where(case == c)[0]
        if sel.size == 0:
            continue
        p, v = pos[sel], val[sel]
        # interpolated point on each tetra edge
        edge_pts = []
        for a, b in _EDGES:
            denom = v[:, b] - v[:, a]
            t = np.where(np.abs(denom) > 1e-12, (iso - v[:, a]) / np.where(denom == 0, 1, denom), 0.5)
            t = np.clip(t, 0.0, 1.0)[:, None]
            edge_pts.append(p[:, a] * (1 - t) + p[:, b] * t)
        for tri in _CASE_TRIS[base]:
            e0, e1, e2 = (edge_pts[i] for i in tri)
            if c > 7:  # complement: reverse winding
                tris.append(np.stack([e0, e2, e1], axis=1))
            else:
                tris.append(np.stack([e0, e1, e2], axis=1))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, axis=0).astype(np.float32)


def marching_tetrahedra(vol: np.ndarray, iso: float) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of ``vol [D, H, W]`` in index coordinates (d, h, w).

    Returns (verts [V, 3], faces [F, 3]); vertices are deduplicated on a
    1e-5 grid.  Processes the volume slab-by-slab to bound memory.
    """
    vol = np.asarray(vol, np.float32)
    d, h, w = vol.shape
    all_tris = []
    ii, jj = np.meshgrid(np.arange(h - 1), np.arange(w - 1), indexing="ij")
    base_hw = np.stack([ii.reshape(-1), jj.reshape(-1)], axis=1)  # [(h-1)(w-1), 2]
    for z0 in range(d - 1):
        base = np.concatenate(
            [np.full((base_hw.shape[0], 1), z0), base_hw], axis=1
        )  # [(cells), 3] as (d, h, w)
        # cube corner positions: offsets are (x, y, z) = (w, h, d) order
        corner = base[:, None, :] + _CUBE_OFFSETS[None, :, ::-1]  # [cells, 8, 3] (d,h,w)
        vals = vol[corner[..., 0], corner[..., 1], corner[..., 2]]  # [cells, 8]
        for tet in _TETS:
            pos = corner[:, tet, :].astype(np.float32)
            val = vals[:, tet]
            mask = ~(np.all(val <= iso, axis=1) | np.all(val > iso, axis=1))
            if not mask.any():
                continue
            all_tris.append(_emit_tet_triangles(pos[mask], val[mask], iso))
    if not all_tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tris = np.concatenate(all_tris, axis=0)  # [M, 3, 3] in (d, h, w)
    flat = tris.reshape(-1, 3)
    keys = np.round(flat / 1e-5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float64)
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=uniq.shape[0])[:, None]
    verts = (verts / counts).astype(np.float32)
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts, faces[good]


def extract_mesh_from_alpha(
    alpha_volume: np.ndarray,  # [#planes(D), H, W] in [0, 1], plane 0 nearest
    volume_min: np.ndarray,
    volume_max: np.ndarray,
    iso: float = 0.01,
    sigma: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference transform chain (``extract_mesh.py:38-53``): smooth ->
    iso-surface -> (w,h,d)->(x,y,z) permute -> scale [0,1] -> world volume."""
    vol = smooth_volume(alpha_volume, sigma)
    verts, faces = marching_tetrahedra(vol, iso)
    if len(verts) == 0:
        return verts, faces
    # (d, h, w) -> (x, y, z) = (w, h, d)
    verts = verts[:, [2, 1, 0]]
    n_grid = vol.shape[0]
    verts = verts / n_grid
    vmin = np.asarray(volume_min, np.float32).reshape(1, 3)
    vmax = np.asarray(volume_max, np.float32).reshape(1, 3)
    return verts * (vmax - vmin) + vmin, faces


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        f.write(np.asarray(verts, "<f4").tobytes())
        face_rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        face_rec["n"] = 3
        face_rec["idx"] = np.asarray(faces, np.int32)
        f.write(face_rec.tobytes())


def mpi_mesh_volume_bounds(dhw: np.ndarray, min_d: float, max_d: float):
    """Cubic world bounds for the dense alpha volume
    (``eval/common.py:199-218``): x/y from max foreground plane extents, z a
    cube ending at the far plane."""
    dhw = np.asarray(dhw)
    hw_size = float(np.max(dhw[:-1, 1:]))
    half_x = float(np.max(np.abs(dhw[:-1, 2]))) / 2
    half_y = float(np.max(np.abs(dhw[:-1, 1]))) / 2
    z_max = max_d
    z_min = z_max - hw_size
    volume_min = np.array([-half_x, -half_y, z_min])
    volume_max = np.array([half_x, half_y, z_max])
    mpi_z_size = abs(max_d - min_d)
    n_actual_planes_ratio = min(1.0, mpi_z_size / hw_size)
    return volume_min, volume_max, n_actual_planes_ratio
