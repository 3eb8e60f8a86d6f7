"""Dataset pose conversion — estimated face/cat poses -> MPI-world w2c (port
of ``gmpi_tpu/data/pose_convert.py``; numpy, the same arithmetic step for
step, so results are bitwise those of the JAX package).

Numpy ports of the reference converters (re-derived from
``gmpi/utils/cam_utils.py:824-1002``):

* FFHQ / MetFaces: Deep3DFace per-image coefficients ``(angles[3],
  trans[3])`` describe the face-to-world transform in a +X right / +Y up /
  +Z backward frame with the camera at distance 10.  The chain is:
  center the MPI volume, flip into the Deep3DFace frame, apply
  ``Rz @ Ry @ Rx`` + trans, translate by the camera distance, flip back into
  the MPI frame (+X right, +Y down, +Z forward).
* AFHQ: EG3D ``dataset.json`` PnP camera-to-world matrices (OpenCV
  convention); chain is center -> flip -> ``inv(c2w)``.

``normalize_trans=True`` renormalizes the camera center onto the pose sphere
(radius ``sphere_r`` around ``(0, 0, sphere_center)``), which the reference
always enables in its datasets (``gmpi/datasets.py:121-123, 224-226``).
"""

from __future__ import annotations

import numpy as np

DEEP3DFACE_CAMERA_DISTANCE = 10.0

# MPI world (+X right, +Y down, +Z fwd) <-> Deep3DFace / OpenCV world
# (+X right, +Y up, +Z back): diag(1, -1, -1).
_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def _euler_xyz_rot(angles: np.ndarray) -> np.ndarray:
    """Deep3DFace rotation ``Rz @ Ry @ Rx`` for angles [B, 3] (radians)."""
    x, y, z = angles[:, 0], angles[:, 1], angles[:, 2]
    b = angles.shape[0]
    cx, sx, cy, sy, cz, sz = np.cos(x), np.sin(x), np.cos(y), np.sin(y), np.cos(z), np.sin(z)
    rx = np.zeros((b, 3, 3))
    rx[:, 0, 0] = 1
    rx[:, 1, 1], rx[:, 1, 2] = cx, -sx
    rx[:, 2, 1], rx[:, 2, 2] = sx, cx
    ry = np.zeros((b, 3, 3))
    ry[:, 1, 1] = 1
    ry[:, 0, 0], ry[:, 0, 2] = cy, sy
    ry[:, 2, 0], ry[:, 2, 2] = -sy, cy
    rz = np.zeros((b, 3, 3))
    rz[:, 2, 2] = 1
    rz[:, 0, 0], rz[:, 0, 1] = cz, -sz
    rz[:, 1, 0], rz[:, 1, 1] = sz, cz
    return rz @ ry @ rx


def _renormalize_onto_sphere(w2c: np.ndarray, sphere_center: float, sphere_r: float) -> np.ndarray:
    """Move the camera center onto the pose sphere, keeping orientation."""
    rot = w2c[:, :3, :3]
    trans = w2c[:, :3, 3:]
    cam_center = -np.linalg.inv(rot) @ trans  # [B, 3, 1]
    center = np.array([0.0, 0.0, sphere_center]).reshape(1, 3, 1)
    dist_vec = cam_center - center
    norm = np.linalg.norm(dist_vec, axis=1, keepdims=True)
    new_center = dist_vec / norm * sphere_r + center
    w2c = w2c.copy()
    w2c[:, :3, 3:] = -rot @ new_center
    return w2c


def w2c_from_deep3dface(
    angles: np.ndarray,
    trans: np.ndarray,
    sphere_center: float,
    sphere_r: float = 1.0,
    normalize_trans: bool = True,
) -> np.ndarray:
    """FFHQ/MetFaces: Deep3DFace (angles [B,3], trans [B,3]) -> w2c [B,4,4]."""
    angles = np.asarray(angles, np.float64).reshape(-1, 3)
    trans = np.asarray(trans, np.float64).reshape(-1, 3)
    b = angles.shape[0]

    t1 = np.tile(np.eye(4), (b, 1, 1))
    t1[:, 2, 3] = -sphere_center
    m = _FLIP[None] @ t1

    face = np.tile(np.eye(4), (b, 1, 1))
    face[:, :3, :3] = _euler_xyz_rot(angles)
    face[:, :3, 3] = trans
    m = face @ m

    t2 = np.tile(np.eye(4), (b, 1, 1))
    t2[:, 2, 3] = -DEEP3DFACE_CAMERA_DISTANCE
    m = _FLIP[None] @ (t2 @ m)

    if normalize_trans:
        m = _renormalize_onto_sphere(m, sphere_center, sphere_r)
    return m.astype(np.float32)


def w2c_from_pnp_c2w(
    c2w: np.ndarray,
    sphere_center: float,
    sphere_r: float = 1.0,
    normalize_trans: bool = True,
) -> np.ndarray:
    """AFHQ: PnP/EG3D camera-to-world [B,4,4] (OpenCV) -> MPI w2c [B,4,4]."""
    c2w = np.asarray(c2w, np.float64).reshape(-1, 4, 4)
    b = c2w.shape[0]
    t1 = np.tile(np.eye(4), (b, 1, 1))
    t1[:, 2, 3] = -sphere_center
    m = np.linalg.inv(c2w) @ (_FLIP[None] @ t1)
    if normalize_trans:
        m = _renormalize_onto_sphere(m, sphere_center, sphere_r)
    return m.astype(np.float32)


def deep3dface_yaw_pitch(angles: np.ndarray):
    """Dataset-frame (yaw, pitch): our yaw = -angles[:,1], pitch = angles[:,0]
    (``gmpi/datasets.py:129-141``)."""
    angles = np.asarray(angles, np.float32).reshape(-1, 3)
    return -angles[:, 1:2], angles[:, 0:1]
