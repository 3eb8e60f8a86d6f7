"""The AFHQCat dataset's poses as the train step reads them, worked out from
the written draws: the flat world-to-camera pose of each EG3D PnP
camera-to-world matrix (``pose_convert.w2c_from_pnp_c2w``, the camera put
back on the pose sphere).  The images go through ``gmpi.real_batch`` as
FFHQ's do.  Plain numpy."""

from __future__ import annotations

import numpy as np

from benchmark.reference.pose_convert import w2c_from_pnp_c2w


def flat_poses(c2w: np.ndarray, exp: dict) -> np.ndarray:
    """Flat w2c poses ``[N, 16]`` (or ``[N, 9]``) of camera-to-world matrices
    ``[N, 4, 4]``, one at a time as the dataset converts them."""
    c, dim = exp["camera"], exp["train"]["d_cond_pose_dim"]
    out = []
    for m in np.asarray(c2w, np.float64):
        w2c = w2c_from_pnp_c2w(m[None], c["sphere_center_z"], c["sphere_r"],
                               normalize_trans=True)
        out.append(w2c[0, :3, :3].reshape(-1) if dim == 9 else w2c[0].reshape(-1))
    return np.stack(out).astype(np.float32)
