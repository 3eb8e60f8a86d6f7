"""A seeded FFHQ-style dataset: noise PNGs in a zip and a Deep3DFace ``.mat``
pose file per image, with a ``fail_list.txt`` that leaves out the fourth.

Copied from ``chip_smoke.write_ffhq_dataset`` (which writes the same files
from the same draws); this copy also returns the draws, so that the
reference reads the rows without the program's decoder, and takes the PNG
compression level (1: the noise does not compress, and a lower level
writes faster).
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import NamedTuple

import numpy as np

FAILED = "00003.png"


class FfhqData(NamedTuple):
    zip_path: str
    pose_dir: str
    images: np.ndarray  # [N, res, res, 3] uint8, rows in the dataset's order
    angles: np.ndarray  # [N, 3]
    trans: np.ndarray  # [N, 3]


def write_ffhq_dataset(root: str, n_images: int, res: int, seed: int,
                       compress_level: int = 1) -> FfhqData:
    """Write ``n_images`` images of ``res``^2 under ``root``; the returned
    rows leave out the failed image, as the dataset does."""
    import scipy.io as sio
    from PIL import Image

    rng = np.random.default_rng(seed)
    zpath, pose_dir = os.path.join(root, f"ffhq{res}.zip"), os.path.join(root, "coeffs")
    os.makedirs(pose_dir)
    images, angles, trans = [], [], []
    with zipfile.ZipFile(zpath, "w") as zf:
        for i in range(n_images):
            img = rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG", compress_level=compress_level)
            zf.writestr(f"{i:05d}.png", buf.getvalue())
            angle = (rng.standard_normal((1, 3)) * 0.2).astype(np.float32)
            tr = (rng.standard_normal((1, 3)) * 0.1).astype(np.float32)
            sio.savemat(os.path.join(pose_dir, f"{i:05d}.mat"), {"angle": angle, "trans": tr})
            if f"{i:05d}.png" != FAILED:
                images.append(img)
                angles.append(angle[0])
                trans.append(tr[0])
    with open(os.path.join(pose_dir, "fail_list.txt"), "w") as f:
        f.write(FAILED + "\n")
    return FfhqData(zpath, pose_dir, np.stack(images), np.stack(angles), np.stack(trans))
