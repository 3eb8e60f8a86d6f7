"""A seeded AFHQ-cat style dataset: noise PNGs in a folder and an EG3D
``dataset.json`` whose labels hold each image's camera-to-world matrix and
its 9 normalized intrinsics.

The cameras are the kind EG3D's PnP fit gives AFHQ: OpenCV axes (x right,
y down, z forward), on a sphere around the origin of the world (y up),
looking at it, at a yaw and pitch drawn from the configuration's truncated
gaussians.  The draws are returned beside the files, as ``_ffhq_data``
returns its own, so that the reference reads the rows without the
program's decoder.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

# EG3D's normalized intrinsics of its AFHQ labels: focal 4.2647, centre 0.5
INTRINSICS = (4.2647, 0.0, 0.5, 0.0, 4.2647, 0.5, 0.0, 0.0, 1.0)


class AfhqData(NamedTuple):
    folder: str  # the image folder; dataset.json lies in it
    images: np.ndarray  # [N, res, res, 3] uint8, rows in the dataset's order
    c2w: np.ndarray  # [N, 4, 4] float64, as dataset.json holds them


def truncated_normal(rng: np.random.Generator, n: int, std: float, n_stds: float) -> np.ndarray:
    """``n`` draws of a zero-mean gaussian of ``std``, each drawn again while
    it lies beyond ``n_stds`` deviations."""
    out = rng.standard_normal(n)
    while True:
        far = np.abs(out) > n_stds
        if not far.any():
            return out * std
        out[far] = rng.standard_normal(int(far.sum()))


def look_at_origin(yaw: float, pitch: float, radius: float) -> np.ndarray:
    """The camera-to-world matrix of a camera at ``radius`` from the origin,
    ``yaw`` about the world's up axis and ``pitch`` above its equator,
    looking at the origin, in OpenCV axes."""
    eye = radius * np.array([np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                             np.cos(yaw) * np.cos(pitch)])
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, forward, eye
    return c2w


def write_afhq_dataset(root: str, n_images: int, res: int, camera: dict, seed: int,
                       compress_level: int = 1) -> AfhqData:
    """Write ``n_images`` images of ``res``^2 under ``root/afhq`` in EG3D's
    layout (``00000/img00000000.png``), with ``dataset.json`` beside them.
    ``camera``: the configuration's ``experiment["camera"]``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder = os.path.join(root, "afhq")
    os.makedirs(os.path.join(folder, "00000"))
    n_stds = camera["n_truncated_stds"]
    yaws = camera["yaw_mean"] + truncated_normal(rng, n_images, camera["yaw_std"], n_stds)
    pitches = camera["pitch_mean"] + truncated_normal(rng, n_images, camera["pitch_std"], n_stds)
    images, c2ws, labels = [], [], []
    for i in range(n_images):
        img = rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
        name = f"00000/img{i:08d}.png"
        Image.fromarray(img).save(os.path.join(folder, name), compress_level=compress_level)
        c2w = look_at_origin(float(yaws[i]), float(pitches[i]), camera["sphere_r"])
        labels.append([name, [float(v) for v in c2w.reshape(-1)] + list(INTRINSICS)])
        images.append(img)
        c2ws.append(c2w)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    return AfhqData(folder, np.stack(images), np.stack(c2ws))
