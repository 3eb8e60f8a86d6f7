"""Datasets (port of ``gmpi_tpu/data/datasets.py``): FFHQ (zip + Deep3DFace
``.mat`` poses), AFHQCat (folder + EG3D ``dataset.json`` PnP poses), MetFaces
(x-flipped folder + ``.mat``).

Numpy and PIL, as in the JAX package: each sample is ``(img [-1,1] CHW
float32, flat_w2c (9|16), yaw, pitch)`` in numpy, and pose conversion happens
inside the dataset as the reference does (``gmpi/datasets.py:121-123,
224-226``).  PNGs decode through the native decoder (``data/fastpng.py``),
or through PIL where it is unavailable or the file is of another kind;
``DECODES`` counts the decodes by decoder.  Each item (its decode and pose
conversion, on the loader's threads) is one ``loader.item`` span
(``utils.inspect.thread_scope``).
"""

from __future__ import annotations

import functools
import io
import json
import os
import threading
import zipfile
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from gmpi_tpu_torch.core.poses import yaw_pitch_from_w2c
from gmpi_tpu_torch.data import fastpng
from gmpi_tpu_torch.data.pose_convert import (deep3dface_yaw_pitch, w2c_from_deep3dface,
                                              w2c_from_pnp_c2w)
from gmpi_tpu_torch.utils.inspect import thread_scope

IMG_EXTS = (".png", ".jpg", ".jpeg")
# PNG decodes by decoder, over every dataset of the process
DECODES = {"fastpng": 0, "pil": 0}
_decodes_lock = threading.Lock()


def _count(decoder: str) -> None:
    with _decodes_lock:  # the loader decodes on several threads
        DECODES[decoder] += 1


def _open_png(data: bytes) -> Image.Image:
    """Native decode (the pyspng analogue), PIL for what it does not decode
    (gray+alpha among them)."""
    arr = fastpng.decode(data)
    if arr is not None and arr.shape[2] != 2:
        _count("fastpng")
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[arr.shape[2]]
        return Image.fromarray(arr[..., 0] if arr.shape[2] == 1 else arr, mode)
    _count("pil")
    img = Image.open(io.BytesIO(data))
    img.load()
    return img


def _item_span(getitem):
    """A dataset's ``__getitem__`` inside one ``loader.item`` span."""

    @functools.wraps(getitem)
    def traced(self, index: int):
        with thread_scope("loader.item"):
            return getitem(self, index)

    return traced


def _load_fail_list(pose_data_path: str) -> List[str]:
    p = os.path.join(pose_data_path, "fail_list.txt")
    if os.path.exists(p):
        with open(p) as f:
            return [line.strip() for line in f]
    return []


def _to_tensor_range(img: Image.Image, img_size: int) -> np.ndarray:
    """LANCZOS resize + [0,255] -> [-1,1] CHW float32 (torchvision
    ``Resize(LANCZOS) + ToTensor + Normalize(.5,.5)`` semantics)."""
    if img.size != (img_size, img_size):
        img = img.resize((img_size, img_size), Image.LANCZOS)
    x = np.asarray(img, np.float32) / 255.0
    if x.ndim == 2:
        x = x[:, :, None].repeat(3, axis=2)
    x = x[:, :, :3]
    return (x.transpose(2, 0, 1) - 0.5) / 0.5


def _flat_pose(w2c: np.ndarray, flat_pose_dim: int) -> np.ndarray:
    if flat_pose_dim == 9:
        return w2c[0, :3, :3].reshape(-1).astype(np.float32)
    return w2c[0].reshape(-1).astype(np.float32)


def _check_size(img: Image.Image, raw_img_size: int) -> None:
    if img.size != (raw_img_size, raw_img_size):
        raise ValueError(f"image is {img.size}, the dataset's raw size is {raw_img_size}")


def _deep3dface_sample(img: Image.Image, pose_f: str, ds):
    import scipy.io as sio

    _check_size(img, ds.raw_img_size)
    x = _to_tensor_range(img, ds.img_size)
    coeffs = sio.loadmat(pose_f)
    angles, trans = coeffs["angle"], coeffs["trans"]
    w2c = w2c_from_deep3dface(angles, trans, ds.sphere_center, ds.sphere_r, normalize_trans=True)
    yaw, pitch = deep3dface_yaw_pitch(angles)
    return x, _flat_pose(w2c, ds.flat_pose_dim), yaw[0], pitch[0]


class FFHQ:
    """FFHQ zip + per-image Deep3DFace coefficient ``.mat`` files
    (``gmpi/datasets.py:24-149``).  Images listed in the pose directory's
    ``fail_list.txt`` are left out; the zip opens lazily, once per worker."""

    def __init__(self, dataset_path: str, raw_img_size: int, img_size: int,
                 pose_data_path: str, sphere_center: float, sphere_r: float = 1.0,
                 flat_pose_dim: int = 16, **_):
        fail = set(_load_fail_list(pose_data_path))
        with zipfile.ZipFile(dataset_path) as zf:
            names = sorted(n for n in zf.namelist()
                           if os.path.splitext(n)[1].lower() in IMG_EXTS)
        im_path = [n for n in names if n not in fail]
        pose_path = [os.path.join(pose_data_path, n.replace("png", "mat")) for n in im_path]
        self.data = list(zip(im_path, pose_path))
        if not self.data:
            raise ValueError(f"no images found in {dataset_path}")
        self.zip_path = dataset_path
        self._zip: Optional[zipfile.ZipFile] = None
        self.raw_img_size = raw_img_size
        self.img_size = img_size
        self.sphere_center = sphere_center
        self.sphere_r = sphere_r
        self.flat_pose_dim = flat_pose_dim

    def __len__(self):
        return len(self.data)

    @_item_span
    def __getitem__(self, index: int):
        if self._zip is None:  # lazily opened per worker thread/process
            self._zip = zipfile.ZipFile(self.zip_path)
        img_f, pose_f = self.data[index]
        with self._zip.open(img_f) as f:
            img = _open_png(f.read())
        return _deep3dface_sample(img, pose_f, self)


class AFHQCat:
    """AFHQ-cat image folder + EG3D ``dataset.json`` PnP camera poses
    (``gmpi/datasets.py:152-240``).  (yaw, pitch) come from the converted
    matrix through ``core.poses.yaw_pitch_from_w2c`` on CPU tensors."""

    def __init__(self, dataset_path: str, raw_img_size: int, img_size: int,
                 pose_data_path: str, sphere_center: float, sphere_r: float = 2.7,
                 flat_pose_dim: int = 16, **_):
        with open(os.path.join(pose_data_path, "dataset.json")) as f:
            self.all_data = json.load(f)["labels"]
        if not self.all_data:
            raise ValueError(f"no labels in {pose_data_path}/dataset.json")
        self.dataset_path = dataset_path
        self.raw_img_size = raw_img_size
        self.img_size = img_size
        self.sphere_center = sphere_center
        self.sphere_r = sphere_r
        self.flat_pose_dim = flat_pose_dim

    def __len__(self):
        return len(self.all_data)

    @_item_span
    def __getitem__(self, index: int):
        img_fname, pose_info = self.all_data[index]
        img = Image.open(os.path.join(self.dataset_path, img_fname))
        _check_size(img, self.raw_img_size)
        x = _to_tensor_range(img, self.img_size)
        c2w = np.array(pose_info[:16], np.float64).reshape(1, 4, 4)
        w2c = w2c_from_pnp_c2w(c2w, self.sphere_center, self.sphere_r, normalize_trans=True)
        # recover (yaw, pitch) from the matrix (``cam_utils.py:1005-1050``)
        yaw, pitch = yaw_pitch_from_w2c(
            torch.from_numpy(w2c), torch.tensor([0.0, 0.0, self.sphere_center]))
        return x, _flat_pose(w2c, self.flat_pose_dim), yaw.numpy()[0], pitch.numpy()[0]


class MetFaces:
    """MetFaces x-flip-augmented folder + ``.mat`` poses
    (``gmpi/datasets.py:243-356``)."""

    def __init__(self, dataset_path: str, raw_img_size: int, img_size: int,
                 pose_data_path: str, sphere_center: float, sphere_r: float = 1.0,
                 flat_pose_dim: int = 16, **_):
        fail = set(_load_fail_list(pose_data_path))
        all_im = [os.path.join(dataset_path, n) for n in sorted(os.listdir(dataset_path))
                  if n.endswith("png")]
        im_path = [p for p in all_im if os.path.basename(p) not in fail]
        pose_path = [os.path.join(pose_data_path, "coeffs",
                                  os.path.basename(p).replace("png", "mat")) for p in im_path]
        self.data = list(zip(im_path, pose_path))
        if not self.data:
            raise ValueError(f"no images found in {dataset_path}")
        self.raw_img_size = raw_img_size
        self.img_size = img_size
        self.sphere_center = sphere_center
        self.sphere_r = sphere_r
        self.flat_pose_dim = flat_pose_dim

    def __len__(self):
        return len(self.data)

    @_item_span
    def __getitem__(self, index: int):
        img_f, pose_f = self.data[index]
        with open(img_f, "rb") as f:
            img = _open_png(f.read())
        return _deep3dface_sample(img, pose_f, self)


DATASETS = {"FFHQ": FFHQ, "AFHQCat": AFHQCat, "MetFaces": MetFaces}


def get_dataset(name: str, **kwargs):
    return DATASETS[name](**kwargs)
