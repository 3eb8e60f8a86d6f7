"""Dataset preprocessing — landmark prep + x-flip augmentation (port of
``gmpi_tpu/data/preprocess.py``).

Capability parity with ``data_preprocess/prepare_landmarks_ffhq.py`` and
``prepare_landmarks_metfaces.py``: iterate a zip/folder of images, run a
pluggable 5-point landmark detector (MTCNN in the reference — an external
model there too), save per-image landmark ``.txt`` files and a
``fail_list.txt`` for images with no detection.  MetFaces additionally gets
the x-flip augmentation pass the reference applies before pose estimation.
"""

from __future__ import annotations

import os
import zipfile
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
from PIL import Image


def iter_images(path: str) -> Iterable[Tuple[str, Image.Image]]:
    """Yield (name, PIL image) from a zip archive or an image folder."""
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            for name in sorted(zf.namelist()):
                if os.path.splitext(name)[1].lower() in (".png", ".jpg", ".jpeg"):
                    with zf.open(name) as f:
                        img = Image.open(f)
                        img.load()
                    yield name, img
    else:
        for name in sorted(os.listdir(path)):
            if os.path.splitext(name)[1].lower() in (".png", ".jpg", ".jpeg"):
                yield name, Image.open(os.path.join(path, name))


def xflip_augment_folder(src_dir: str, out_dir: str) -> int:
    """MetFaces-style horizontal-flip doubling (the reference trains on an
    x-flipped copy of every image, ``metfaces1024x1024_xflip``)."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name, img in iter_images(src_dir):
        base, ext = os.path.splitext(os.path.basename(name))
        img.save(os.path.join(out_dir, f"{base}{ext}"))
        img.transpose(Image.FLIP_LEFT_RIGHT).save(os.path.join(out_dir, f"{base}_xflip{ext}"))
        n += 2
    return n


def default_detector() -> Callable[[np.ndarray], Optional[np.ndarray]]:
    """The MTCNN adapter as a ``detect_fn`` (``prepare_landmarks_ffhq.py``'s
    detector).  Raises the adapter's ``ImportError`` when neither ``mtcnn``
    nor ``facenet_pytorch`` is installed."""
    from gmpi_tpu_torch.eval.adapters import MTCNNLandmarkDetector

    return MTCNNLandmarkDetector().detect


def prepare_landmarks(
    image_path: str,
    out_dir: str,
    detect_fn: Optional[Callable[[np.ndarray], Optional[np.ndarray]]] = None,
) -> Tuple[int, int]:
    """Run a 5-point landmark detector over a dataset.

    ``detect_fn`` maps an HWC uint8 image to a [5, 2] landmark array or None
    (detection failure); defaults to the MTCNN adapter.  Writes
    ``<stem>.txt`` per image (x y per line, the Deep3DFace input convention)
    and ``fail_list.txt``.  Returns (n_ok, n_failed)."""
    if detect_fn is None:
        detect_fn = default_detector()
    os.makedirs(out_dir, exist_ok=True)
    ok = failed = 0
    fails = []
    for name, img in iter_images(image_path):
        arr = np.asarray(img.convert("RGB"))
        lm = detect_fn(arr)
        base = os.path.basename(name)
        if lm is None:
            fails.append(base)
            failed += 1
            continue
        lm = np.asarray(lm, np.float64).reshape(5, 2)
        stem = os.path.splitext(base)[0]
        with open(os.path.join(out_dir, stem + ".txt"), "w") as f:
            for x, y in lm:
                f.write(f"{x:.3f} {y:.3f}\n")
        ok += 1
    with open(os.path.join(out_dir, "fail_list.txt"), "w") as f:
        f.write("\n".join(fails) + ("\n" if fails else ""))
    return ok, failed
