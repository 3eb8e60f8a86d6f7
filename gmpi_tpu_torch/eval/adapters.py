"""External-model adapters for the evaluation suite (port of
``gmpi_tpu/eval/adapters.py``; the port keeps its own copy of the protocols).

The reference pipeline calls three external models, each in its own conda
env (``gmpi/eval/eval.sh:58-62``):

* **ArcFace** via DeepFace — identity consistency between two views of the
  same z (``gmpi/eval/compute_consistency.py:21-105``);
* **MTCNN** — 5-point face landmarks (``gmpi/eval/prepare_face_landmarks.py``);
* **Deep3DFaceRecon** — per-image pose angles + face depth map + mask
  (``gmpi/eval/deep3dface_gmpi.py``, external repo).

Here each is an import-guarded adapter implementing a tiny protocol, so the
eval chain (``eval_gmpi_torch.py --task all``) runs with any implementation —
including in-process test stubs.  Construction raises ``ImportError`` with
install instructions when the backing package is absent (this image is
zero-egress; the adapters are the documented plug-in seam).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class FaceEmbedder(Protocol):
    """Identity embedding for consistency (ArcFace role)."""

    def embed(self, img_hwc_uint8: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 -> 1-D embedding vector."""
        ...


@runtime_checkable
class LandmarkDetector(Protocol):
    """5-point face landmark detection (MTCNN role)."""

    def detect(self, img_hwc_uint8: np.ndarray) -> Optional[np.ndarray]:
        """[H, W, 3] uint8 -> [5, 2] (x, y) landmarks, or None if no face."""
        ...


@runtime_checkable
class PoseEstimator(Protocol):
    """Pose + face-depth estimation (Deep3DFaceRecon role)."""

    def estimate(self, img_hwc_uint8: np.ndarray,
                 landmarks: Optional[np.ndarray]) -> Optional[Dict]:
        """-> {"angles": [pitch, yaw, roll] (Deep3DFace convention),
        "depth": [H, W] float or None, "mask": [H, W] bool or None},
        or None if estimation failed."""
        ...


class ArcFaceEmbedder:
    """DeepFace ArcFace embedder (``compute_consistency.py:37-44``).

    Requires ``pip install deepface`` (the reference runs it in its own
    ``deepface`` conda env, ``eval.sh:58``).
    """

    def __init__(self, model_name: str = "ArcFace", detector: str = "skip"):
        try:
            from deepface import DeepFace  # noqa: F401
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "ArcFaceEmbedder needs the 'deepface' package "
                "(reference env: eval.sh:58; pip install deepface)") from e
        self._deepface = DeepFace
        self.model_name = model_name
        self.detector = detector

    def embed(self, img_hwc_uint8: np.ndarray) -> np.ndarray:
        rep = self._deepface.represent(
            img_hwc_uint8[..., ::-1],  # DeepFace expects BGR
            model_name=self.model_name,
            detector_backend=self.detector,
            enforce_detection=False,
        )
        return np.asarray(rep[0]["embedding"], np.float32)


class MTCNNLandmarkDetector:
    """MTCNN 5-point landmarks (``prepare_face_landmarks.py``).

    Tries ``mtcnn`` (TensorFlow) then ``facenet_pytorch`` — either provides
    the 5 (x, y) points Deep3DFace wants.
    """

    def __init__(self):
        self._impl = None
        try:
            from mtcnn import MTCNN  # type: ignore

            self._impl = ("mtcnn", MTCNN())
            return
        except ImportError:
            pass
        try:
            from facenet_pytorch import MTCNN  # type: ignore

            self._impl = ("facenet", MTCNN(select_largest=True, post_process=False))
            return
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "MTCNNLandmarkDetector needs 'mtcnn' or 'facenet_pytorch' "
                "(reference env: eval.sh:61 'mtcnn_env')") from e

    def detect(self, img_hwc_uint8: np.ndarray) -> Optional[np.ndarray]:
        kind, det = self._impl
        if kind == "mtcnn":
            faces = det.detect_faces(img_hwc_uint8)
            if not faces:
                return None
            kp = faces[0]["keypoints"]
            order = ["left_eye", "right_eye", "nose", "mouth_left", "mouth_right"]
            return np.asarray([kp[k] for k in order], np.float32)
        _, _, landmarks = det.detect(img_hwc_uint8, landmarks=True)
        if landmarks is None or len(landmarks) == 0:
            return None
        return np.asarray(landmarks[0], np.float32)


class Deep3DFaceEstimator:
    """Deep3DFaceRecon pose/depth estimator glue.

    The reference drives this as an *external repo* with its own env and a
    GMPI-specific entry script (``deep3dface_gmpi.py``; docs
    ``TRAIN_EVAL.md:99-120``).  Point ``repo_path`` at a checkout of
    sicxu/Deep3DFaceRecon_pytorch with its checkpoints in place.  It runs on
    ``device``, the card by default (the JAX package's default is the CPU).
    """

    def __init__(self, repo_path: str, checkpoint_name: str = "face_recon",
                 device: str = "cuda"):
        import os
        import sys

        from gmpi_tpu_torch.utils.device import resolve_device

        if not os.path.isdir(repo_path):  # pragma: no cover - optional dep
            raise ImportError(
                f"Deep3DFaceEstimator: repo_path {repo_path!r} not found "
                "(clone sicxu/Deep3DFaceRecon_pytorch; see reference "
                "TRAIN_EVAL.md:99-120)")
        sys.path.insert(0, repo_path)
        try:
            from models import create_model  # type: ignore
            from options.test_options import TestOptions  # type: ignore
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "Deep3DFaceEstimator could not import the Deep3DFaceRecon "
                "repo modules — check repo_path and its dependencies") from e
        device = resolve_device(device)
        opt = TestOptions().parse(["--name", checkpoint_name, "--epoch", "20"])
        self.model = create_model(opt)
        self.model.setup(opt)
        self.model.device = device
        self.model.parallelize()
        self.model.eval()

    def estimate(self, img_hwc_uint8: np.ndarray,
                 landmarks: Optional[np.ndarray]) -> Optional[Dict]:
        if landmarks is None:
            return None
        import torch

        from util.preprocess import align_img  # type: ignore
        from PIL import Image

        im = Image.fromarray(img_hwc_uint8)
        lm = np.asarray(landmarks, np.float32)
        lm[:, 1] = im.size[1] - 1 - lm[:, 1]
        lm3d = getattr(self, "_lm3d", None)
        if lm3d is None:
            from util.load_mats import load_lm3d  # type: ignore

            lm3d = self._lm3d = load_lm3d("BFM")
        _, im_a, lm_a, _ = align_img(im, lm, lm3d)
        ten = torch.tensor(np.asarray(im_a, np.float32) / 255.0).permute(2, 0, 1)[None]
        self.model.set_input({"imgs": ten, "lms": torch.tensor(lm_a)[None]})
        with torch.no_grad():
            self.model.test()
        coeffs = self.model.pred_coeffs_dict
        angles = coeffs["angle"].cpu().numpy().reshape(3)
        depth = getattr(self.model, "pred_depth", None)
        mask = getattr(self.model, "pred_mask", None)
        return {
            "angles": angles,
            "depth": None if depth is None else depth.cpu().numpy().squeeze(),
            "mask": None if mask is None else mask.cpu().numpy().squeeze() > 0.5,
        }


def load_adapter(spec: str):
    """Instantiate an adapter from ``"module:attr"``.

    ``attr`` may be an instance, a class, or a zero-arg factory; classes and
    factories are called.  This is how ``eval_gmpi_torch.py`` accepts both the real
    adapters above and test stubs.
    """
    import importlib

    module, _, attr = spec.partition(":")
    obj = getattr(importlib.import_module(module), attr or "adapter")
    if isinstance(obj, type):
        return obj()
    if hasattr(obj, "embed") or hasattr(obj, "detect") or hasattr(obj, "estimate"):
        return obj
    return obj()
