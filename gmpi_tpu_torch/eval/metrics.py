"""Distribution metrics: FID and KID from feature sets, and the geometry /
consistency metric math (port of ``gmpi_tpu/eval/metrics.py``; numpy and
scipy, the same arithmetic).

The reference defers to ``torch_fidelity`` (``gmpi/eval/compute_fid_kid.py:
22-30``) and a vendored ``pytorch_fid`` (in-training FID,
``gmpi/utils/pytorch_fid``).  Here the *math* is first-class and the feature
extractor is pluggable:

* FID: Fréchet distance ``||mu1-mu2||^2 + tr(C1 + C2 - 2 sqrtm(C1 C2))``
  with the same eps-regularized matrix square root as pytorch_fid.
* KID: unbiased MMD^2 with the polynomial kernel ``(x.y/d + 1)^3`` averaged
  over random subsets (torch_fidelity defaults: subset size 1000, 100
  subsets).

Feature extraction plugs in via any callable ``images -> [N, D]``: the
InceptionV3 pool3 extractor of ``eval/inception.py`` (``make_feature_fn``)
for FID/KID, or synthetic features in the tests of the metric math.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray, eps: float = 1e-6
) -> float:
    """pytorch_fid's ``calculate_frechet_distance`` semantics.  ``sqrtm`` is
    called without ``disp`` (SciPy 1.18 removed it; the square root is the
    same either way)."""
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def fid_from_features(feat1: np.ndarray, feat2: np.ndarray) -> float:
    mu1, s1 = feature_statistics(feat1)
    mu2, s2 = feature_statistics(feat2)
    return frechet_distance(mu1, s1, mu2, s2)


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def _mmd2_unbiased(kxx: np.ndarray, kyy: np.ndarray, kxy: np.ndarray) -> float:
    m = kxx.shape[0]
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
    sum_xy = kxy.mean()
    return float(sum_xx + sum_yy - 2 * sum_xy)


def kid_from_features(
    feat1: np.ndarray,
    feat2: np.ndarray,
    subset_size: int = 1000,
    n_subsets: int = 100,
    seed: int = 0,
) -> Tuple[float, float]:
    """Unbiased polynomial-kernel MMD^2 averaged over subsets
    (torch_fidelity KID).  Returns (mean, std)."""
    f1 = np.asarray(feat1, np.float64)
    f2 = np.asarray(feat2, np.float64)
    m = min(subset_size, f1.shape[0], f2.shape[0])
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(n_subsets):
        x = f1[rng.choice(f1.shape[0], m, replace=False)]
        y = f2[rng.choice(f2.shape[0], m, replace=False)]
        vals.append(_mmd2_unbiased(_poly_kernel(x, x), _poly_kernel(y, y), _poly_kernel(x, y)))
    return float(np.mean(vals)), float(np.std(vals))


# ---------------------------------------------------------------------------
# Geometry / consistency metric math (``gmpi/eval/compute_geometry.py:24-68``)
# ---------------------------------------------------------------------------


def normalized_depth_error(
    rendered_depth: np.ndarray, pred_depth: np.ndarray, mask: np.ndarray
) -> float:
    """Mean squared error between z-normalized depths on the valid mask."""
    mask = np.asarray(mask).copy()
    mask[rendered_depth < 1e-8] = 0
    r, c = np.where(mask == 1)
    a = rendered_depth[r, c]
    b = pred_depth[r, c]

    def norm(v):
        return (v - v.mean()) / (v.std() + 1e-10)

    return float(np.mean(np.square(norm(b) - norm(a))))


def angle_error(render_pitch_yaw: np.ndarray, pred_angles: np.ndarray) -> float:
    """MSE between rendered (pitch, -yaw, 0) and Deep3DFace-predicted angles
    (``compute_geometry.py:47-68``)."""
    pitch, yaw = float(render_pitch_yaw[0]), float(render_pitch_yaw[1])
    ours = np.array([pitch, -yaw, 0.0])
    return float(np.mean(np.square(np.asarray(pred_angles).reshape(3) - ours)))


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
