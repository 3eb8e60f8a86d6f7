"""Evaluation (port of ``gmpi_tpu/eval``): seeded generation, the harness's
image dumps, FID/KID through the InceptionV3 module, and the identity and
geometry metrics through the external-model adapters."""

from gmpi_tpu_torch.eval.generate import generate_mpi
from gmpi_tpu_torch.eval.harness import (
    FakeImageGenerator,
    compute_consistency_dir,
    compute_fid_kid_dirs,
    prepare_fake_images,
    prepare_real_images,
)
from gmpi_tpu_torch.eval.metrics import (
    angle_error,
    fid_from_features,
    kid_from_features,
    normalized_depth_error,
)

__all__ = [
    "FakeImageGenerator",
    "angle_error",
    "compute_consistency_dir",
    "compute_fid_kid_dirs",
    "fid_from_features",
    "generate_mpi",
    "kid_from_features",
    "normalized_depth_error",
    "prepare_fake_images",
    "prepare_real_images",
]
