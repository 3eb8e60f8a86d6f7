"""Training data (port of ``gmpi_tpu/data``): datasets, pose conversion, the
native PNG decoder, the sharded loader and preprocessing."""

from gmpi_tpu_torch.data.datasets import AFHQCat, DATASETS, FFHQ, MetFaces, get_dataset
from gmpi_tpu_torch.data.loader import ShardedLoader

__all__ = ["AFHQCat", "DATASETS", "FFHQ", "MetFaces", "ShardedLoader", "get_dataset"]
