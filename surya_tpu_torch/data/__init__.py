"""The input pipeline: host batches (numpy, a copy of the JAX package's
sources and orders) and their device-side finish (augmentation, eval
resize, imputation) as PyTorch tensor ops on the batch's device."""

from surya_tpu_torch.data.pipeline import ArrayDataSource  # noqa: F401
from surya_tpu_torch.data.synthetic import (  # noqa: F401
    make_synthetic_capability,
    make_synthetic_spatial,
    make_synthetic_temporal,
)
