"""The input pipeline: host batches (numpy, a copy of the JAX package's
sources and orders) and their device-side finish (augmentation, eval
resize, imputation) as PyTorch tensor ops on the batch's device; the
replay generators and the sequence (temporal) sources."""

from surya_tpu_torch.data.pipeline import ArrayDataSource  # noqa: F401
from surya_tpu_torch.data.replay import (  # noqa: F401
    bayes_bit_error,
    make_replay_spatial,
    make_replay_temporal,
)
from surya_tpu_torch.data.synthetic import (  # noqa: F401
    make_synthetic_capability,
    make_synthetic_spatial,
    make_synthetic_temporal,
)
