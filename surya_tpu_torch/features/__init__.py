"""Pose features: the 47-feature set every fusion model consumes
(``pose47``) and the 443-feature sequence set (``pose_extended``), as
batched tensor math on any device."""

from surya_tpu_torch.features.pose47 import (  # noqa: F401
    FEATURE_NAMES_47,
    NUM_FEATURES,
    extract_features_47,
)
