"""Backbones (the ResNet family so far)."""

from surya_tpu_torch.models.backbones.resnet import (  # noqa: F401
    ResNet,
    feature_dim,
    make_resnet,
)
