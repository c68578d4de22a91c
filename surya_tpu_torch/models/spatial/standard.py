"""Standard (non-quadtree) spatial baselines, mirroring
``surya_tpu/models/spatial/standard.py``.

``StandardResNetCNN``: a ResNet through layer4, global average pool, head
512 → 256 → classes; it accepts the numerical input and ignores it.

``StandardMultimodalCNN``: a backbone chosen by name (resnet18/50, vgg16,
mobilenet_v2, densenet121, classifier stripped), the numerical MLP
47 → 94 → 256 and the fusion head (dim + 256) → 512 → classes, in the
three modes: the five-backbone comparative family.

Both heads are the fused head (``ops/cuda/fusion_head.py``). Dropout is
0.5 in both, fixed as in JAX, whose registry passes them no
``cfg.dropout``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from surya_tpu_torch.models.backbones import feature_extractor
from surya_tpu_torch.models.common import (
    FusionClassifier,
    NumericalMLP,
    check_mode,
    fuse_by_mode,
    reset_model,
)


class StandardResNetCNN(nn.Module):
    """Plain ResNet classifier (the image-only baseline)."""

    mode = "image_only"   # fixed: the numerical input is ignored

    def __init__(self, num_classes: int = 8, backbone: str = "resnet18",
                 dtype=torch.bfloat16, stem_s2d: bool = False,
                 image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        self.trunk = feature_extractor(backbone, dtype, stem_s2d, image_size)
        self.classifier = FusionClassifier(self.trunk.out_dim, num_classes,
                                           0.5, dtype, hidden_dim=256)

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_model(self, generator)

    def forward(self, images, numerical=None, generator=None):
        return self.head(self.trunk(images), numerical, generator)

    def head(self, img_feat, numerical=None, generator=None):
        """Logits from the pooled image feature (Grad-CAM's tail)."""
        del numerical   # accepted and ignored
        return self.classifier(img_feat, generator)


class StandardMultimodalCNN(nn.Module):
    """Generic backbone + numerical MLP + fusion classifier."""

    def __init__(self, num_classes: int = 8, mode: str = "fusion",
                 backbone: str = "resnet18", num_mlp_out: int = 256,
                 num_features: int = 47, dtype=torch.bfloat16,
                 stem_s2d: bool = False, image_size: int = 224):
        super().__init__()
        check_mode(mode)
        self.mode, self.dtype = mode, dtype
        in_dim = 0
        if mode != "numerical_only":
            self.trunk = feature_extractor(backbone, dtype, stem_s2d,
                                           image_size)
            in_dim += self.trunk.out_dim
        if mode != "image_only":
            self.numerical_mlp = NumericalMLP(num_features, num_mlp_out,
                                              0.5, dtype)
            in_dim += num_mlp_out
        self.classifier = FusionClassifier(in_dim, num_classes, 0.5, dtype,
                                           hidden_dim=512)

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_model(self, generator)

    def forward(self, images, numerical, generator=None):
        img_feat = (None if self.mode == "numerical_only"
                    else self.trunk(images))
        return self.head(img_feat, numerical, generator)

    def head(self, img_feat, numerical, generator=None):
        """Logits from the pooled image feature (None in numerical_only
        mode) and the numerical input: Grad-CAM's tail."""
        num_feat = None
        if self.mode != "image_only":
            num_feat = self.numerical_mlp(numerical, generator)
        return self.classifier(fuse_by_mode(self.mode, img_feat, num_feat),
                               generator)
