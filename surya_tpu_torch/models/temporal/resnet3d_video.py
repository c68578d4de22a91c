"""The pretrained-3-D-ResNet video models, mirroring
``surya_tpu/models/temporal/resnet3d_video.py``: ``ResNet3DVideo`` and
``HybridQuadtree3DCNN``.

``ResNet3DVideo``: the r3d_18 trunk, a global average pool → 512 (an f32
mean rounded to the compute dtype), the fused head 512 → 256 → ReLU →
Dropout(0.5) → classes. The numerical sequence is accepted and ignored.

``HybridQuadtree3DCNN``: the same trunk and pool → 512; in ``fusion`` mode
a 2-layer LSTM over the features, hidden 4·47 = 188, inter-layer dropout
0.6, its last step → Dense 188 → 256 + ReLU + Dropout, concatenated with
the pooled clip → 768; ``image_only`` keeps the 512. The fused head
D → D/2 → classes at dropout 0.6. Despite its name it has no quadrant
split, so the quadrant kernel is not on its path.

**Partial unfreeze.** With ``freeze_backbone`` (the presets' default) the
optimizer trains ``layer4`` and the head only (``train/steps.py``'s
``_PARTIAL_UNFREEZE``), and in train mode only ``layer4``'s BN runs on
batch statistics: the trunk is built with ``train_stages={"layer4"}``, as
JAX's is, so ``model.train()`` keeps stem..layer3 in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet3d import (
    global_avg_pool_3d,
    r3d_18,
)
from surya_tpu_torch.models.common import (
    FusionClassifier,
    dense,
    flax_dropout,
    reset_dense,
)
from surya_tpu_torch.models.temporal.recurrent import StackedLSTM, last_step

HYBRID_MODES = ("fusion", "image_only")


def _trunk(dtype, freeze_backbone: bool):
    return r3d_18(dtype, train_stages={"layer4"} if freeze_backbone
                  else None)


class ResNet3DVideo(nn.Module):
    def __init__(self, num_classes: int = 8, dropout: float = 0.5,
                 num_features: int = 47, dtype=torch.bfloat16,
                 freeze_backbone: bool = True):
        super().__init__()
        del num_features   # the numerical sequence is ignored
        self.dtype = dtype
        self.trunk = _trunk(dtype, freeze_backbone)
        self.classifier = FusionClassifier(self.trunk.out_channels,
                                           num_classes, dropout, dtype,
                                           hidden_dim=256)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.trunk.reset_parameters(generator)
        reset_dense(self.classifier.fc1, generator)
        reset_dense(self.classifier.fc2, generator)

    def forward(self, image_sequence: torch.Tensor,
                numerical_sequence: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """image_sequence (B,T,H,W,3) NDHWC → (B, C) f32 logits."""
        feat = global_avg_pool_3d(self.trunk(image_sequence)["out"],
                                  self.dtype)                     # (B, 512)
        return self.classifier(feat, generator)


class HybridQuadtree3DCNN(nn.Module):
    def __init__(self, num_classes: int = 8, mode: str = "fusion",
                 num_features: int = 47, dropout: float = 0.6,
                 dtype=torch.bfloat16, freeze_backbone: bool = True):
        super().__init__()
        if mode not in HYBRID_MODES:
            raise ValueError(f"mode must be one of {HYBRID_MODES}")
        self.mode, self.dtype, self.dropout = mode, dtype, dropout
        self.trunk = _trunk(dtype, freeze_backbone)
        in_dim = self.trunk.out_channels
        if mode == "fusion":
            hidden = num_features * 4
            self.numerical_lstm = StackedLSTM(num_features, hidden, 2,
                                              dropout, dtype)
            self.numerical_projection = nn.Linear(hidden, 256)
            in_dim += 256
        self.classifier = FusionClassifier(in_dim, num_classes, dropout,
                                           dtype, hidden_dim=in_dim // 2)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.trunk.reset_parameters(generator)
        if self.mode == "fusion":
            self.numerical_lstm.reset_parameters(generator)
            reset_dense(self.numerical_projection, generator)
        reset_dense(self.classifier.fc1, generator)
        reset_dense(self.classifier.fc2, generator)

    def forward(self, image_sequence: torch.Tensor,
                numerical_sequence: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        fused = global_avg_pool_3d(self.trunk(image_sequence)["out"],
                                   self.dtype)                    # (B, 512)
        if self.mode == "fusion":
            n = last_step(self.numerical_lstm(numerical_sequence, generator))
            n = F.relu(dense(n, self.numerical_projection, self.dtype))
            n = flax_dropout(n, self.dropout, generator, self.training)
            fused = torch.cat([fused, n], dim=-1)                 # (B, 768)
        return self.classifier(fused, generator)
