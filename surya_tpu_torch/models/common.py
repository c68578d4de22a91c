"""Shared model components, mirroring ``surya_tpu/models/common.py``:
the mode switch, the numerical-feature MLP (47→94→256, no final
activation) and the fusion classifier, whose forward is the fused head
(``ops/cuda/fusion_head.py``): the CUDA kernel for a CUDA tensor, its
plain version for a CPU tensor.

Layers are ``nn.Linear`` with the flax names (``fc1``, ``fc2``); weights
are cast to the compute dtype at each call (a no-op once cast).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import lecun_normal_
from surya_tpu_torch.ops.cuda.fusion_head import fusion_head

MODES = ("fusion", "image_only", "numerical_only")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def apply_mode_ablation(mode: str, images, feats):
    """Zero the unused modality for the ablation modes (single owner of
    the rule for the inference tier)."""
    if mode == "numerical_only":
        images = torch.zeros_like(images)
    if mode == "image_only":
        feats = torch.zeros_like(feats)
    return images, feats


def reset_dense(layer: nn.Linear, generator=None) -> None:
    """flax Dense init: lecun_normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()


class NumericalMLP(nn.Module):
    """in → 2·in → ReLU → Dropout → out (no final activation)."""

    def __init__(self, in_dim: int = 47, out_dim: int = 256,
                 dropout: float = 0.5, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 2 * in_dim)
        self.fc2 = nn.Linear(2 * in_dim, out_dim)
        self.dropout, self.dtype = dropout, dtype

    def forward(self, x):
        dt = self.dtype
        x = F.linear(x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        x = F.dropout(F.relu(x), self.dropout, self.training)
        return F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))


class FusionClassifier(nn.Module):
    """concat(features) → hidden (in_dim // 2) → ReLU → Dropout → f32
    logits, computed by the fused head."""

    def __init__(self, in_dim: int, num_classes: int, dropout: float = 0.5,
                 dtype=torch.bfloat16):
        super().__init__()
        hidden = max(in_dim // 2, num_classes)
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, num_classes)
        self.dropout, self.dtype = dropout, dtype

    def forward(self, x):
        rate = self.dropout if self.training else 0.0
        return fusion_head(x.to(self.dtype).contiguous(), self.fc1.weight,
                           self.fc1.bias, self.fc2.weight, self.fc2.bias,
                           rate=rate)


def fuse_by_mode(mode: str, image_feat, num_feat):
    """Select the classifier input per the ablation mode."""
    if mode == "fusion":
        return torch.cat([image_feat, num_feat.to(image_feat.dtype)], dim=-1)
    if mode == "image_only":
        return image_feat
    if mode == "numerical_only":
        return num_feat
    raise ValueError(f"bad mode {mode!r}")
