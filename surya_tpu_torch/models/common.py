"""Shared model components, mirroring ``surya_tpu/models/common.py``:
the mode switch, the numerical-feature MLP (47→94→256, no final
activation) and the fusion classifier, whose forward is the fused head
(``ops/cuda/fusion_head.py``): the CUDA kernel for a CUDA tensor, its
plain version for a CPU tensor.

Layers are ``nn.Linear`` with the flax names (``fc1``, ``fc2``); weights
are cast to the compute dtype at each call (a no-op once cast).

Dropout never touches torch's global generator: in train mode every
random draw comes from the ``torch.Generator`` the caller passes (the
counterpart of flax's ``"dropout"`` stream), on the tensors' device.
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


def dropout_generator(generator, rate: float, training: bool):
    """The generator to draw a dropout mask from, or None when no mask is
    drawn (eval mode or rate 0). Train mode with rate > 0 needs one."""
    if not training or rate <= 0.0:
        return None
    if generator is None:
        raise ValueError(
            "train mode with dropout > 0 needs an explicit torch.Generator "
            "(on the inputs' device); the global generator is never used")
    return generator


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

    def forward(self, x, generator=None):
        dt = self.dtype
        x = F.linear(x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        x = F.relu(x)
        g = dropout_generator(generator, self.dropout, self.training)
        if g is not None:   # flax Dropout: keep with 1 - rate, scale kept
            keep = torch.rand(x.shape, generator=g,
                              device=x.device) >= self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout),
                            torch.zeros_like(x))
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

    def forward(self, x, generator=None):
        g = dropout_generator(generator, self.dropout, self.training)
        rate, seed = 0.0, None
        if g is not None:
            # per-step scalar seed from the dropout stream, drawn on x's
            # device: the kernel reads it there, the host never waits
            rate = self.dropout
            seed = torch.randint(0, 2 ** 62, (1,), generator=g,
                                 device=x.device, dtype=torch.int64)
        return fusion_head(x.to(self.dtype).contiguous(), self.fc1.weight,
                           self.fc1.bias, self.fc2.weight, self.fc2.bias,
                           rate=rate, seed=seed)


def fuse_by_mode(mode: str, image_feat, num_feat):
    """Select the classifier input per the ablation mode."""
    if mode == "fusion":
        return torch.cat([image_feat, num_feat.to(image_feat.dtype)], dim=-1)
    if mode == "image_only":
        return image_feat
    if mode == "numerical_only":
        return num_feat
    raise ValueError(f"bad mode {mode!r}")
