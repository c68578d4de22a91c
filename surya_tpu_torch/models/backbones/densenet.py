"""DenseNet-121 feature extractor, mirroring
``surya_tpu/models/backbones/densenet.py``: a 7×7/2 stem, BN, ReLU and a
3×3/2 max pool (padded with −inf), dense blocks of (6, 12, 24, 16) layers
with growth 32 (BN → ReLU → 1×1 to 128 → BN → ReLU → 3×3 to 32, then the
concatenation), transitions BN → ReLU → 1×1 (half the channels) → 2×2/2
average pool, a final BN + ReLU and global average pool → (B, 1024).

The maps stay ``channels_last`` through the concatenations: ``torch.cat``
along the channel dim of channels_last inputs gives a channels_last
output.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import (
    BatchNorm,
    Conv,
    global_avg_pool,
    nchw,
    nhwc,
    reset_model,
)

_BLOCKS = (6, 12, 24, 16)
_GROWTH = 32
_BN_SIZE = 4

FEATURE_DIM = 1024


class DenseLayer(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(cin, _BN_SIZE * _GROWTH, 1)
        self.bn2 = BatchNorm(_BN_SIZE * _GROWTH)
        self.conv2 = Conv(_BN_SIZE * _GROWTH, _GROWTH, 3, 1, 1)

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class DenseNet121Features(nn.Module):
    out_dim = FEATURE_DIM

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(3, 64, 7, 2, 3)
        self.stem_bn = BatchNorm(64)
        c = 64
        for bi, n_layers in enumerate(_BLOCKS):
            for li in range(n_layers):
                self.add_module(f"block{bi}_layer{li}", DenseLayer(c))
                c += _GROWTH
            if bi != len(_BLOCKS) - 1:
                self.add_module(f"trans{bi}_bn", BatchNorm(c))
                self.add_module(f"trans{bi}_conv", Conv(c, c // 2, 1))
                c //= 2
        self.final_bn = BatchNorm(c)

    def reset_parameters(self, generator=None):
        reset_model(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC → (B, 1024)."""
        x = self.stem_conv(nchw(x.to(self.dtype)))
        x = F.max_pool2d(F.relu(self.stem_bn(x)), 3, 2, 1)
        for bi, n_layers in enumerate(_BLOCKS):
            for li in range(n_layers):
                x = getattr(self, f"block{bi}_layer{li}")(x)
            if bi != len(_BLOCKS) - 1:
                x = F.relu(getattr(self, f"trans{bi}_bn")(x))
                x = F.avg_pool2d(getattr(self, f"trans{bi}_conv")(x), 2, 2)
        x = F.relu(self.final_bn(x))
        return global_avg_pool(nhwc(x), self.dtype)
