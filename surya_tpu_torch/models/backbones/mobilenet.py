"""MobileNetV2 feature extractor, mirroring
``surya_tpu/models/backbones/mobilenet.py``: a 3×3/2 stem, the inverted
residual stack of the paper's table 2, a 1×1 conv to 1280, global average
pool → (B, 1280). Convs are bias-free, each followed by the port's
flax-exact ``BatchNorm``; ReLU6 after every BN but the projection's. The
depthwise conv has ``groups=hidden`` and an OIHW weight (hidden, 1, 3, 3),
which is what the bridge's HWIO → OIHW rule gives for flax's (3, 3, 1,
hidden) kernel.
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

# (expansion t, channels c, repeats n, stride s)
_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

FEATURE_DIM = 1280


def relu6(x):
    return F.hardtanh(x, 0.0, 6.0)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, out_ch: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        if expand != 1:
            self.expand_conv = Conv(cin, hidden, 1)
            self.expand_bn = BatchNorm(hidden)
        self.dw_conv = Conv(hidden, hidden, 3, stride, 1, groups=hidden)
        self.dw_bn = BatchNorm(hidden)
        self.project_conv = Conv(hidden, out_ch, 1)
        self.project_bn = BatchNorm(out_ch)
        self.residual = stride == 1 and cin == out_ch

    def forward(self, x):
        y = x
        if hasattr(self, "expand_conv"):
            y = relu6(self.expand_bn(self.expand_conv(y)))
        y = relu6(self.dw_bn(self.dw_conv(y)))
        y = self.project_bn(self.project_conv(y))
        return y + x if self.residual else y


class MobileNetV2Features(nn.Module):
    out_dim = FEATURE_DIM

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(3, 32, 3, 2, 1)
        self.stem_bn = BatchNorm(32)
        cin, k = 32, 0
        for t, c, n, s in _SETTINGS:
            for i in range(n):
                self.add_module(f"block{k}", InvertedResidual(
                    cin, c, s if i == 0 else 1, t))
                cin, k = c, k + 1
        self.n_blocks = k
        self.head_conv = Conv(cin, FEATURE_DIM, 1)
        self.head_bn = BatchNorm(FEATURE_DIM)

    def reset_parameters(self, generator=None):
        reset_model(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC → (B, 1280)."""
        x = relu6(self.stem_bn(self.stem_conv(nchw(x.to(self.dtype)))))
        for k in range(self.n_blocks):
            x = getattr(self, f"block{k}")(x)
        x = relu6(self.head_bn(self.head_conv(x)))
        return global_avg_pool(nhwc(x), self.dtype)
