"""VGG-16 feature stack, mirroring ``surya_tpu/models/backbones/vgg.py``:
torchvision config D (13 3×3 convs with bias, each followed by ReLU, five
2×2/2 VALID max pools), no batch norm, classifier stripped, and the map
flattened in JAX's NHWC (h, w, c) order. At 224 px that is 7·7·512 =
25,088 values; at other sizes :func:`feature_dim` gives the count.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import (
    Conv,
    nchw,
    nhwc,
    reset_model,
)

# torchvision cfg "D": conv widths with 'M' max pools between blocks
_CFG_D = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")


def feature_dim(image_size: int) -> int:
    """Length of the flattened map: five VALID 2×2 pools, 512 channels."""
    return (image_size // 32) ** 2 * 512


class VGG16Features(nn.Module):
    def __init__(self, dtype=torch.bfloat16, image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        self.out_dim = feature_dim(image_size)
        cin, i = 3, 0
        for v in _CFG_D:
            if v != "M":
                self.add_module(f"conv{i}", Conv(cin, v, 3, 1, 1, bias=True))
                cin, i = v, i + 1

    def reset_parameters(self, generator=None):
        reset_model(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC → (B, out_dim)."""
        x = nchw(x.to(self.dtype))
        i = 0
        for v in _CFG_D:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv{i}")(x))
                i += 1
        return nhwc(x).reshape(x.shape[0], -1)
