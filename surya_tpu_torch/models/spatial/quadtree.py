"""QuadtreeCNN — the flagship spatial model, mirroring
``surya_tpu/models/spatial/quadtree.py``.

Graph at 224 px (resnet18): trunk conv1..layer3 → (B,14,14,256) map; the
quadrant block (split into four 7×7 quadrants, each zero-padded alone,
one shared 3×3 conv 256→128 + bias + ReLU, 2×2 max pool, flatten) →
(B,4608); layer4 + global average pool → (B,512); numerical MLP
47→94→256; fusion head 5376→2688→ReLU→classes.

The quadrant block always calls ``ops.cuda.quadrant.quadrant_process``
and the head always calls ``ops.cuda.fusion_head.fusion_head``: each
launches its CUDA kernel for a CUDA tensor and runs its plain version for
a CPU tensor; under autograd each runs its training form and the backward
that mirrors JAX's custom VJP. In train mode with dropout > 0 ``forward``
needs a ``torch.Generator`` on the inputs' device, from which the numerical
MLP draws its mask and the head its seed. Inputs and feature maps are NHWC at the module boundary,
as in JAX; the flatten order is JAX's (q, ph, pw, c), so JAX classifier
weights carry over unpermuted.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from surya_tpu_torch.models.backbones.resnet import (
    feature_dim,
    lecun_normal_,
    make_resnet,
)
from surya_tpu_torch.models.common import (
    FusionClassifier,
    NumericalMLP,
    check_mode,
    fuse_by_mode,
    reset_dense,
)
from surya_tpu_torch.ops.cuda.quadrant import quadrant_process


def layer3_size(image_size: int) -> int:
    """Side of the layer3 map: stem conv /2, max pool /2, layer2 and
    layer3 /2 each (ceil at every step, as the padded convs give)."""
    s = image_size
    for _ in range(4):
        s = (s + 1) // 2
    return s


class QuadtreeCNN(nn.Module):
    """2×2 quadtree over the layer3 map + global layer4 branch + fusion."""

    def __init__(self, num_classes: int = 8, mode: str = "fusion",
                 backbone: str = "resnet18", quadrant_channels: int = 128,
                 num_mlp_out: int = 256, num_features: int = 47,
                 dropout: float = 0.5, dtype=torch.bfloat16,
                 image_size: int = 224):
        super().__init__()
        check_mode(mode)
        self.mode, self.dtype = mode, dtype
        in_dim = 0
        if mode != "numerical_only":
            self.trunk = make_resnet(backbone, dtype=dtype)
            cin = feature_dim(backbone) // 2   # layer3 channels
            hp = layer3_size(image_size) // 4
            self.quadrant_conv_kernel = nn.Parameter(
                torch.empty(3, 3, cin, quadrant_channels))  # HWIO
            self.quadrant_conv_bias = nn.Parameter(
                torch.zeros(quadrant_channels))
            in_dim += feature_dim(backbone) + 4 * hp * hp * quadrant_channels
        if mode != "image_only":
            self.numerical_mlp = NumericalMLP(num_features, num_mlp_out,
                                              dropout, dtype)
            in_dim += num_mlp_out
        self.classifier = FusionClassifier(in_dim, num_classes, dropout,
                                           dtype)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """JAX's init: lecun_normal kernels, zero biases, BN 1/0."""
        if self.mode != "numerical_only":
            self.trunk.reset_parameters(generator)
            k = self.quadrant_conv_kernel
            lecun_normal_(k, k[..., 0].numel(), generator)
            with torch.no_grad():
                self.quadrant_conv_bias.zero_()
        for m in self.modules():
            if isinstance(m, nn.Linear):
                reset_dense(m, generator)

    def forward(self, images: torch.Tensor, numerical: torch.Tensor,
                generator: torch.Generator | None = None):
        """images (B, H, W, 3) NHWC, numerical (B, F) → (B, C) f32 logits.
        ``generator``: the dropout stream (train mode with dropout > 0)."""
        img_feat = num_feat = None
        if self.mode != "numerical_only":
            outs = self.trunk(images, upto="layer4", capture=("layer3",))
            # channels_last makes this NHWC view contiguous: no copy
            fmap = outs["layer3"].contiguous()
            global_feat = outs["out"].float().mean(dim=(1, 2)).to(self.dtype)
            quad_flat = quadrant_process(fmap, self.quadrant_conv_kernel,
                                         self.quadrant_conv_bias)
            img_feat = torch.cat([global_feat, quad_flat.to(self.dtype)], -1)
        if self.mode != "image_only":
            num_feat = self.numerical_mlp(numerical, generator)
        return self.classifier(fuse_by_mode(self.mode, img_feat, num_feat),
                               generator)
