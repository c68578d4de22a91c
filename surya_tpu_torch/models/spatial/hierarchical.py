"""The 3-level hierarchical quadtree models, mirroring
``surya_tpu/models/spatial/hierarchical.py``.

``HierarchicalQuadtreeCNN``: the trunk's layer2 map (B, 28, 28, 128 at
224 px, resnet18) is the base. A global branch runs layer3 + layer4 +
global average pool → 512. Level 1 splits the base into 4 quadrants
(14×14) through one shared 3×3 conv (128 → 128, with bias) + ReLU + GAP
→ 4×128; level 2 splits each quadrant again into 16 sub-quadrants (7×7)
through a shared 3×3 conv (128 → 64) + ReLU + GAP → 16×64. Image
embedding 512 + 512 + 1024 = 2048; numerical branch Linear(47 → 128) +
ReLU + Dropout; fusion head 2176 → 1024 → classes.

``AttentionHierarchicalCNN``: the same levels, but the 16 level-2 vectors
pass a gate Linear(64 → 32) (compute dtype) → ReLU → Linear(32 → 1)
(f32), a softmax over the 16 sub-quadrants in f32, and reduce to one
weighted 64-d vector: 512 + 512 + 64 = 1088, + 128 → 1216 → 1024 →
classes.

The splits are ``ops.quadtree.quadrant_split``, a reshape: every quadrant
is whole (the reference's slices left the fourth one empty; JAX fixed
that, and so does this). Both levels fold the quadrants into the batch,
so each level is one conv. Dropout is 0.5, fixed as in JAX, whose registry
passes these families no ``cfg.dropout``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import (
    Conv,
    feature_dim,
    global_avg_pool,
    make_resnet,
    nchw,
    nhwc,
)
from surya_tpu_torch.models.common import (
    FusionClassifier,
    SingleLayerNumericalMLP,
    check_mode,
    fuse_by_mode,
    reset_model,
)
from surya_tpu_torch.ops.quadtree import quadrant_split

LEVEL_CHANNELS = {1: 128, 2: 64}


class _HierarchicalBase(nn.Module):
    """The trunk, the two level convs, the numerical branch and the head;
    subclasses say how the level-2 vectors enter the image embedding."""

    def __init__(self, num_classes: int = 8, mode: str = "fusion",
                 backbone: str = "resnet18", num_features: int = 47,
                 dtype=torch.bfloat16, stem_s2d: bool = False,
                 image_size: int = 224):
        super().__init__()
        del image_size   # every width here is independent of it
        check_mode(mode)
        self.mode, self.dtype = mode, dtype
        in_dim = 0
        if mode != "numerical_only":
            self.trunk = make_resnet(backbone, dtype=dtype, stem_s2d=stem_s2d)
            base_ch = feature_dim(backbone) // 4       # layer2's channels
            for level, ch in LEVEL_CHANNELS.items():
                self.add_module(f"level{level}_conv",
                                Conv(base_ch, ch, 3, 1, 1, bias=True))
            in_dim += self._image_dim(feature_dim(backbone))
        if mode != "image_only":
            self.numerical_mlp = SingleLayerNumericalMLP(num_features, 128,
                                                         0.5, dtype)
            in_dim += 128
        self.classifier = FusionClassifier(in_dim, num_classes, 0.5, dtype,
                                           hidden_dim=1024)

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_model(self, generator)

    def level_act(self, level: int, quads: torch.Tensor) -> torch.Tensor:
        """The shared 3×3 conv + ReLU of one level over folded quadrants:
        NHWC (k·B, h, w, C) → NHWC (k·B, h, w, LEVEL_CHANNELS[level])."""
        return nhwc(F.relu(getattr(self, f"level{level}_conv")(
            nchw(quads))))

    def hierarchy(self, images):
        """→ (global feature (B, 512), level-1 activation (4B, 14, 14,
        128), level-2 activation (16B, 7, 7, 64)) at 224 px, resnet18."""
        return self.from_base(self.trunk(images, upto="layer2")["out"])

    def from_base(self, base):
        """:meth:`hierarchy` from the layer2 map (NHWC): the global branch
        (layer3, layer4, GAP) and the two levels."""
        g = global_avg_pool(self.trunk(base, start="layer3")["out"],
                            self.dtype)
        l1 = quadrant_split(base)
        # split twice: quadrant-major, then sub-quadrant raster order
        return g, self.level_act(1, l1), self.level_act(2, quadrant_split(l1))

    def forward(self, images, numerical, generator=None):
        """images (B, H, W, 3) NHWC, numerical (B, F) → (B, C) f32 logits.
        ``generator``: the dropout stream (train mode)."""
        levels = ((None,) * 3 if self.mode == "numerical_only"
                  else self.hierarchy(images))
        return self.head(*levels, numerical, generator)

    def head(self, g, l1_act, l2_act, numerical, generator=None):
        """Logits from the global feature and the two level activations
        (None in numerical_only mode): the part of the forward that
        Grad-CAM differentiates."""
        img_feat = num_feat = None
        if self.mode != "numerical_only":
            b = g.shape[0]
            l1 = global_avg_pool(l1_act, self.dtype).reshape(b, 4, -1)
            l2 = global_avg_pool(l2_act, self.dtype).reshape(b, 16, -1)
            img_feat = torch.cat([g, l1.reshape(b, -1), self._level2(l2)],
                                 -1)
        if self.mode != "image_only":
            num_feat = self.numerical_mlp(numerical, generator)
        return self.classifier(fuse_by_mode(self.mode, img_feat, num_feat),
                               generator)


class HierarchicalQuadtreeCNN(_HierarchicalBase):
    """All three levels concatenated (2048-d image embedding)."""

    @staticmethod
    def _image_dim(global_dim: int) -> int:
        return global_dim + 4 * LEVEL_CHANNELS[1] + 16 * LEVEL_CHANNELS[2]

    def _level2(self, l2):
        return l2.reshape(l2.shape[0], -1)


class AttentionHierarchicalCNN(_HierarchicalBase):
    """Level 2 reduced by an attention gate over its 16 sub-quadrants."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.mode != "numerical_only":
            self.attn_fc1 = nn.Linear(LEVEL_CHANNELS[2], 32)
            self.attn_fc2 = nn.Linear(32, 1)

    @staticmethod
    def _image_dim(global_dim: int) -> int:
        return global_dim + 4 * LEVEL_CHANNELS[1] + LEVEL_CHANNELS[2]

    def _level2(self, l2):
        """(B, 16, 64) → (B, 64): gate in the compute dtype, score and
        softmax in f32, the weighted sum in the compute dtype."""
        dt = self.dtype
        s = F.relu(F.linear(l2, self.attn_fc1.weight.to(dt),
                            self.attn_fc1.bias.to(dt)))
        s = F.linear(s.float(), self.attn_fc2.weight.float(),
                     self.attn_fc2.bias.float())              # (B, 16, 1)
        weights = torch.softmax(s, dim=1)
        return (weights.to(dt) * l2).sum(dim=1)
