"""Backbones: pooled-feature extractors for every reference backbone,
mirroring ``surya_tpu/models/backbones/__init__.py``
(resnet18/34/50, vgg16, mobilenet_v2, densenet121, classifier stripped),
each taking an NHWC batch and returning a (B, dim) feature vector; and the
temporal families' trunks, r3d_18 (``resnet3d``) and ViT-B/16 (``vit``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from surya_tpu_torch.models.backbones.resnet import (  # noqa: F401
    ResNet,
    feature_dim,
    global_avg_pool,
    make_resnet,
)
from surya_tpu_torch.models.backbones.resnet3d import (  # noqa: F401
    ResNet3D,
    r3d_18,
)


def __getattr__(name):
    # the ViT imports models.common, which imports this package: it loads
    # on first use, not with the package
    if name in ("ViT", "vit_base_patch16"):
        from surya_tpu_torch.models.backbones import vit

        return getattr(vit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def trunk_channels_last(model: nn.Module) -> nn.Module:
    """Lay out ``model.trunk``'s conv weights (if it has a trunk) as its
    convolutions run, so cuDNN needs no re-layout: channels_last for a 2-D
    trunk, its own ``memory_format`` (channels_last_3d) for r3d_18."""
    trunk = getattr(model, "trunk", None)
    if trunk is not None:
        trunk.to(memory_format=getattr(trunk, "memory_format",
                                       torch.channels_last))
    return model

# at 224 px (vgg16's flatten depends on the image size: vgg.feature_dim)
BACKBONE_DIMS = {
    "resnet18": 512,
    "resnet34": 512,
    "resnet50": 2048,
    "vgg16": 25088,
    "mobilenet_v2": 1280,
    "densenet121": 1024,
}


class _ResNetPooled(nn.Module):
    """ResNet trunk + global average pool → (B, dim); the trunk is the
    child ``resnet``, as in the flax tree (``trunk.resnet.conv1``)."""

    def __init__(self, arch: str = "resnet18", dtype=torch.bfloat16,
                 stem_s2d: bool = False):
        super().__init__()
        self.dtype = dtype
        self.resnet = make_resnet(arch, dtype=dtype, stem_s2d=stem_s2d)
        self.out_dim = self.resnet.out_channels

    def reset_parameters(self, generator=None):
        self.resnet.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(self.resnet(x)["out"], self.dtype)


def feature_extractor(arch: str, dtype=torch.bfloat16, stem_s2d: bool = False,
                      image_size: int = 224) -> nn.Module:
    """A pooled-feature backbone by torchvision-style name; its output
    width is ``.out_dim``. ``stem_s2d`` applies to the ResNets only."""
    if arch in ("resnet18", "resnet34", "resnet50"):
        return _ResNetPooled(arch, dtype, stem_s2d)
    if arch == "vgg16":
        from surya_tpu_torch.models.backbones.vgg import VGG16Features
        return VGG16Features(dtype, image_size)
    if arch == "mobilenet_v2":
        from surya_tpu_torch.models.backbones.mobilenet import (
            MobileNetV2Features,
        )
        return MobileNetV2Features(dtype)
    if arch == "densenet121":
        from surya_tpu_torch.models.backbones.densenet import (
            DenseNet121Features,
        )
        return DenseNet121Features(dtype)
    raise ValueError(f"unknown backbone {arch!r}; "
                     f"available: {sorted(BACKBONE_DIMS)}")
