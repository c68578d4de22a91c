"""ResNet trunks (resnet18/34/50) in PyTorch, mirroring
``surya_tpu/models/backbones/resnet.py``.

Convolutions and BatchNorm are PyTorch/cuDNN (the JAX trunk is XLA, not
Pallas, so no hand kernel is owed). Tensors run ``channels_last``; the
public interface takes and returns NHWC tensors like the JAX trunk, so
``trunk(x, upto=..., capture=...)`` returns the same dict of stage maps.
Submodule names follow the flax tree (``layer3_block1.downsample_conv``),
so :mod:`surya_tpu_torch.models.from_jax` maps a JAX variable tree one to
one. Init as JAX: lecun_normal kernels, BN scale 1 and bias 0.

Compute dtype: weights and activations are cast to ``dtype`` at each op
(a no-op once a Predictor has cast the weights). BatchNorm normalises in
f32 with f32 running statistics and returns ``dtype``, as flax does.
``stem_s2d`` and ``fold_bn`` come with a later slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGES = ("stem", "layer1", "layer2", "layer3", "layer4")


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None):
    """flax ``lecun_normal``: truncated normal (±2σ) with variance
    1/fan_in, σ corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)
    return w


class Conv(nn.Module):
    """Bias-free conv; weight OIHW, flax padding given as (top, left)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride, self.padding = stride, padding

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm with flax's numerics (eps 1e-5, f32 math).

    Train mode is refused: flax updates the running variance with the
    biased batch variance, torch with the unbiased one, and the training
    slice adds the BN that matches flax."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm (flax's biased running variance) "
                "comes with the training slice")
        return F.batch_norm(x, self.running_mean.float(),
                            self.running_var.float(), self.weight.float(),
                            self.bias.float(), False, 0.0, self.eps)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, filters, 3, stride, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, 1, 1)
        self.bn2 = BatchNorm(filters)
        if cin != filters or stride != 1:
            self.downsample_conv = Conv(cin, filters, 1, stride)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x
        if hasattr(self, "downsample_conv"):
            r = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        out = filters * 4
        self.conv1 = Conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, stride, 1)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(filters, out, 1)
        self.bn3 = BatchNorm(out)
        if cin != out or stride != 1:
            self.downsample_conv = Conv(cin, out, 1, stride)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x
        if hasattr(self, "downsample_conv"):
            r = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r)


class ResNet(nn.Module):
    """ResNet trunk; ``forward`` returns the requested stage maps (NHWC)."""

    def __init__(self, block=BasicBlock, stage_sizes=(2, 2, 2, 2),
                 width: int = 64, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = Conv(3, width, 7, 2, 3)
        self.bn1 = BatchNorm(width)
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            filters = width * 2 ** i
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"layer{i + 1}_block{j}",
                                block(cin, filters, stride))
                cin = filters * block.expansion
        self.out_channels = cin

    def reset_parameters(self, generator=None):
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, upto: str = "layer4",
                capture: Sequence[str] = ()) -> dict:
        """x (B, H, W, 3) NHWC → {stage: (B, h, w, C) NHWC, "out": ...}."""
        if upto not in STAGES:
            raise ValueError(f"upto must be one of {STAGES}, got {upto!r}")
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = {}
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        if "stem" in capture:
            outs["stem"] = nhwc(x)
        if upto == "stem":
            outs["out"] = nhwc(x)
            return outs
        for i, n_blocks in enumerate(self.stage_sizes):
            stage = f"layer{i + 1}"
            for j in range(n_blocks):
                x = getattr(self, f"{stage}_block{j}")(x)
            if stage in capture:
                outs[stage] = nhwc(x)
            if upto == stage:
                break
        outs["out"] = nhwc(x)
        return outs


_ARCHS = {"resnet18": (BasicBlock, (2, 2, 2, 2)),
          "resnet34": (BasicBlock, (3, 4, 6, 3)),
          "resnet50": (Bottleneck, (3, 4, 6, 3))}


def make_resnet(arch: str, dtype=torch.bfloat16) -> ResNet:
    if arch not in _ARCHS:
        raise ValueError(f"unknown resnet {arch!r}")
    block, sizes = _ARCHS[arch]
    return ResNet(block, sizes, dtype=dtype)


def feature_dim(name: str) -> int:
    """Final (layer4) channel count of a named resnet."""
    return {"resnet18": 512, "resnet34": 512, "resnet50": 2048}[name]
