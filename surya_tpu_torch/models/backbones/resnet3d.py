"""The 3-D ResNet-18 (r3d_18) trunk in PyTorch, mirroring
``surya_tpu/models/backbones/resnet3d.py`` (torchvision's
``models.video.r3d_18``): a stem Conv3d 3 → 64, k (3,7,7), stride (1,2,2),
padding (1,3,3), no bias, BN, ReLU and no max pool; four stages of two
``BasicBlock3D`` (full 3×3×3 convolutions, padding 1), widths
64/128/256/512, stages 2-4 taking stride 2 in t, h and w (T = 5 → 5, 3,
2, 1).

Layout: the input is NDHWC (B,T,H,W,C) as in JAX; inside, the NCDHW view
of a ``channels_last_3d`` tensor, so cuDNN's 3-D convolution and torch's
BN run without a re-layout (``models/temporal/conv3d.py`` does the same).
Weights are OIDHW (``models/from_jax.py`` turns flax's DHWIO). Module
names follow the flax tree (``stem_conv``, ``layer4_block0.conv1``,
``layer2_block0.downsample_conv``), so the partial-unfreeze mask
(``train/steps.py``) frees exactly ``layer4``.

BN is the port's flax-exact ``BatchNorm`` (momentum 0.9, eps 1e-5, f32
statistics). ``train_stages`` is JAX's argument of the same name: in train
mode only the named stages run BN on batch statistics (None: every stage);
:meth:`ResNet3D.train` keeps the others in eval mode.
"""

from __future__ import annotations

from typing import Collection, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import BatchNorm, lecun_normal_

STAGES3D = ("stem", "layer1", "layer2", "layer3", "layer4")


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class Conv3d(nn.Module):
    """A 3-D convolution with an OIDHW weight, bias-free unless ``bias``;
    NCDHW → NCDHW. ``kernel``, ``stride`` and ``padding`` are an int or a
    (t, h, w) triple; the padding is symmetric, as every flax padding here
    is."""

    def __init__(self, cin: int, cout: int, kernel=3, stride=1, padding=0,
                 bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *_triple(kernel)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding = _triple(stride), _triple(padding)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv3d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding)


def global_avg_pool_3d(x: torch.Tensor, dtype) -> torch.Tensor:
    """NCDHW → (B, C): an f32 mean rounded to ``dtype``, as JAX's
    ``jnp.mean(x, axis=(1, 2, 3), dtype=dtype)`` accumulates."""
    return x.float().mean(dim=(2, 3, 4)).to(dtype)


def ndhwc_to_ncdhw(x: torch.Tensor, dtype) -> torch.Tensor:
    """NDHWC clip → the NCDHW view of a channels_last_3d tensor in
    ``dtype``."""
    return x.to(dtype).contiguous().permute(0, 4, 1, 2, 3)


class BasicBlock3D(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3d(cin, filters, 3, stride, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv3d(filters, filters, 3, 1, 1)
        self.bn2 = BatchNorm(filters)
        if cin != filters or stride != 1:
            # flax's default "SAME" padding is 0 for a 1×1×1 kernel at any
            # size and stride
            self.downsample_conv = Conv3d(cin, filters, 1, stride, 0)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x
        if hasattr(self, "downsample_conv"):
            r = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r)


class ResNet3D(nn.Module):
    """r3d trunk; ``forward`` returns the requested stage maps (NCDHW
    views) and ``"out"``, as JAX's returns its dict."""

    memory_format = torch.channels_last_3d   # of its conv weights

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 width: int = 64, dtype=torch.bfloat16,
                 train_stages: Collection[str] | None = None):
        super().__init__()
        self.dtype, self.stage_sizes = dtype, tuple(stage_sizes)
        self.train_stages = (None if train_stages is None
                             else frozenset(train_stages))
        self.stem_conv = Conv3d(3, width, (3, 7, 7), (1, 2, 2), (1, 3, 3))
        self.stem_bn = BatchNorm(width)
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            filters = width * 2 ** i
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"layer{i + 1}_block{j}",
                                BasicBlock3D(cin, filters, stride))
                cin = filters
        self.out_channels = cin

    def train(self, mode: bool = True):
        """Train mode for the stages in ``train_stages`` only (all when it
        is None); eval mode is eval mode for every stage."""
        super().train(mode)
        if mode and self.train_stages is not None:
            for name, child in self.named_children():
                child.train(name.split("_")[0] in self.train_stages)
        return self

    def reset_parameters(self, generator=None):
        """JAX's init: lecun_normal kernels, BN scale 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, (Conv3d, BatchNorm)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = ()) -> dict:
        """x (B, T, H, W, 3) NDHWC → {stage: NCDHW map, "out": ...}."""
        x = F.relu(self.stem_bn(self.stem_conv(ndhwc_to_ncdhw(x,
                                                               self.dtype))))
        outs = {"stem": x} if "stem" in capture else {}
        for i, n_blocks in enumerate(self.stage_sizes):
            stage = f"layer{i + 1}"
            for j in range(n_blocks):
                x = getattr(self, f"{stage}_block{j}")(x)
            if stage in capture:
                outs[stage] = x
        outs["out"] = x
        return outs


def r3d_18(dtype=torch.bfloat16,
           train_stages: Collection[str] | None = None) -> ResNet3D:
    return ResNet3D((2, 2, 2, 2), dtype=dtype, train_stages=train_stages)
