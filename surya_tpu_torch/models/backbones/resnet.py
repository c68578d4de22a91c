"""ResNet trunks (resnet18/34/50) in PyTorch, mirroring
``surya_tpu/models/backbones/resnet.py``.

Convolutions and BatchNorm are PyTorch/cuDNN (the JAX trunk is XLA, not
Pallas, so no hand kernel is owed). Tensors run ``channels_last``; the
public interface takes and returns NHWC tensors like the JAX trunk, so
``trunk(x, upto=..., capture=..., start=...)`` returns the same dict of
stage maps. Submodule names follow the flax tree
(``layer3_block1.downsample_conv``), so
:mod:`surya_tpu_torch.models.from_jax` maps a JAX variable tree one to
one. Init as JAX: lecun_normal kernels, BN scale 1 and bias 0.

Compute dtype: weights and activations are cast to ``dtype`` at each op
(a no-op once a Predictor has cast the weights). BatchNorm normalises in
f32 with f32 running statistics and returns ``dtype``, as flax does; in
train mode it normalises with the batch statistics and moves the running
ones as flax does (momentum 0.9, biased variance).

Two variants, as in JAX:

- ``stem_s2d``: the space-to-depth stem. 2×2 pixel blocks fold into
  channels in (ry, rx, c) order and a 4×4/1 conv with the asymmetric
  padding ((2, 1), (2, 1)) replaces the 7×7/2 conv; on weights converted
  by :func:`stem_kernel_to_s2d` it computes the same function.
- ``fold_bn``: inference only. Every conv carries a bias and every
  BatchNorm is an identity; :func:`fold_resnet_params` turns a trained
  state_dict into the folded one.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.core.mesh import all_gather_stack, all_reduce_, current_rows
from surya_tpu_torch.models.norms import GroupNorm, LayerNorm

STAGES = ("stem", "layer1", "layer2", "layer3", "layer4")


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None):
    """flax ``lecun_normal``: truncated normal (±2σ) with variance
    1/fan_in, σ corrected for the truncation. Sampled as
    ``jax.random.truncated_normal`` samples it, by the inverse CDF of a
    uniform draw (torch's ``trunc_normal_`` rejection loop takes 8 s for
    FACT's 114M parameters on one CPU thread)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    edge = math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        w.uniform_(-edge, edge, generator=generator)
        w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    return w


def global_avg_pool(x: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, W, C) → (B, C): an f32 mean rounded to ``dtype``, as JAX's
    ``jnp.mean(x, axis=(1, 2), dtype=dtype)`` accumulates."""
    return x.float().mean(dim=(1, 2)).to(dtype)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) → (B, H/b, W/b, b²·C), channel order (ry, rx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def stem_kernel_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """(CO, C, 7, 7) standard stem weight → the equivalent (CO, 4C, 4, 4)
    weight of the space-to-depth stem: the 7-tap kernel padded to 8 on the
    leading side (output o reads blocks o-2..o+1), then each 2×2 tap group
    folded into the channels in (ry, rx, c) order."""
    co, c = w7.shape[:2]
    w8 = w7.new_zeros((co, c, 8, 8))
    w8[:, :, 1:, 1:] = w7
    w8 = w8.reshape(co, c, 4, 2, 4, 2)            # (co, c, by, ry, bx, rx)
    return w8.permute(0, 3, 5, 1, 2, 4).reshape(co, 4 * c, 4, 4)


def stem_is_s2d(state_dict, prefix: str = "") -> bool:
    """The stem variant of a trunk state_dict, from its conv1 weight."""
    return state_dict[prefix + "conv1.weight"].shape[-1] == 4


class Conv(nn.Module):
    """Conv with an OIHW weight, bias-free unless ``bias``. ``padding`` is
    one int for every side or flax's ((top, bottom), (left, right))."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding=0, bias: bool = False, groups: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.groups, self.pad = stride, groups, None
        self.dilation = dilation
        if isinstance(padding, int):
            self.padding = padding
        else:   # F.pad order: (left, right, top, bottom)
            (top, bottom), (left, right) = padding
            self.padding, self.pad = 0, (left, right, top, bottom)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        if self.pad is not None:
            x = F.pad(x, self.pad)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


def merge_moments(stats: torch.Tensor):
    """Chan's parallel merge of per-part (count, mean, M2), ``stats``
    (parts, 3, C) f32 → the whole's (count, mean, biased variance)."""
    n, mean, m2 = stats.unbind(1)
    total = n.sum(0)
    merged = (n * mean).sum(0) / total
    m2 = m2.sum(0) + (n * (mean - merged) ** 2).sum(0)
    return total, merged, m2 / total


def _channel_dims(x: torch.Tensor) -> list[int]:
    return [0] + list(range(2, x.dim()))


def global_batch_stats(x: torch.Tensor, group):
    """Per-channel (count, mean, biased variance) of the global batch: this
    rank's f32 (count, mean, M2) in two passes, gathered over the data
    axis ``group`` and merged (:func:`merge_moments`)."""
    dims = _channel_dims(x)
    xf = x.float()
    n = x.numel() // x.shape[1]
    mean = xf.mean(dims)
    m2 = ((xf - mean.view(-1, *([1] * (x.dim() - 2)))) ** 2).sum(dims)
    local = torch.stack([torch.full_like(mean, float(n)), mean, m2])
    return merge_moments(all_gather_stack(local, group))


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BN over the global batch of a data-parallel step: the
    merged statistics forward; backward, the two per-channel sums Σdy and
    Σdy·(x − mean) all-reduced over the data axis, so the input gradient
    is the global batch's. The weight and bias gradients are this rank's
    sums (the step's gradient all-reduce adds the ranks')."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, count, eps, group):
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count, ctx.group = count, group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (-1,) + (1,) * (x.dim() - 2)
        dims = _channel_dims(x)
        dyf, xmu = dy.float(), x.float() - mean.view(shape)
        local = torch.stack([dyf.sum(dims), (dyf * xmu).sum(dims)])
        sum_dy, sum_dy_xmu = all_reduce_(local.clone(), ctx.group)
        n = ctx.count
        dx = (dyf - (sum_dy / n).view(shape)
              - xmu * (invstd ** 2 * sum_dy_xmu / n).view(shape)) * (
                  invstd * weight).view(shape)
        return (dx.to(x.dtype), local[1] * invstd, local[0],
                None, None, None, None, None)


class BatchNorm(nn.Module):
    """BatchNorm with flax's numerics (eps 1e-5, f32 statistics, output in
    the input's dtype).

    Eval mode normalises with the running statistics. Train mode
    normalises with the batch mean and the biased batch variance and moves
    the running statistics by ``r ← 0.9·r + 0.1·batch``, with the *biased*
    variance as flax ``nn.BatchNorm(momentum=0.9)`` does; torch's own
    ``BatchNorm2d`` would store the unbiased one (6.7% apart at n = 16).
    The buffers are updated in place during the forward, as in torch.

    The batch variance is a two-pass one, not flax's ``E[x²] − E[x]²``
    (``use_fast_variance``), whose f32 cancellation puts flax 4e-3 from an
    f64 reference on a map shifted by 30σ where this form stays within
    2e-5 (``tests/test_torch_mesh.py``). On the card one fused cuDNN pass
    computes it; on the CPU the statistics are taken in two passes of
    torch's pairwise sums (:func:`global_batch_stats`), because the CPU's
    fused channels-last kernel sums naively on one thread (9.5e-5 from f64
    at 30σ). Under data parallelism (:func:`core.mesh.current_rows` with
    a data group) the statistics are the global batch's: each rank's
    (count, mean, M2), merged by Chan's formula (:class:`_GlobalBatchNorm`).
    """

    momentum = 0.9   # flax convention: the share the running value keeps

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
        weight, bias = self.weight.float(), self.bias.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean.float(),
                                self.running_var.float(), weight, bias,
                                False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError("train-mode BatchNorm needs more than one "
                             f"value per channel, got input {tuple(x.shape)}")
        rows = current_rows()
        group = None if rows is None else rows.group
        if x.is_cuda and group is None:
            # One fused pass: with momentum 1 the throw-away buffers come
            # back holding the batch mean and the unbiased batch variance.
            mean = torch.zeros_like(self.running_mean)
            var = torch.ones_like(self.running_var)
            y = F.batch_norm(x, mean, var, weight, bias, True, 1.0, self.eps)
            unbias = (n - 1) / n
        else:
            with torch.no_grad():
                _, mean, var = global_batch_stats(x, group)
            y = _GlobalBatchNorm.apply(
                x, weight, bias, mean, var,
                float(n * (1 if group is None else rows.ranks)), self.eps,
                group)
            unbias = 1.0
        with torch.no_grad():
            keep = self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(
                var, alpha=(1.0 - keep) * unbias)   # biased variance
        return y


def reset_dense(layer: nn.Linear, generator=None) -> None:
    """flax Dense init: lecun_normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def reset_model(model: nn.Module, generator=None) -> None:
    """flax's init for every layer inside ``model``: every conv and norm,
    then every Dense layer, each in module order (the order of the
    draws). lecun_normal kernels, zero biases, norm scales 1 and biases 0,
    BN running statistics 0 and 1."""
    for m in model.modules():
        if isinstance(m, (Conv, BatchNorm, GroupNorm, LayerNorm)):
            m.reset_parameters(generator)
        if isinstance(m, BatchNorm):
            with torch.no_grad():
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            reset_dense(m, generator)


def conv_and_norm(fold_bn: bool):
    """(conv, norm) constructors: bias-free convs and BatchNorm, or, with
    ``fold_bn``, convs with a bias and identities (JAX's ``_layers``)."""
    if fold_bn:
        return (lambda *a, **k: Conv(*a, bias=True, **k)), (
            lambda c: nn.Identity())
    return Conv, BatchNorm


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 fold_bn: bool = False):
        super().__init__()
        conv, norm = conv_and_norm(fold_bn)
        self.conv1 = conv(cin, filters, 3, stride, 1)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, 1, 1)
        self.bn2 = norm(filters)
        if cin != filters or stride != 1:
            self.downsample_conv = conv(cin, filters, 1, stride)
            self.downsample_bn = norm(filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x
        if hasattr(self, "downsample_conv"):
            r = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 fold_bn: bool = False):
        super().__init__()
        conv, norm = conv_and_norm(fold_bn)
        out = filters * 4
        self.conv1 = conv(cin, filters, 1)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride, 1)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, out, 1)
        self.bn3 = norm(out)
        if cin != out or stride != 1:
            self.downsample_conv = conv(cin, out, 1, stride)
            self.downsample_bn = norm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x
        if hasattr(self, "downsample_conv"):
            r = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r)


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW map (contiguous if it is channels_last)."""
    return t.permute(0, 2, 3, 1)


def nchw(t: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC map (channels_last if it is contiguous)."""
    return t.permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """ResNet trunk; ``forward`` returns the requested stage maps (NHWC)."""

    def __init__(self, block=BasicBlock, stage_sizes=(2, 2, 2, 2),
                 width: int = 64, dtype=torch.bfloat16,
                 stem_s2d: bool = False, fold_bn: bool = False):
        super().__init__()
        self.dtype, self.stem_s2d, self.fold_bn = dtype, stem_s2d, fold_bn
        self.stage_sizes = tuple(stage_sizes)
        conv, norm = conv_and_norm(fold_bn)
        if stem_s2d:
            self.conv1 = conv(12, width, 4, 1, ((2, 1), (2, 1)))
        else:
            self.conv1 = conv(3, width, 7, 2, 3)
        self.bn1 = norm(width)
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            filters = width * 2 ** i
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"layer{i + 1}_block{j}",
                                block(cin, filters, stride, fold_bn))
                cin = filters * block.expansion
        self.out_channels = cin

    def reset_parameters(self, generator=None):
        reset_model(self, generator)

    def forward(self, x: torch.Tensor, upto: str = "layer4",
                capture: Sequence[str] = (),
                start: str | None = None) -> dict:
        """x (B, H, W, 3) NHWC → {stage: (B, h, w, C) NHWC, "out": ...}.

        ``start="layerK"`` skips the stem and the stages before K: x is
        then the NHWC map that stage takes (Grad-CAM's tails)."""
        if upto not in STAGES:
            raise ValueError(f"upto must be one of {STAGES}, got {upto!r}")
        if start is not None and start not in STAGES[1:]:
            raise ValueError(f"start must be one of {STAGES[1:]}")
        if self.fold_bn and self.training:
            raise ValueError("fold_bn is inference-only (no batch stats)")
        x = x.to(self.dtype)
        outs = {}
        if start is None:
            if self.stem_s2d:
                x = space_to_depth(x, 2)
            x = F.relu(self.bn1(self.conv1(nchw(x))))  # channels_last view
            x = F.max_pool2d(x, 3, 2, 1)
            if "stem" in capture:
                outs["stem"] = nhwc(x)
            if upto == "stem":
                outs["out"] = nhwc(x)
                return outs
        else:
            x = nchw(x)
        first = 0 if start is None else STAGES.index(start) - 1
        for i in range(first, len(self.stage_sizes)):
            stage = f"layer{i + 1}"
            for j in range(self.stage_sizes[i]):
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


def make_resnet(arch: str, dtype=torch.bfloat16, stem_s2d: bool = False,
                fold_bn: bool = False) -> ResNet:
    if arch not in _ARCHS:
        raise ValueError(f"unknown resnet {arch!r}")
    block, sizes = _ARCHS[arch]
    return ResNet(block, sizes, dtype=dtype, stem_s2d=stem_s2d,
                  fold_bn=fold_bn)


def feature_dim(name: str) -> int:
    """Final (layer4) channel count of a named resnet."""
    return {"resnet18": 512, "resnet34": 512, "resnet50": 2048}[name]


# conv name → the BatchNorm that follows it (every conv here is conv → bn)
_BN_FOR_CONV = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
                "downsample_conv": "downsample_bn"}


def fold_resnet_params(state_dict, eps: float = 1e-5) -> dict:
    """A trunk state_dict → the state_dict of ``ResNet(fold_bn=True)``.

    Eval-mode BatchNorm is the per-channel affine ``(x − μ)/√(σ²+ε)·γ + β``;
    with ``g = γ/√(σ²+ε)`` it folds into the conv before it as
    ``weight' = weight·g`` (g over O) and ``bias' = β − μ·g`` (plus the
    conv's own bias times g): JAX's ``fold_resnet_params``, on a
    state_dict."""
    out = {}
    for key, value in state_dict.items():
        *parent, module, leaf = key.split(".")
        if module in _BN_FOR_CONV.values():
            continue                        # consumed by its conv
        bn = _BN_FOR_CONV.get(module)
        if bn is None or leaf != "weight":
            if leaf != "bias" or bn is None:
                out[key] = value
            continue
        p = ".".join([*parent, bn]) + "."
        g = state_dict[p + "weight"] / torch.sqrt(
            state_dict[p + "running_var"] + eps)
        bias = state_dict[p + "bias"] - state_dict[p + "running_mean"] * g
        own = ".".join([*parent, module, "bias"])
        if own in state_dict:
            bias = bias + state_dict[own] * g
        out[key] = value * g[:, None, None, None]
        out[own] = bias
    return out
