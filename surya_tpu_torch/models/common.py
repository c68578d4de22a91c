"""Shared model components, mirroring ``surya_tpu/models/common.py``:
the mode switch, the numerical-feature MLPs (47→94→256 with no final
activation; the hierarchical families' 47→128→ReLU→Dropout) and the
fusion classifier, whose forward is the fused head
(``ops/cuda/fusion_head.py``): the CUDA kernel for a CUDA tensor, its
plain version for a CPU tensor.

Layers are ``nn.Linear`` with the flax names (``fc1``, ``fc2``); weights
are cast to the compute dtype at each call (a no-op once cast).

Dropout never touches torch's global generator: in train mode every
random draw comes from the ``torch.Generator`` the caller passes (the
counterpart of flax's ``"dropout"`` stream), on the tensors' device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import (  # noqa: F401
    Conv,
    reset_dense,
    reset_model,
)
from surya_tpu_torch.ops import resolve_device
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


def flax_dropout(x, rate: float, generator, training: bool, shape=None):
    """flax ``Dropout``: keep with probability 1 - rate, scale the kept by
    1/(1 - rate); the mask is drawn from ``generator`` (none in eval mode
    or at rate 0). ``shape``: a smaller mask shape that broadcasts over
    ``x`` (one mask shared over the leading dimensions)."""
    g = dropout_generator(generator, rate, training)
    if g is None:
        return x
    keep = torch.rand(x.shape if shape is None else shape, generator=g,
                      device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dense(x, layer: nn.Linear, dtype):
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to the
    compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


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
        x = flax_dropout(F.relu(x), self.dropout, generator, self.training)
        return F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))


class SingleLayerNumericalMLP(nn.Module):
    """in → out → ReLU → Dropout: the hierarchical families' numerical
    branch, with dropout as the *last* op (active on the output)."""

    def __init__(self, in_dim: int = 47, out_dim: int = 128,
                 dropout: float = 0.5, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, out_dim)
        self.dropout, self.dtype = dropout, dtype

    def forward(self, x, generator=None):
        dt = self.dtype
        x = F.linear(x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        return flax_dropout(F.relu(x), self.dropout, generator,
                            self.training)


class FusionClassifier(nn.Module):
    """concat(features) → hidden → ReLU → Dropout → f32 logits, computed
    by the fused head. ``hidden_dim`` defaults to in_dim // 2 (at least
    the class count), as in JAX."""

    def __init__(self, in_dim: int, num_classes: int, dropout: float = 0.5,
                 dtype=torch.bfloat16, hidden_dim: int | None = None):
        super().__init__()
        hidden = hidden_dim or max(in_dim // 2, num_classes)
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


def on_meta(module: nn.Module) -> bool:
    return any(p.is_meta for p in module.parameters())


def seeded(build: Callable[[], nn.Module], seed: int = 0,
           device=None) -> nn.Module:
    """``build()`` made on the ``meta`` device, then materialised on
    ``device`` (the card unless named) with flax's init drawn from a
    generator there seeded with ``seed``: no host copy of the weights.
    ``build`` must construct without drawing (``generator`` unused)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = build()
    model.to_empty(device=dev)
    reset = getattr(model, "reset_parameters", None)
    gen = torch.Generator(dev).manual_seed(seed)
    if reset is not None:
        reset(gen)
    else:
        reset_model(model, gen)
    return model


def cast_matmul_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every conv's and Dense layer's weight and bias to ``dtype``
    once (the layers cast them at each call otherwise: the same numbers),
    conv weights in channels_last; norm parameters and BN statistics stay
    f32, as flax uses them."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, nn.Linear)):
                w = m.weight.data.to(dtype)
                if w.dim() == 4:
                    w = w.contiguous(memory_format=torch.channels_last)
                m.weight.data = w
                if m.bias is not None:
                    m.bias.data = m.bias.data.to(dtype)
    return model


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def load_state(build: Callable[[], nn.Module], state_dict,
               device=None) -> nn.Module:
    """``build()`` on the ``meta`` device, then ``state_dict`` (torch
    tensors or numpy arrays, reference names) loaded with
    ``strict=True`` as f32 tensors on ``device`` (the card unless
    named)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = build()
    state = {k: (v.detach() if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v))).to(dev, torch.float32)
             for k, v in state_dict.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model
