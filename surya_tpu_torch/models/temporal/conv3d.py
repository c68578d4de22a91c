"""Custom 3-D-conv spatiotemporal models, mirroring
``surya_tpu/models/temporal/conv3d.py``: ``Ji3DCNN`` and ``Quadtree3DCNN``.

``Ji3DCNN``: Conv3d blocks 3 → 32 → 64 → 128 (each conv k3 p1 + BN + ReLU)
with max pools (1,2,2) then (2,2,2), a global average pool → 128; the
numerical sequence through a 1-layer LSTM, hidden 64, last step; the fused
head 192 → 128 → ReLU → Dropout(0.5) → classes.

``Quadtree3DCNN``: blocks 3 → 32 → 64 → 128 → 256, each followed by a max
pool of (1,2,2), (2,2,2), (2,2,2), (1,2,2) (T: 5 → 5 → 2 → 1 → 1), a final
block 256 → 1024, a global average pool → 1024; in ``fusion`` mode a
2-layer LSTM, hidden 4·47 = 188, inter-layer dropout 0.6, its last step →
Dense 188 → 512 + ReLU + Dropout; the fused head over 1536 (fusion) or 1024
(``image_only``) → D/2 → classes, dropout 0.6.

Layout: inputs are NDHWC (B,T,H,W,C) as in JAX; inside, the NCDHW view of
a ``channels_last_3d`` tensor, so cuDNN's 3-D convolution, torch's BN and
``max_pool3d`` (floor mode: flax's VALID windows) run without a
re-layout. Weights are OIDHW (``models/from_jax.py`` turns flax's DHWIO).
The global pool is an f32 mean rounded to the compute dtype, as
``jnp.mean(x, axis=(1,2,3), dtype=dtype)``.

``conv3d_as_2d`` (``ModelConfig.conv3d_as_2d``, JAX's ``Conv3dAs2D``) keeps
the same parameters. In JAX it is a TPU layout lever (three temporally
shifted 2-D convolutions, as the TPU's conv units are 2-D); on CUDA it has
no effect: both settings run cuDNN's 3-D convolution. The field is read
and stored so a model built with it has the same modules and parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones import resnet3d
from surya_tpu_torch.models.backbones.resnet import BatchNorm
from surya_tpu_torch.models.backbones.resnet3d import (
    global_avg_pool_3d,
    ndhwc_to_ncdhw,
)
from surya_tpu_torch.models.common import (
    FusionClassifier,
    flax_dropout,
    reset_dense,
)
from surya_tpu_torch.models.temporal.recurrent import StackedLSTM, last_step

QT3D_MODES = ("fusion", "image_only")


class Conv3d(resnet3d.Conv3d):
    """k = (3,3,3), padding 1 on every side, with a bias: flax ``nn.Conv``
    or ``Conv3dAs2D``, which compute the same function. ``as_2d`` is stored
    and does not change the computation. Maps NCDHW → NCDHW."""

    def __init__(self, cin: int, cout: int, as_2d: bool = False):
        super().__init__(cin, cout, 3, 1, 1, bias=True)
        self.as_2d = as_2d


def _pool3d(x, window):
    return F.max_pool3d(x, window, window)


def _check_clip(name: str, t: int, least: int) -> None:
    if t < least:
        raise ValueError(
            f"{name} needs seq_len >= {least} to survive its (2,2,2) "
            f"temporal poolings, got T={t}: a shorter clip pools to a "
            "zero-size temporal dim")


class _Conv3dNet(nn.Module):
    """Shared parts: the named conv blocks and JAX's init."""

    def _add_blocks(self, widths, names, as_2d):
        """Conv3d(k3, p1) + BN (+ ReLU in :meth:`block`), the reference's
        ``conv_3d_block``, as modules ``{name}_conv`` and ``{name}_bn``."""
        cin = 3
        for name, cout in zip(names, widths):
            self.add_module(f"{name}_conv", Conv3d(cin, cout, as_2d))
            self.add_module(f"{name}_bn", BatchNorm(cout))
            cin = cout

    def block(self, name: str, x):
        return F.relu(getattr(self, f"{name}_bn")(
            getattr(self, f"{name}_conv")(x)))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """JAX's init: lecun_normal kernels, zero biases, BN 1/0, orthogonal
        recurrent kernels."""
        for m in self.modules():
            if isinstance(m, (Conv3d, BatchNorm)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                reset_dense(m, generator)
            elif isinstance(m, StackedLSTM):
                m.reset_parameters(generator)


class Ji3DCNN(_Conv3dNet):
    def __init__(self, num_classes: int = 8, dropout: float = 0.5,
                 num_features: int = 47, dtype=torch.bfloat16,
                 conv3d_as_2d: bool = False):
        super().__init__()
        self.dtype = dtype
        self._add_blocks((32, 64, 128), ("block1", "block2", "block3"),
                         conv3d_as_2d)
        self.numerical_lstm = StackedLSTM(num_features, 64, 1, 0.0, dtype)
        self.classifier = FusionClassifier(128 + 64, num_classes, dropout,
                                           dtype, hidden_dim=128)

    def forward(self, image_sequence: torch.Tensor,
                numerical_sequence: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """image_sequence (B,T,H,W,3) NDHWC, numerical (B,T,F) → (B, C)
        f32 logits."""
        _check_clip("Ji3DCNN", image_sequence.shape[1], 2)
        x = ndhwc_to_ncdhw(image_sequence, self.dtype)
        x = _pool3d(self.block("block1", x), (1, 2, 2))
        x = _pool3d(self.block("block2", x), (2, 2, 2))
        v = global_avg_pool_3d(self.block("block3", x), self.dtype)  # (B, 128)
        n = last_step(self.numerical_lstm(numerical_sequence, generator))
        fused = torch.cat([v, n.to(self.dtype)], dim=-1)          # (B, 192)
        return self.classifier(fused, generator)


class Quadtree3DCNN(_Conv3dNet):
    def __init__(self, num_classes: int = 8, mode: str = "fusion",
                 feature_dim: int = 1024, num_features: int = 47,
                 dropout: float = 0.6, dtype=torch.bfloat16,
                 conv3d_as_2d: bool = False):
        super().__init__()
        if mode not in QT3D_MODES:
            raise ValueError(f"mode must be one of {QT3D_MODES}")
        self.mode, self.dtype, self.dropout = mode, dtype, dropout
        self._add_blocks((32, 64, 128, 256, feature_dim),
                         ("block1", "block2", "block3", "block4", "final"),
                         conv3d_as_2d)
        in_dim = feature_dim
        if mode == "fusion":
            self.numerical_lstm = StackedLSTM(num_features, num_features * 4,
                                              2, dropout, dtype)
            self.numerical_projection = nn.Linear(num_features * 4,
                                                  feature_dim // 2)
            in_dim += feature_dim // 2
        self.classifier = FusionClassifier(in_dim, num_classes, dropout,
                                           dtype, hidden_dim=in_dim // 2)

    def forward(self, image_sequence: torch.Tensor,
                numerical_sequence: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        _check_clip("Quadtree3DCNN", image_sequence.shape[1], 4)
        x = ndhwc_to_ncdhw(image_sequence, self.dtype)
        for name, window in (("block1", (1, 2, 2)), ("block2", (2, 2, 2)),
                             ("block3", (2, 2, 2)), ("block4", (1, 2, 2))):
            x = _pool3d(self.block(name, x), window)
        fused = global_avg_pool_3d(self.block("final", x),
                                   self.dtype)                  # (B, 1024)
        if self.mode == "fusion":
            n = last_step(self.numerical_lstm(numerical_sequence, generator))
            dt = self.dtype
            p = self.numerical_projection
            n = F.relu(F.linear(n.to(dt), p.weight.to(dt), p.bias.to(dt)))
            n = flax_dropout(n, self.dropout, generator, self.training)
            fused = torch.cat([fused, n], dim=-1)                 # (B, 1536)
        return self.classifier(fused, generator)
