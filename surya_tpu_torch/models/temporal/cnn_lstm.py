"""CNN+LSTM multimodal sequence classifier, mirroring
``surya_tpu/models/temporal/cnn_lstm.py``.

ResNet-18 per frame → 512 (frames folded into the batch: (B,T,H,W,3) →
(B·T,H,W,3), one trunk call); numerical MLP 47 → 128 → ReLU → 128 per time
step; concat → 640; 2-layer LSTM, hidden 256, inter-layer dropout 0.5;
last time step → the fused head 256 → 128 → ReLU → Dropout → classes.

**Frozen trunk, BN in inference mode.** With ``freeze_backbone`` the trunk's
BatchNorm keeps its running statistics in train mode (JAX: ``trunk_train =
train and not self.freeze_backbone``), the opposite of the spatial
families' rule: :meth:`CnnLstm.train` keeps the trunk in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones import feature_extractor
from surya_tpu_torch.models.common import FusionClassifier, reset_dense
from surya_tpu_torch.models.temporal.recurrent import StackedLSTM, last_step


class CnnLstm(nn.Module):
    def __init__(self, num_classes: int = 8, backbone: str = "resnet18",
                 lstm_hidden: int = 256, lstm_layers: int = 2,
                 dropout: float = 0.5, num_mlp_out: int = 128,
                 num_features: int = 47, dtype=torch.bfloat16,
                 freeze_backbone: bool = True):
        super().__init__()
        self.dtype, self.freeze_backbone = dtype, freeze_backbone
        self.trunk = feature_extractor(backbone, dtype)
        self.num_fc1 = nn.Linear(num_features, 128)
        self.num_fc2 = nn.Linear(128, num_mlp_out)
        self.lstm = StackedLSTM(self.trunk.out_dim + num_mlp_out, lstm_hidden,
                                lstm_layers, dropout, dtype)
        self.classifier = FusionClassifier(lstm_hidden, num_classes, dropout,
                                           dtype, hidden_dim=128)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_backbone:
            self.trunk.train(False)
        return self

    def reset_parameters(self, generator: torch.Generator | None = None):
        """JAX's init: lecun_normal kernels, zero biases, BN 1/0, orthogonal
        recurrent kernels."""
        self.trunk.reset_parameters(generator)
        for layer in (self.num_fc1, self.num_fc2, self.classifier.fc1,
                      self.classifier.fc2):
            reset_dense(layer, generator)
        self.lstm.reset_parameters(generator)

    def forward(self, image_sequence: torch.Tensor,
                numerical_sequence: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """image_sequence (B,T,H,W,3), numerical_sequence (B,T,F) → (B, C)
        f32 logits. ``generator``: the dropout stream (train mode)."""
        b, t = image_sequence.shape[:2]
        frames = image_sequence.reshape((b * t,) + image_sequence.shape[2:])
        feats = self.trunk(frames).reshape(b, t, -1)          # (B, T, 512)
        dt = self.dtype
        n = F.linear(numerical_sequence.to(dt), self.num_fc1.weight.to(dt),
                     self.num_fc1.bias.to(dt))
        n = F.linear(F.relu(n), self.num_fc2.weight.to(dt),
                     self.num_fc2.bias.to(dt))
        fused = torch.cat([feats, n], dim=-1)                 # (B, T, 640)
        final = last_step(self.lstm(fused, generator))        # (B, 256)
        return self.classifier(final, generator)
