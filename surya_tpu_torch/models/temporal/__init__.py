"""Temporal model families: CNN+LSTM, Ji3DCNN and Quadtree3DCNN over
(B, T, H, W, 3) clips and (B, T, F) feature sequences. ResNet3DVideo,
HybridQuadtree3DCNN and FACT are ROADMAP A9b."""

from surya_tpu_torch.models.temporal.cnn_lstm import CnnLstm  # noqa: F401
from surya_tpu_torch.models.temporal.conv3d import (  # noqa: F401
    Ji3DCNN,
    Quadtree3DCNN,
)
