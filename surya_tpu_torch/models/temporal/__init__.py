"""Temporal model families over (B, T, H, W, 3) clips and (B, T, F)
feature sequences: CNN+LSTM, Ji3DCNN, Quadtree3DCNN, ResNet3DVideo,
HybridQuadtree3DCNN and FACT."""

from surya_tpu_torch.models.temporal.cnn_lstm import CnnLstm  # noqa: F401
from surya_tpu_torch.models.temporal.conv3d import (  # noqa: F401
    Ji3DCNN,
    Quadtree3DCNN,
)
from surya_tpu_torch.models.temporal.fact import (  # noqa: F401
    FactModel,
    PostLNEncoderLayer,
)
from surya_tpu_torch.models.temporal.resnet3d_video import (  # noqa: F401
    HybridQuadtree3DCNN,
    ResNet3DVideo,
)
