"""Pose-landmark detection: the network, its loss and metrics, the msgpack
artifact, the landmark extractor, and training on the synthetic
generator."""

from surya_tpu_torch.models.pose.landmark_net import (  # noqa: F401
    PoseLandmarkNet,
    landmark_loss,
    load_pose_extractor,
    load_pose_params,
    neural_landmark_extractor,
    pck,
    save_pose_params,
    soft_argmax_2d,
)
from surya_tpu_torch.models.pose.train import train_pose_landmark  # noqa: F401
