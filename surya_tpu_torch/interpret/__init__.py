"""Interpretability: Grad-CAM and the hierarchical feature maps."""

from surya_tpu_torch.interpret.gradcam import (  # noqa: F401
    batch_grad_cam,
    grad_cam,
    overlay_heatmap,
    resize_bilinear,
    save_batch_grad_cam,
)
