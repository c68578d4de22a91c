"""U²-Net background removal."""

from surya_tpu_torch.models.segmentation.u2net import (  # noqa: F401
    U2Net,
    import_u2net,
    saliency,
    saliency_fn,
    u2net_loss,
)
