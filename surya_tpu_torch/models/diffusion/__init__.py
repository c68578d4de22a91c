"""The generative tier's diffusion stack: the Euler-Ancestral sampler,
zero123plus conditioning, the reference-attention UNet, the SD VAE and
the pixel-space ``TinyDenoiser``."""

from surya_tpu_torch.models.diffusion.conditioning import (  # noqa: F401
    clip_conditioning_fn,
    combine_conditioning,
)
from surya_tpu_torch.models.diffusion.euler_ancestral import (  # noqa: F401
    EulerAncestralSchedule,
    sample,
)
from surya_tpu_torch.models.diffusion.tiny_unet import TinyDenoiser  # noqa: F401
from surya_tpu_torch.models.diffusion.unet_cond import (  # noqa: F401
    UNet2DCondition,
    UNetConfig,
    import_unet,
    reference_conditioned_denoiser,
    tiny_config,
    zero123plus_config,
)
