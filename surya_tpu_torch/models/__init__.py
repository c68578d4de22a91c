"""Models: backbones, shared heads, the spatial and temporal families,
losses, registry, JAX import."""

from surya_tpu_torch.models.registry import (  # noqa: F401
    TEMPORAL_MODELS,
    get_model,
    list_models,
)
