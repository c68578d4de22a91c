"""Model registry — the single ``get_model`` factory, mirroring
``surya_tpu/models/registry.py``. Only the quadtree family is ported so
far; every other family raises ``NotImplementedError`` naming the
ROADMAP item that ports it."""

from __future__ import annotations

import torch

from surya_tpu_torch.core.config import ModelConfig

# Families whose inputs are (B, T, H, W, 3)/(B, T, F) sequences.
TEMPORAL_MODELS = frozenset({"cnn_lstm", "ji_3dcnn", "quadtree_3d",
                             "resnet3d_video", "hybrid_quadtree_3d",
                             "fact"})

_NOT_YET = {
    "hierarchical_quadtree": "A8 (other spatial families)",
    "attention_hierarchical": "A8 (other spatial families)",
    "standard_resnet": "A8 (other spatial families)",
    "standard_multimodal": "A8 (other spatial families)",
    **{name: "A9 (temporal families)" for name in TEMPORAL_MODELS},
}


def list_models() -> list[str]:
    return ["quadtree"]


def get_model(cfg: ModelConfig, image_size: int = 224,
              seed: int = 0) -> torch.nn.Module:
    """Build a model from a ModelConfig, initialised as JAX initialises
    it (same distributions) from a torch Generator seeded with ``seed``."""
    if cfg.name in _NOT_YET:
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet: ROADMAP {_NOT_YET[cfg.name]}")
    if cfg.name != "quadtree":
        raise ValueError(
            f"unknown model {cfg.name!r}; available: {list_models()}")
    if cfg.stem_space_to_depth:
        raise NotImplementedError(
            "stem_space_to_depth is not ported yet: ROADMAP A8")
    from surya_tpu_torch.models.spatial.quadtree import QuadtreeCNN

    kw = {} if cfg.dropout is None else {"dropout": cfg.dropout}
    model = QuadtreeCNN(num_classes=cfg.num_classes, mode=cfg.mode,
                        backbone=cfg.backbone, num_features=cfg.num_features,
                        dtype=getattr(torch, cfg.compute_dtype),
                        image_size=image_size, **kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
