"""Model registry — the single ``get_model`` factory, mirroring
``surya_tpu/models/registry.py``. Every spatial family is ported; the
temporal families raise ``NotImplementedError`` naming the ROADMAP item
that ports them.

As in JAX, ``cfg.dropout`` reaches the quadtree only: the hierarchical
and standard families keep their reference dropout of 0.5."""

from __future__ import annotations

import torch

from surya_tpu_torch.core.config import ModelConfig

# Families whose inputs are (B, T, H, W, 3)/(B, T, F) sequences.
TEMPORAL_MODELS = frozenset({"cnn_lstm", "ji_3dcnn", "quadtree_3d",
                             "resnet3d_video", "hybrid_quadtree_3d",
                             "fact"})


def _quadtree(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.spatial.quadtree import QuadtreeCNN

    kw = {} if cfg.dropout is None else {"dropout": cfg.dropout}
    return QuadtreeCNN(mode=cfg.mode, num_features=cfg.num_features,
                       **common, **kw)


def _hierarchical(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.spatial.hierarchical import (
        HierarchicalQuadtreeCNN,
    )

    return HierarchicalQuadtreeCNN(mode=cfg.mode,
                                   num_features=cfg.num_features, **common)


def _attention(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.spatial.hierarchical import (
        AttentionHierarchicalCNN,
    )

    return AttentionHierarchicalCNN(mode=cfg.mode,
                                    num_features=cfg.num_features, **common)


def _standard_resnet(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.spatial.standard import StandardResNetCNN

    return StandardResNetCNN(**common)


def _standard_multimodal(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.spatial.standard import StandardMultimodalCNN

    return StandardMultimodalCNN(mode=cfg.mode,
                                 num_features=cfg.num_features, **common)


_REGISTRY = {"quadtree": _quadtree,
             "hierarchical_quadtree": _hierarchical,
             "attention_hierarchical": _attention,
             "standard_resnet": _standard_resnet,
             "standard_multimodal": _standard_multimodal}


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def get_model(cfg: ModelConfig, image_size: int = 224,
              seed: int = 0) -> torch.nn.Module:
    """Build a model from a ModelConfig, initialised as JAX initialises
    it (same distributions) from a torch Generator seeded with ``seed``."""
    if cfg.name in TEMPORAL_MODELS:
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet: ROADMAP A9 (temporal "
            "families)")
    if cfg.name not in _REGISTRY:
        raise ValueError(
            f"unknown model {cfg.name!r}; available: {list_models()}")
    model = _REGISTRY[cfg.name](cfg, {
        "num_classes": cfg.num_classes, "backbone": cfg.backbone,
        "dtype": getattr(torch, cfg.compute_dtype),
        "stem_s2d": cfg.stem_space_to_depth, "image_size": image_size})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
