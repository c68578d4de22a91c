"""Model registry — the single ``get_model`` factory, mirroring
``surya_tpu/models/registry.py``: every family of the JAX registry, spatial
and temporal; ``moe_experts > 0`` gives FACT its MoE FFN
(``parallel/moe.py``).

As in JAX, ``cfg.dropout`` (None: the family's own default) reaches the
quadtree and the temporal families only: the hierarchical and standard
families keep their reference dropout of 0.5. The temporal families'
numerical inputs are sized by ``cfg.num_features`` (flax infers them from
the data)."""

from __future__ import annotations

import torch

from surya_tpu_torch.core.config import ModelConfig

# Families whose inputs are (B, T, H, W, 3)/(B, T, F) sequences.
TEMPORAL_MODELS = frozenset({"cnn_lstm", "ji_3dcnn", "quadtree_3d",
                             "resnet3d_video", "hybrid_quadtree_3d",
                             "fact"})


def _opt(cfg: ModelConfig) -> dict:
    """JAX's ``_opt``: the dropout override only when one is set."""
    return {} if cfg.dropout is None else {"dropout": cfg.dropout}


def _quadtree(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.spatial.quadtree import QuadtreeCNN

    return QuadtreeCNN(mode=cfg.mode, num_features=cfg.num_features,
                       **common, **_opt(cfg))


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


def _cnn_lstm(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.temporal.cnn_lstm import CnnLstm

    return CnnLstm(num_classes=cfg.num_classes, backbone=cfg.backbone,
                   lstm_hidden=cfg.lstm_hidden, lstm_layers=cfg.lstm_layers,
                   num_features=cfg.num_features, dtype=common["dtype"],
                   freeze_backbone=cfg.freeze_backbone, **_opt(cfg))


def _ji_3dcnn(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.temporal.conv3d import Ji3DCNN

    return Ji3DCNN(num_classes=cfg.num_classes, dtype=common["dtype"],
                   num_features=cfg.num_features,
                   conv3d_as_2d=cfg.conv3d_as_2d, **_opt(cfg))


def _quadtree_3d(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.temporal.conv3d import Quadtree3DCNN

    return Quadtree3DCNN(num_classes=cfg.num_classes, mode=cfg.mode,
                         dtype=common["dtype"],
                         num_features=cfg.num_features,
                         conv3d_as_2d=cfg.conv3d_as_2d, **_opt(cfg))


def _resnet3d_video(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.temporal.resnet3d_video import ResNet3DVideo

    return ResNet3DVideo(num_classes=cfg.num_classes, dtype=common["dtype"],
                         num_features=cfg.num_features,
                         freeze_backbone=cfg.freeze_backbone, **_opt(cfg))


def _hybrid_quadtree_3d(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.temporal.resnet3d_video import (
        HybridQuadtree3DCNN,
    )

    return HybridQuadtree3DCNN(num_classes=cfg.num_classes, mode=cfg.mode,
                               dtype=common["dtype"],
                               num_features=cfg.num_features,
                               freeze_backbone=cfg.freeze_backbone,
                               **_opt(cfg))


def _fact(cfg: ModelConfig, common: dict):
    from surya_tpu_torch.models.temporal.fact import FactModel

    return FactModel(num_classes=cfg.num_classes, seq_len=cfg.seq_len,
                     num_layers=cfg.fusion_layers,
                     num_heads=cfg.fusion_heads, embed_dim=cfg.fusion_dim,
                     dtype=common["dtype"],
                     freeze_backbone=cfg.freeze_backbone,
                     moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
                     num_features=cfg.num_features,
                     image_size=common["image_size"], **_opt(cfg))


_REGISTRY = {"quadtree": _quadtree,
             "hierarchical_quadtree": _hierarchical,
             "attention_hierarchical": _attention,
             "standard_resnet": _standard_resnet,
             "standard_multimodal": _standard_multimodal,
             "cnn_lstm": _cnn_lstm, "ji_3dcnn": _ji_3dcnn,
             "quadtree_3d": _quadtree_3d, "resnet3d_video": _resnet3d_video,
             "hybrid_quadtree_3d": _hybrid_quadtree_3d, "fact": _fact}


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def get_model(cfg: ModelConfig, image_size: int = 224,
              seed: int = 0) -> torch.nn.Module:
    """Build a model from a ModelConfig, initialised as JAX initialises
    it (same distributions) from a torch Generator seeded with ``seed``."""
    if cfg.name not in _REGISTRY:
        raise ValueError(
            f"unknown model {cfg.name!r}; available: {list_models()}")
    model = _REGISTRY[cfg.name](cfg, {
        "num_classes": cfg.num_classes, "backbone": cfg.backbone,
        "dtype": getattr(torch, cfg.compute_dtype),
        "stem_s2d": cfg.stem_space_to_depth, "image_size": image_size})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
