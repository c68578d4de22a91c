"""FACT (Fused Action-Conditioned Transformer) in PyTorch, mirroring
``surya_tpu/models/temporal/fact.py``.

A frozen ViT-B/16 (``models/backbones/vit.py``) gives one CLS embedding
(d = 768) per frame, the frames folded into the batch; a numeric projector
maps 47 → d/2 → ReLU → d per time step; token-type embeddings (0 image,
1 numeric) are added; the tokens interleave as [img_1, num_1, …, img_T,
num_T]; a learned CLS token is prepended and a learned position embedding
of length 2T+1 added; a stack of post-LN encoder layers
(``nn.TransformerEncoderLayer``'s structure: d, 8 heads, FFN 4d with ReLU,
dropout 0.1 in four places) runs over the 2T+1 tokens; the head is
LayerNorm + Dense (f32) on the CLS output. The ``embed`` /
``encoder_stack`` / ``head`` split is JAX's.

Numerics and names are JAX's (the ViT module's docstring): flax's
LayerNorm with eps 1e-6 (the reference's torch layers use 1e-5: a finding
on the JAX side, mirrored), flax's attention with broadcast dropout, every
mask drawn from the caller's ``torch.Generator``.

**Frozen ViT.** With ``freeze_backbone`` (the presets' default) the ViT
runs in eval mode (:meth:`FactModel.train`), and the train step freezes
its parameters (``requires_grad=False``, ``train/steps.py``), so no
backward graph is built through its 86M parameters: the counterpart of
JAX's ``stop_frozen_gradients``.

``moe_experts > 0`` replaces every fusion layer's FFN by the MoE FFN of
``parallel/moe.py`` (its auxiliary loss reaches the train step's
objective). Expert parallelism over a ``moe_mesh`` 'expert' axis, ring
attention over a ``cp_mesh`` and the pipelined stack
(``fact_apply_pipelined``) raise, naming ROADMAP A11b.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.vit import (
    MultiHeadDotProductAttention,
    ViT,
)
from surya_tpu_torch.models.common import dense, flax_dropout, reset_model
from surya_tpu_torch.models.norms import LayerNorm
from surya_tpu_torch.parallel.moe import MoEFFN

_A11B = "is not ported yet: ROADMAP A11b (FACT's parallel variants)"


class PostLNEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer``'s structure (post-LN, ReLU FFN)
    with flax's numerics: ln1(x + drop(attn(x))), then
    ln2(x + drop(ff2(drop(relu(ff1(x)))))); with ``moe_experts`` the FFN
    is the MoE FFN ``moe`` (JAX's name)."""

    def __init__(self, dim: int, num_heads: int = 8, ff_dim: int = 3072,
                 dropout: float = 0.1, dtype=torch.bfloat16,
                 moe_experts: int = 0, moe_top_k: int = 2):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(dim, num_heads, dropout,
                                                 dtype)
        self.ln1 = LayerNorm(dim, dtype)
        if moe_experts:
            self.moe = MoEFFN(dim, moe_experts, ff_dim, moe_top_k,
                              dropout=dropout, dtype=dtype)
        else:
            self.ff1 = nn.Linear(dim, ff_dim)
            self.ff2 = nn.Linear(ff_dim, dim)
        self.ln2 = LayerNorm(dim, dtype)
        self.dropout, self.dtype = dropout, dtype

    def forward(self, x, generator=None):
        def drop(t):
            return flax_dropout(t, self.dropout, generator, self.training)

        x = self.ln1(x + drop(self.attn(x, generator)))
        if hasattr(self, "moe"):
            y = self.moe(x, generator)
        else:
            y = dense(drop(F.relu(dense(x, self.ff1, self.dtype))), self.ff2,
                      self.dtype)
        return self.ln2(x + drop(y))


class FactModel(nn.Module):
    def __init__(self, num_classes: int = 8, seq_len: int = 4,
                 num_features: int = 47, embed_dim: int = 768,
                 num_layers: int = 4, num_heads: int = 8,
                 dropout: float = 0.1, dtype=torch.bfloat16,
                 freeze_backbone: bool = True, vit_depth: int = 12,
                 vit_heads: int = 12, image_size: int = 224,
                 cp_mesh=None, moe_experts: int = 0, moe_top_k: int = 2,
                 moe_mesh=None):
        super().__init__()
        if cp_mesh is not None:
            raise NotImplementedError(f"ring attention over a cp_mesh {_A11B}")
        if moe_mesh is not None and moe_mesh.shape.get("expert", 1) > 1:
            raise NotImplementedError(
                f"expert parallelism (an 'expert' axis > 1) {_A11B}")
        d = embed_dim
        self.seq_len, self.num_layers, self.dtype = seq_len, num_layers, dtype
        self.freeze_backbone = freeze_backbone
        self.vit_backbone = ViT(image_size, embed_dim=d, depth=vit_depth,
                                num_heads=vit_heads, mlp_dim=4 * d,
                                dtype=dtype)
        self.num_proj1 = nn.Linear(num_features, d // 2)
        self.num_proj2 = nn.Linear(d // 2, d)
        self.token_type_embed = nn.Parameter(torch.zeros(2, d))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 2 * seq_len + 1, d))
        for i in range(num_layers):
            self.add_module(f"fusion{i}", PostLNEncoderLayer(
                d, num_heads, 4 * d, dropout, dtype, moe_experts, moe_top_k))
        self.head_ln = LayerNorm(d, dtype)
        self.head_fc = nn.Linear(d, num_classes)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_backbone:
            self.vit_backbone.train(False)
        return self

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's init; the token-type, CLS and position embeddings N(0, 1)
        (the reference's ``nn.Embedding`` and ``torch.randn`` scale)."""
        for name, child in self.named_children():
            if name != "vit_backbone":
                reset_model(child, generator)
        for m in self.modules():
            if isinstance(m, MoEFFN):
                m.reset_parameters(generator)
        self.vit_backbone.reset_parameters(generator)
        with torch.no_grad():
            for p in (self.token_type_embed, self.cls_token, self.pos_embed):
                nn.init.normal_(p, 0.0, 1.0, generator=generator)

    def embed(self, image_sequence, numerical_sequence, generator=None):
        """The per-frame ViT CLS, the numeric projector, type embeddings,
        the interleave, CLS and position embeddings → (B, 2T+1, d)."""
        b, t = image_sequence.shape[:2]
        if t != self.seq_len:
            raise ValueError(
                f"FactModel(seq_len={self.seq_len}) got a T={t} sequence — "
                "pos_embed is sized 2*seq_len+1; set model.seq_len to match "
                "data.seq_len")
        dt, d = self.dtype, self.pos_embed.shape[-1]
        frames = image_sequence.reshape((b * t,) + image_sequence.shape[2:])
        img = self.vit_backbone(frames, generator).reshape(b, t, d)
        num = dense(F.relu(dense(numerical_sequence, self.num_proj1, dt)),
                    self.num_proj2, dt)
        types = self.token_type_embed.to(dt)
        fused = torch.stack([img + types[0], num + types[1]], dim=2).reshape(
            b, 2 * t, d)                     # [img_1, num_1, img_2, ...]
        full = torch.cat([self.cls_token.to(dt).expand(b, 1, d), fused], 1)
        return full + self.pos_embed.to(dt)

    def encoder_stack(self, full, generator=None):
        for i in range(self.num_layers):
            full = getattr(self, f"fusion{i}")(full, generator)
        return full

    def head(self, full):
        """LN + an f32 Dense on the CLS output → (B, C) f32 logits."""
        return dense(self.head_ln(full[:, 0]), self.head_fc, torch.float32)

    def forward(self, image_sequence: torch.Tensor,
                numerical_sequence: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """image_sequence (B,T,H,W,3), numerical_sequence (B,T,F) → (B, C)
        f32 logits. ``generator``: the dropout stream (train mode)."""
        full = self.embed(image_sequence, numerical_sequence, generator)
        return self.head(self.encoder_stack(full, generator))


def fact_apply_pipelined(*args, **kwargs):
    """JAX's GPipe-scheduled FACT forward (``parallel/pipeline.py``)."""
    raise NotImplementedError(f"fact_apply_pipelined {_A11B}")
