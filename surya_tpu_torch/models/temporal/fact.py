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
objective); with a ``moe_mesh`` that has an 'expert' axis each rank holds
and runs its share of the experts (expert parallelism). A ``cp_mesh``
whose 'seq' axis is larger than 1 runs the fusion attention as ring
attention over it (``parallel/ring_attention.py``), the parameters
unchanged. :func:`fact_apply_pipelined` runs the fusion stack as a GPipe
pipeline over a 'pipe' axis (``parallel/pipeline.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.core.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    batch_rows,
    single_device_mesh,
)
from surya_tpu_torch.core.prng import fold_in
from surya_tpu_torch.models.backbones.vit import (
    MultiHeadDotProductAttention,
    ViT,
)
from surya_tpu_torch.models.common import dense, flax_dropout, reset_model
from surya_tpu_torch.models.norms import LayerNorm
from surya_tpu_torch.parallel.moe import MoEFFN


class PostLNEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer``'s structure (post-LN, ReLU FFN)
    with flax's numerics: ln1(x + drop(attn(x))), then
    ln2(x + drop(ff2(drop(relu(ff1(x)))))); with ``moe_experts`` the FFN
    is the MoE FFN ``moe`` (JAX's name), expert-parallel over
    ``moe_mesh``'s 'expert' axis; ``attention_fn`` replaces the attention
    (ring attention), the parameters unchanged."""

    def __init__(self, dim: int, num_heads: int = 8, ff_dim: int = 3072,
                 dropout: float = 0.1, dtype=torch.bfloat16,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 attention_fn=None, moe_mesh=None):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(dim, num_heads, dropout,
                                                 dtype, attention_fn)
        self.ln1 = LayerNorm(dim, dtype)
        if moe_experts:
            self.moe = MoEFFN(dim, moe_experts, ff_dim, moe_top_k,
                              dropout=dropout, dtype=dtype, mesh=moe_mesh)
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
        d = embed_dim
        attention_fn = None
        if cp_mesh is not None and cp_mesh.shape.get(SEQ_AXIS, 1) > 1:
            from surya_tpu_torch.parallel.ring_attention import (
                make_attention_fn,
            )

            attention_fn = make_attention_fn(cp_mesh)
        self.seq_len, self.num_layers, self.dtype = seq_len, num_layers, dtype
        self.freeze_backbone, self.dropout = freeze_backbone, dropout
        self.ring_attention = attention_fn is not None
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
                d, num_heads, 4 * d, dropout, dtype, moe_experts, moe_top_k,
                attention_fn, moe_mesh))
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


def fact_apply_pipelined(model: FactModel, image_sequence, numerical_sequence,
                         mesh, *,
                         num_microbatches: int | None = None,
                         batch_spec: str | None = None,
                         generator: torch.Generator | None = None):
    """FACT's forward with the fusion stack pipeline-parallel over
    the 'pipe' axis of ``mesh`` (``parallel/pipeline.py``'s GPipe schedule;
    one stage without a mesh) → (B, C) f32 logits, replicated over 'pipe'.
    ``embed`` and ``head`` run as the plain model's; stage s applies its
    L/S layers ``fusion{i}`` (the model may hold only those:
    ``pipeline.keep_stage_layers``).

    ``batch_spec="data"`` splits the global batch over the mesh's 'data'
    axis (PP×DP): each rank takes its rows of each microbatch
    (``Mesh.row_shard(B, M)``) and returns their logits. In train mode
    (``model.train()``) each (global layer, microbatch) pair draws its
    dropout from a generator of its own, folded from one draw of
    ``generator`` (each microbatch's masks the global microbatch's, as the
    data-parallel step draws them), so a pipelined run equals a sequential
    run on the same draws (``mesh`` of one stage), not the plain model's.
    Eval-mode logits are the plain model's. Ring attention (a ``cp_mesh``)
    composes with DP and TP, not with PP, and the MoE FFN not at all."""
    from surya_tpu_torch.parallel.pipeline import (
        PIPE,
        pipeline_apply,
        stage_range,
    )
    from surya_tpu_torch.parallel.ring_attention import dropout_seed

    if any(isinstance(m, MoEFFN) for m in model.modules()):
        raise NotImplementedError(
            "fact_apply_pipelined does not support MoE layers (PP x EP "
            "composition is out of scope): the pipelined stage layer is the "
            "dense PostLNEncoderLayer and the router's auxiliary loss cannot "
            "cross the schedule. Use the plain forward with an 'expert' mesh "
            "axis (parallel/moe.py) instead.")
    if model.ring_attention:
        raise ValueError("ring attention (cp_mesh) composes with DP and TP, "
                         "not with the pipelined FACT")
    if mesh is None:
        mesh = single_device_mesh(image_sequence.device.type, (PIPE,))
    train = model.training
    if train and model.dropout > 0 and generator is None:
        raise ValueError("fact_apply_pipelined in train mode needs a "
                         "dropout generator")
    b = image_sequence.shape[0]
    m = num_microbatches or mesh.shape.get(PIPE, 1)
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    layers = stage_range(model.num_layers, mesh)
    rows = micro_rows = None
    if batch_spec is not None:
        if batch_spec != DATA_AXIS:
            raise ValueError(f"batch_spec {batch_spec!r}: the batch splits "
                             f"over {DATA_AXIS!r} only")
        if mesh.shape[DATA_AXIS] > 1:
            rows = mesh.row_shard(b, m)
            micro_rows = mesh.row_shard(b // m)
            image_sequence = rows.take(image_sequence)
            numerical_sequence = rows.take(numerical_sequence)
    # the one draw reads a number back from the card: before the embed, so
    # the host queues the ticks while the card runs the ViT
    seed = dropout_seed(generator) if train and model.dropout > 0 else None
    with batch_rows(rows):
        emb = model.embed(image_sequence, numerical_sequence, generator)
    stage = [getattr(model, f"fusion{i}") for i in layers]

    def stage_fn(act, j):
        with batch_rows(micro_rows):
            for i, layer in zip(layers, stage):
                gen = (None if seed is None
                       else fold_in(seed, i, j, device=act.device))
                act = layer(act, gen)
        return act

    full = pipeline_apply(stage_fn, [p for layer in stage
                                     for p in layer.parameters()],
                          emb, mesh, num_microbatches=m)
    return model.head(full)
