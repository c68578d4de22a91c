"""The ViT-B/16 backbone in PyTorch, mirroring
``surya_tpu/models/backbones/vit.py`` (timm's ``vit_base_patch16_224``
architecture): a 16×16 patch embed (a strided conv with a bias) → 768, a
learned CLS token and position embeddings, 12 pre-LN encoder blocks (12
heads, MLP 3072, exact-erf GELU), a final LN; it returns the CLS
embedding. Weights come from seed 0 or from a JAX tree
(``models/from_jax.py``); no pretrained checkpoint is read.

Numerics are flax's under a compute dtype with f32 parameters:

- ``LayerNorm`` is flax's, eps **1e-6** (flax's default; torch's is 1e-5):
  statistics and the affine in f32, the output in the compute dtype.
- Dense layers (``dense``) cast input, kernel and bias to the compute
  dtype.
- ``MultiHeadDotProductAttention`` is flax's with its defaults
  (``dot_product_attention_weights``): q is divided by √head_dim (rounded
  to the compute dtype) in the compute dtype, QKᵀ and the softmax run in
  the compute dtype, and attention dropout is **broadcast**: one (q, k)
  keep mask shared over the batch and the heads, scaled by 1/keep, drawn
  from the caller's ``torch.Generator``. ``F.scaled_dot_product_attention``
  draws its dropout from the global generator and cannot share a mask, so
  the attention is written out (no Pallas kernel lies behind it in JAX).

Parameters keep the flax names: ``patch_embed`` (OIHW), ``cls_token``,
``pos_embed``, ``block{i}.{ln1,attn,ln2,mlp}``, ``attn.{query,key,value,
out}`` as ``nn.Linear`` (d → d; the bridge reshapes flax's per-head
kernels), ``mlp.{fc1,fc2}``, ``ln_final``. ``pos_embed`` is sized from the
image at construction, as flax sizes it at init.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import Conv, nchw, nhwc
from surya_tpu_torch.models.common import dense, flax_dropout, reset_model
from surya_tpu_torch.models.norms import LayerNorm


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` as the models call it
    (self-attention, qkv and out widths = d, biases, broadcast dropout on
    the attention weights at ``dropout``). ``attention_fn`` (flax's
    ``attention_fn=``) replaces the attention of the projected (B, L, h,
    d/h) q, k, v: ``attention_fn(q, k, v, dropout_rate=, generator=,
    training=)`` → (B, L, h, d/h); no parameter or name changes."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype=torch.bfloat16, attention_fn=None):
        super().__init__()
        self.attention_fn = attention_fn
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by "
                             f"{num_heads} heads")
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.num_heads, self.dropout, self.dtype = num_heads, dropout, dtype
        # flax divides by jnp.sqrt(depth).astype(dtype)
        self.scale = float(torch.tensor(math.sqrt(dim // num_heads),
                                        dtype=dtype, device="cpu"))

    def forward(self, x, generator=None):
        """(B, L, d) → (B, L, d) in the compute dtype."""
        b, n, d = x.shape
        q, k, v = (dense(x, layer, self.dtype).view(b, n, self.num_heads, -1)
                   for layer in (self.query, self.key, self.value))
        if self.attention_fn is not None:
            o = self.attention_fn(q, k, v, dropout_rate=self.dropout,
                                  generator=generator,
                                  training=self.training)
        else:   # (B, h, L, d/h)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            w = torch.softmax((q / self.scale) @ k.transpose(-2, -1), dim=-1)
            w = flax_dropout(w, self.dropout, generator, self.training,
                             shape=(n, n))
            o = (w @ v).transpose(1, 2)
        return dense(o.reshape(b, n, d), self.out, self.dtype)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dropout: float = 0.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)
        self.dropout, self.dtype = dropout, dtype

    def forward(self, x, generator=None):
        x = F.gelu(dense(x, self.fc1, self.dtype))   # exact erf, as timm's
        x = flax_dropout(x, self.dropout, generator, self.training)
        x = dense(x, self.fc2, self.dtype)
        return flax_dropout(x, self.dropout, generator, self.training)


class EncoderBlock(nn.Module):
    """Pre-LN: x + attn(ln1(x)), then + mlp(ln2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 dropout: float = 0.0, dtype=torch.bfloat16):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = MultiHeadDotProductAttention(dim, num_heads, dropout,
                                                 dtype)
        self.ln2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, mlp_dim, dropout, dtype)

    def forward(self, x, generator=None):
        x = x + self.attn(self.ln1(x), generator)
        return x + self.mlp(self.ln2(x), generator)


class ViT(nn.Module):
    """(B, H, W, 3) NHWC → (B, embed_dim): the final-LN CLS embedding."""

    def __init__(self, image_size: int = 224, patch: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dropout: float = 0.0,
                 dtype=torch.bfloat16):
        super().__init__()
        if image_size % patch:
            # flax's "SAME" patch conv would make a patch grid that the
            # reshape to (h // patch) · (w // patch) tokens cannot take
            raise ValueError(f"image size {image_size} is not a multiple "
                             f"of the {patch}-px patch")
        self.patch, self.depth, self.dtype = patch, depth, dtype
        self.dropout = dropout
        n = (image_size // patch) ** 2
        self.patch_embed = Conv(3, embed_dim, patch, patch, bias=True)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                embed_dim, num_heads, mlp_dim, dropout, dtype))
        self.ln_final = LayerNorm(embed_dim, dtype)

    def reset_parameters(self, generator=None):
        """flax's init; the CLS token zeros, ``pos_embed`` N(0, 0.02)."""
        reset_model(self, generator)
        with torch.no_grad():
            self.cls_token.zero_()
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        b, h, w, _ = x.shape
        n, d = self.pos_embed.shape[1] - 1, self.pos_embed.shape[2]
        if h % self.patch or w % self.patch or (
                (h // self.patch) * (w // self.patch) != n):
            raise ValueError(f"a {h}×{w} image does not give the {n} "
                             f"{self.patch}-px patches this ViT was built "
                             "for (image_size)")
        dt = self.dtype
        x = nhwc(self.patch_embed(nchw(x.to(dt)))).reshape(b, n, d)
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, d), x], dim=1)
        x = flax_dropout(x + self.pos_embed.to(dt), self.dropout, generator,
                         self.training)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, generator)
        return self.ln_final(x[:, 0])   # LN is per token: the CLS row only


def vit_base_patch16(image_size: int = 224, dtype=torch.bfloat16) -> ViT:
    return ViT(image_size, dtype=dtype)
