"""The Zero123-Plus-class conditional diffusion UNet on the card, ported
from ``surya_tpu/models/diffusion/unet_cond.py``.

The reference's multiview stage runs ``sudo-ai/zero123plus-v1.1``
(``Zero123/batch_aug.py:59-67``): a Stable Diffusion 2 UNet conditioned
globally through cross-attention over CLIP-derived tokens and locally by
"reference attention": the clean conditioning image's latents run through
the same UNet (the write pass), and every self-attention layer's post-norm1
hidden states are appended to that layer's K/V source when the working
latents are denoised (the read pass). As in JAX, the bank is functional: a
write pass returns the list, a read pass takes it as ``refs``.

Module names are diffusers' own (``down_blocks.0.attentions.1.
transformer_blocks.0.attn1.to_q``), so :func:`import_unet` is a
``load_state_dict(strict=True)`` of a diffusers ``UNet2DConditionModel``
state_dict, and :func:`diffusers_state_dict` inverts JAX's
``_flax_path`` / ``_join_block_prefix`` walk. The public interface is
NHWC, as in JAX; inside, maps are NCHW views (channels_last memory when
the input is NHWC).

Numerics are flax's under a compute dtype with f32 parameters:

- GroupNorm and LayerNorm are flax's (``models/norms.py``): eps 1e-5 in the
  ResNet blocks, the transformer blocks and the output norm, 1e-6 in
  ``Transformer2DModel.norm``;
- convs and Dense layers cast input, kernel and bias to the compute dtype
  (``models.common.cast_matmul_weights`` casts them once for a run);
- attention (:func:`attention`) is written out as flax computes it: the
  logits ``q·kᵀ`` in f32 (products of compute-dtype values, accumulated
  in f32), times 1/√d, an f32 softmax, the probabilities cast to V's
  dtype before the second product. The JAX package computes it in XLA,
  not Pallas, so no hand kernel is owed;
- GEGLU takes the exact (erf) GELU of the gate in f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import Conv
from surya_tpu_torch.models.common import load_state, on_meta, reset_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.models.norms import GroupNorm, LayerNorm


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Shape config (field names follow diffusers' where they exist)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 1
    # attention heads per level (head width = channels // heads = 64 for
    # every SD2 level)
    num_heads: tuple = (5, 10, 20, 20)
    # which down levels carry cross-attention transformers (SD2: all but
    # the last); up levels are the mirror image
    down_has_attn: tuple = (True, True, True, False)
    cross_attention_dim: int = 1024
    use_linear_projection: bool = True
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.float32

    @property
    def up_has_attn(self) -> tuple:
        return tuple(reversed(self.down_has_attn))


def zero123plus_config(dtype=torch.bfloat16) -> UNetConfig:
    """The SD2 backbone zero123plus v1.1 fine-tunes (4-ch latents,
    2 layers/block, 1024-d cross attention over CLIP-derived tokens)."""
    return UNetConfig(layers_per_block=2, dtype=dtype)


def tiny_config(dtype=torch.float32) -> UNetConfig:
    """Test-sized instance of the same topology."""
    return UNetConfig(
        in_channels=4, out_channels=4, block_out_channels=(8, 16),
        layers_per_block=1, num_heads=(2, 2), down_has_attn=(True, False),
        cross_attention_dim=12, norm_num_groups=4, dtype=dtype)


# SD2/zero123plus use one BasicTransformerBlock per Transformer2DModel;
# the bank accounting in UNet2DCondition assumes it.
_LAYERS_PER_TRANSFORMER = 1


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Dense(nn.Linear):
    """flax ``Dense(dtype=...)``: kernel and bias cast to the input's
    dtype (the caller has cast the input to the compute dtype)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv:
    """A biased conv with flax's explicit ((k//2, k//2),)*2 padding."""
    return Conv(cin, cout, k, stride=stride, padding=k // 2, bias=True)


@contextlib.contextmanager
def _exact_tf32(t: torch.Tensor):
    """On the card, let an f32 product of bf16/f16-valued operands use
    TF32 tensor cores: a TF32 operand holds a bf16 value exactly and the
    sum is kept in f32, so the product is the bf16 one accumulated in
    f32, as flax's ``preferred_element_type=float32`` asks."""
    if t.device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def attention_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(…, T, d) · (…, S, d)ᵀ → (…, T, S) in f32, accumulated in f32."""
    if q.dtype == torch.float32:
        return torch.matmul(q, k.transpose(-1, -2))
    with _exact_tf32(q):
        return torch.matmul(q.float(), k.float().transpose(-1, -2))


def attention(q, k, v, scale: float) -> torch.Tensor:
    """flax's attention, written out: f32 logits × scale, f32 softmax,
    probabilities in V's dtype times V."""
    logits = attention_logits(q, k) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def get_timestep_embedding(timesteps, dim: int,
                           max_period: float = 10000.0):
    """diffusers ``get_timestep_embedding`` with SD's settings
    (``flip_sin_to_cos=True, downscale_freq_shift=0``): (B,) → (B, dim),
    ``[cos | sin]`` halves."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    ang = timesteps.float()[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D: GN→SiLU→conv ×2 with a time-embedding
    shift between, 1×1 shortcut on a channel change."""

    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps=1e-5)
        self.conv1 = conv(cin, cout, 3)
        self.time_emb_proj = Dense(temb_dim, cout)
        self.norm2 = GroupNorm(cout, groups, eps=1e-5)
        self.conv2 = conv(cout, cout, 3)
        self.conv_shortcut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """diffusers Attention: no-bias q/k/v, biased output projection
    (``to_out.0``). ``context=None`` → self-attention."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Dense(inner, query_dim), nn.Identity()])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, t, _ = x.shape
        s = ctx.shape[1]
        nh, d = self.heads, self.dim_head
        q = self.to_q(x).reshape(b, t, nh, d).transpose(1, 2)
        k = self.to_k(ctx).reshape(b, s, nh, d).transpose(1, 2)
        v = self.to_v(ctx).reshape(b, s, nh, d).transpose(1, 2)
        out = attention(q, k, v, 1.0 / math.sqrt(d))
        return self.to_out[0](out.transpose(1, 2).reshape(b, t, nh * d))


class GEGLU(nn.Module):
    """``ff.net.0``: one projection to twice the width, split into value
    and gate; value · GELU(gate), the GELU exact and in f32."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Dense(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate.float()).to(h.dtype)


class FeedForward(nn.Module):
    """diffusers FeedForward with GEGLU (``net.0.proj``, ``net.2``)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Dense(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """self-attn → cross-attn → GEGLU FF, pre-LayerNorm residuals. Returns
    the post-norm1 states (the bank entry); ``ref`` is appended to
    self-attention's K/V source."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int,
                 dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim, dtype, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_dim)
        self.norm3 = LayerNorm(dim, dtype, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, ref=None):
        h = self.norm1(x)
        kv = h if ref is None else torch.cat([h, ref.to(h.dtype)], dim=1)
        x = x + self.attn1(h, kv)
        x = x + self.attn2(self.norm2(x), context)
        x = x + self.ff(self.norm3(x))
        return x, h


class Transformer2DModel(nn.Module):
    """GroupNorm (eps 1e-6) → (linear | 1×1-conv) proj in → the transformer
    blocks → proj out, spatial residual."""

    def __init__(self, channels: int, heads: int, cross_dim: int,
                 groups: int, use_linear_projection: bool, dtype):
        super().__init__()
        inner = channels   # heads · (channels // heads)
        self.linear = use_linear_projection
        self.norm = GroupNorm(channels, groups, eps=1e-6)
        self.proj_in = (Dense(channels, inner) if self.linear
                        else conv(channels, inner, 1))
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, inner // heads, cross_dim,
                                  dtype)
            for _ in range(_LAYERS_PER_TRANSFORMER)])
        self.proj_out = (Dense(inner, channels) if self.linear
                         else conv(inner, channels, 1))

    def forward(self, x, context, refs=None):
        b, _, hgt, wid = x.shape
        h = self.norm(x)
        if not self.linear:
            h = self.proj_in(h)
        inner = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(b, hgt * wid, inner)
        if self.linear:
            h = self.proj_in(h)
        banked = []
        for i, block in enumerate(self.transformer_blocks):
            h, bank = block(h, context, None if refs is None else refs[i])
            banked.append(bank)
        if self.linear:
            h = self.proj_out(h)
        h = h.reshape(b, hgt, wid, h.shape[-1]).permute(0, 3, 1, 2)
        if not self.linear:
            h = self.proj_out(h)
        return h + x, banked


class Sampler(nn.Module):
    """``downsamplers.0`` (3×3/2 conv, padding 1) or ``upsamplers.0``
    (nearest 2×, exactly 2× so torch's "nearest" is flax's, then a 3×3
    conv)."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = conv(channels, channels, 3, stride=2 if down else 1)

    def forward(self, x):
        if not self.down:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x)


class Level(nn.Module):
    """One ``down_blocks.i`` / ``up_blocks.i`` / ``mid_block`` container:
    ``resnets``, ``attentions`` (empty without), ``downsamplers`` /
    ``upsamplers``."""

    def __init__(self, resnets, attentions=(), downsample=None,
                 upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([Sampler(downsample, True)])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([Sampler(upsample, False)])


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = Dense(cin, dim)
        self.linear_2 = Dense(dim, dim)


class UNet2DCondition(nn.Module):
    """The full conditional UNet. ``refs=None`` is a plain forward that
    also returns the self-attention hidden-state bank (write pass); pass
    that bank back as ``refs`` to denoise with reference attention (read
    pass). Banks are position-matched lists, one entry per transformer
    block in traversal order.

    Call: ``(sample (B,H,W,Cin), timesteps (B,) or scalar,
    encoder_hidden_states (B,S,cross_dim)) → (eps/v (B,H,W,Cout) f32,
    bank list)``.
    """

    def __init__(self, config: UNetConfig, generator=None):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        tdim = 4 * ch0
        g, dt = cfg.norm_num_groups, cfg.dtype
        n = len(cfg.block_out_channels)

        def transformer(c, heads):
            return Transformer2DModel(c, heads, cfg.cross_attention_dim, g,
                                      cfg.use_linear_projection, dt)

        self.conv_in = conv(cfg.in_channels, ch0, 3)
        self.time_embedding = TimestepEmbedding(ch0, tdim)
        skip_ch = [ch0]
        cin = ch0
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(cfg.block_out_channels):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(cin, ch, tdim, g))
                if cfg.down_has_attn[i]:
                    attns.append(transformer(ch, cfg.num_heads[i]))
                cin = ch
                skip_ch.append(ch)
            down = ch if i < n - 1 else None
            if down:
                skip_ch.append(ch)
            self.down_blocks.append(Level(resnets, attns, downsample=down))
        mid = cfg.block_out_channels[-1]
        self.mid_block = Level(
            [ResnetBlock2D(mid, mid, tdim, g),
             ResnetBlock2D(mid, mid, tdim, g)],
            [transformer(mid, cfg.num_heads[-1])])
        self.up_blocks = nn.ModuleList()
        rev_ch = tuple(reversed(cfg.block_out_channels))
        rev_heads = tuple(reversed(cfg.num_heads))
        cin = mid
        for i, ch in enumerate(rev_ch):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(cin + skip_ch.pop(), ch, tdim,
                                             g))
                if cfg.up_has_attn[i]:
                    attns.append(transformer(ch, rev_heads[i]))
                cin = ch
            self.up_blocks.append(Level(
                resnets, attns, upsample=ch if i < n - 1 else None))
        self.conv_norm_out = GroupNorm(ch0, g, eps=1e-5)
        self.conv_out = conv(ch0, cfg.out_channels, 3)
        if generator is not None or not on_meta(self):
            self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        reset_model(self, generator)

    def forward(self, sample, timesteps, encoder_hidden_states,
                refs: Optional[Sequence[torch.Tensor]] = None):
        cfg = self.config
        dt = cfg.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        context = encoder_hidden_states.to(dt)
        temb = get_timestep_embedding(timesteps, cfg.block_out_channels[0])
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(temb.to(dt))))

        bank_out: list = []
        ref_iter = iter(refs) if refs is not None else None

        def attn(block, x):
            block_refs = None
            if ref_iter is not None:
                block_refs = [next(ref_iter)
                              for _ in range(_LAYERS_PER_TRANSFORMER)]
            y, banked = block(x, context, block_refs)
            bank_out.extend(banked)
            return y

        x = self.conv_in(sample.to(dt).permute(0, 3, 1, 2))
        skips = [x]
        for i, level in enumerate(self.down_blocks):
            for j, resnet in enumerate(level.resnets):
                x = resnet(x, temb)
                if cfg.down_has_attn[i]:
                    x = attn(level.attentions[j], x)
                skips.append(x)
            if hasattr(level, "downsamplers"):
                x = level.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = attn(mid.attentions[0], x)
        x = mid.resnets[1](x, temb)

        for i, level in enumerate(self.up_blocks):
            for j, resnet in enumerate(level.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
                if cfg.up_has_attn[i]:
                    x = attn(level.attentions[j], x)
            if hasattr(level, "upsamplers"):
                x = level.upsamplers[0](x)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1).float(), bank_out


def reference_conditioned_denoiser(model: UNet2DCondition, schedule,
                                   encoder_hidden_states, cond_latents, *,
                                   generator=None, cond_noise=None):
    """The zero123plus two-pass denoiser (``RefOnlyNoisedUNet``): at step
    i the clean conditioning latents are forward-noised to sigma_i and
    input-scaled, run through the UNet (write pass) for every
    self-attention's post-norm1 states, and the working latents are
    denoised with those banks appended to each self-attention's K/V (read
    pass). The cond noise of step i is ``cond_noise(i)`` or a fresh draw
    from ``generator`` on the latents' device (JAX: ``fold_in(key, i)``).
    Returns ``denoiser(scaled_latents, t, i) → model_output``, the contract
    of :func:`euler_ancestral.sample`; the step index comes from the loop
    (JAX recovers it as ``argmin(|timesteps − t|)``)."""
    if generator is None and cond_noise is None:
        raise ValueError("the cond noise needs a generator or cond_noise")

    def denoiser(scaled, t, i):
        sigma = schedule.sigma(i, cond_latents)
        noise = (cond_noise(i).to(cond_latents) if cond_noise is not None
                 else torch.randn(cond_latents.shape, generator=generator,
                                  device=cond_latents.device))
        noisy_cond = ((cond_latents + sigma * noise)
                      / torch.sqrt(sigma ** 2 + 1.0))
        ts = t.expand(scaled.shape[0])
        _, bank = model(noisy_cond, ts, encoder_hidden_states)
        out, _ = model(scaled, ts, encoder_hidden_states, refs=bank)
        return out

    return denoiser


# flax module path (``/`` → ``.``) → diffusers module path, in this order
_DIFFUSERS = [(re.compile(a), b) for a, b in (
    (r"\b(down_blocks|up_blocks)_(\d+)_", r"\1.\2."),
    (r"\bmid_block_", "mid_block."),
    (r"\b(resnets|attentions|downsamplers|upsamplers|transformer_blocks)"
     r"_(\d+)", r"\1.\2"),
    (r"\b(downsamplers|upsamplers)\.0_conv\b", r"\1.0.conv"),
    (r"\bto_out_0\b", "to_out.0"),
    (r"\bnet_0_proj\b", "net.0.proj"),
    (r"\bnet_2\b", "net.2"),
    (r"\btime_embedding_(linear_\d)\b", r"time_embedding.\1"))]


def _diffusers_path(path: str) -> str:
    """``down_blocks_0_attentions_0.transformer_blocks_0.ff.net_0_proj`` →
    ``down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj``."""
    for pattern, repl in _DIFFUSERS:
        path = pattern.sub(repl, path)
    return path


def diffusers_state_dict(variables) -> dict[str, torch.Tensor]:
    """A JAX UNet's or VAE's variable tree → the port's state_dict, under
    diffusers' names (``models.from_jax.from_jax_variables``, whose names
    keep JAX's flattened block paths, then the dots put back)."""
    return {_diffusers_path(k): v
            for k, v in from_jax_variables(variables).items()}


def import_unet(state_dict, config: UNetConfig, device=None
                ) -> UNet2DCondition:
    """A diffusers ``UNet2DConditionModel.state_dict()`` → the port's
    UNet: the same names, so a strict load."""
    return load_state(lambda: UNet2DCondition(config), state_dict, device)
