"""AutoencoderKL, the SD-family VAE zero123plus runs its latents through,
on the card; ported from ``surya_tpu/models/diffusion/vae.py``.

Module names are diffusers' (``encoder.down_blocks.0.resnets.0...``,
``quant_conv``), so :func:`import_vae` is a strict load of a diffusers
``AutoencoderKL`` state_dict. The interface is NHWC, as in JAX.

Structure (diffusers semantics):

- encoder downsample convs pad (0, 1, 0, 1) and are VALID, stride 2
  (unlike the UNet's padding-1 downsample);
- the mid-block attention is single-head, full-width spatial attention
  with a pre-GroupNorm, biased q/k/v/out and a residual, computed as
  flax does (f32 logits, scaled by 1/√C after the f32 cast, f32 softmax,
  probabilities in V's dtype);
- every GroupNorm has eps 1e-6; SiLU activations;
- ``encode`` returns the diagonal-Gaussian moments (logvar clipped to
  [−30, 20]); :func:`sample_latents` reparameterises with a draw the
  caller passes or one from its generator; the SD scaling factor
  (0.18215) is the pipeline's multiplier.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import Conv
from surya_tpu_torch.models.common import load_state, on_meta, reset_model
from surya_tpu_torch.models.diffusion.unet_cond import (
    Dense,
    Sampler,
    attention_logits,
    conv,
)
from surya_tpu_torch.models.norms import GroupNorm

SD_SCALING_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.float32


def sd_vae_config(dtype=torch.bfloat16) -> VAEConfig:
    return VAEConfig(dtype=dtype)


def tiny_vae_config(dtype=torch.float32) -> VAEConfig:
    return VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                     norm_num_groups=4, dtype=dtype)


class VAEResnetBlock(nn.Module):
    """The UNet's ResnetBlock2D without the time-embedding shift."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps=1e-6)
        self.conv1 = conv(cin, cout, 3)
        self.norm2 = GroupNorm(cout, groups, eps=1e-6)
        self.conv2 = conv(cout, cout, 3)
        self.conv_shortcut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """diffusers' VAE mid-block Attention (``group_norm``, ``to_q``,
    ``to_k``, ``to_v``, ``to_out.0``)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups, eps=1e-6)
        self.to_q = Dense(channels, channels)
        self.to_k = Dense(channels, channels)
        self.to_v = Dense(channels, channels)
        self.to_out = nn.ModuleList([Dense(channels, channels),
                                     nn.Identity()])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        probs = torch.softmax(attention_logits(q, k) / math.sqrt(c), dim=-1)
        out = self.to_out[0](torch.matmul(probs.to(v.dtype), v))
        return x + out.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    """diffusers' VAE Downsample2D: pad (0, 1, 0, 1), VALID 3×3/2 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, bias=True)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class CoderLevel(nn.Module):
    def __init__(self, resnets, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([Downsample(downsample)])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([Sampler(upsample, False)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for s in (*getattr(self, "downsamplers", ()),
                  *getattr(self, "upsamplers", ())):
            x = s(x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels,
                                                     groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


class Coder(nn.Module):
    """The encoder (``is_encoder``) or decoder tower; NCHW in, NCHW f32
    out."""

    def __init__(self, cfg: VAEConfig, is_encoder: bool):
        super().__init__()
        self.is_encoder, self.dtype = is_encoder, cfg.dtype
        g = cfg.norm_num_groups
        chans = cfg.block_out_channels
        n = len(chans)
        mid = chans[-1]
        if is_encoder:
            self.conv_in = conv(cfg.in_channels, chans[0], 3)
            cin = chans[0]
            self.down_blocks = nn.ModuleList()
            for i, ch in enumerate(chans):
                resnets = []
                for _ in range(cfg.layers_per_block):
                    resnets.append(VAEResnetBlock(cin, ch, g))
                    cin = ch
                self.down_blocks.append(CoderLevel(
                    resnets, downsample=ch if i < n - 1 else None))
            self.mid_block = MidBlock(mid, g)
            out_ch, last = 2 * cfg.latent_channels, mid
        else:
            self.conv_in = conv(cfg.latent_channels, mid, 3)
            self.mid_block = MidBlock(mid, g)
            cin = mid
            self.up_blocks = nn.ModuleList()
            for i, ch in enumerate(reversed(chans)):
                resnets = []
                for _ in range(cfg.layers_per_block + 1):
                    resnets.append(VAEResnetBlock(cin, ch, g))
                    cin = ch
                self.up_blocks.append(CoderLevel(
                    resnets, upsample=ch if i < n - 1 else None))
            out_ch, last = cfg.out_channels, chans[0]
        self.conv_norm_out = GroupNorm(last, g, eps=1e-6)
        self.conv_out = conv(last, out_ch, 3)

    def forward(self, x):
        x = self.conv_in(x.to(self.dtype))
        if self.is_encoder:
            for level in self.down_blocks:
                x = level(x)
            x = self.mid_block(x)
        else:
            x = self.mid_block(x)
            for level in self.up_blocks:
                x = level(x)
        return self.conv_out(F.silu(self.conv_norm_out(x))).float()


class AutoencoderKL(nn.Module):
    """``encode`` → (mean, logvar); ``decode`` ← latents; the call runs a
    reconstruction (the mean, or a sample with ``noise``)."""

    def __init__(self, config: VAEConfig, generator=None):
        super().__init__()
        self.config = config
        lc = config.latent_channels
        self.encoder = Coder(config, True)
        self.decoder = Coder(config, False)
        self.quant_conv = conv(2 * lc, 2 * lc, 1)
        self.post_quant_conv = conv(lc, lc, 1)
        if generator is not None or not on_meta(self):
            self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        reset_model(self, generator)

    def encode(self, x):
        """(B,H,W,3) → mean, logvar (B,H/f,W/f,latent) f32."""
        dt = self.config.dtype
        moments = self.quant_conv(
            self.encoder(x.permute(0, 3, 1, 2)).to(dt)).float()
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        """(B,h,w,latent) → (B,h·f,w·f,3) f32."""
        z = self.post_quant_conv(z.to(self.config.dtype).permute(0, 3, 1, 2))
        return self.decoder(z).permute(0, 2, 3, 1)

    def forward(self, x, noise=None):
        mean, logvar = self.encode(x)
        z = mean if noise is None else sample_latents(mean, logvar, noise)
        return self.decode(z), (mean, logvar)


def sample_latents(mean, logvar, noise=None, generator=None):
    """Diagonal-Gaussian reparameterisation (diffusers
    ``DiagonalGaussianDistribution.sample``); the standard-normal draw is
    ``noise`` or comes from ``generator`` on the moments' device."""
    if noise is None:
        if generator is None:
            raise ValueError("sample_latents needs noise or a generator")
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean)


def import_vae(state_dict, config: VAEConfig, device=None) -> AutoencoderKL:
    """A diffusers ``AutoencoderKL.state_dict()`` → the port's VAE: the
    same names, so a strict load."""
    return load_state(lambda: AutoencoderKL(config), state_dict, device)
