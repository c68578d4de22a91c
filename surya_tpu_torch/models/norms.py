"""flax's GroupNorm and LayerNorm, written out once for every model of the
port that uses them: the pose net (``models/pose/landmark_net.py``), the
ViT and FACT (``models/backbones/vit.py``, ``models/temporal/fact.py``),
and the generative tier (``models/diffusion/*``).

- :class:`GroupNorm` is flax ``nn.GroupNorm`` on an NCHW map: per-sample
  group statistics in (at least) f32 with the fast variance
  E[x²] − E[x]² clipped at 0, ``(x − mean)·(rsqrt(var + eps)·scale) +
  bias`` in f32, the result in the input's dtype. ``torch.nn.GroupNorm``
  differs: a two-pass variance and eps 1e-5 by default. flax's default eps
  is 1e-6 (the pose net, the VAE, ``TinyDenoiser``); the zero123plus UNet's
  ResNet blocks and output norm ask for 1e-5.
- :class:`LayerNorm` is flax ``nn.LayerNorm(dtype=dtype)``: statistics and
  the affine in f32, the output in ``dtype``; flax's eps is 1e-6 (the ViT,
  FACT), the UNet's transformer blocks ask for 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The statistics' dtype: at least f32, as flax promotes."""
    return torch.promote_types(dtype, torch.float32)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(groups, epsilon=eps)`` on an NCHW map. Channel
    means are taken first and then averaged per group (equal counts), so a
    channels_last map needs no re-layout."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-6):
        super().__init__()
        if channels % groups:
            raise ValueError(f"{channels} channels do not split into "
                             f"{groups} groups")
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.groups
        xf = x.to(acc_dtype(x.dtype))
        mu = xf.mean((2, 3)).reshape(b, g, -1).mean(-1)
        mu2 = (xf * xf).mean((2, 3)).reshape(b, g, -1).mean(-1)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mean = mu.repeat_interleave(c // g, 1)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(c // g, 1)
        mul = mul * self.weight
        y = (xf - mean[..., None, None]) * mul[..., None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps, dtype=dtype)`` over the last
    dimension: f32 statistics and affine, the output in ``dtype``."""

    def __init__(self, dim: int, dtype=torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype, self.eps = dtype, eps

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)
