"""Small pixel-space conditional denoiser, ported from
``surya_tpu/models/diffusion/tiny_unet.py``.

Stands in for the zero123plus UNet in the pixel-space sampling path
(``augmentgen.multiview.torch_diffusion_generate_fn``): a sinusoidal
timestep embedding, the conditioning image concatenated to the noisy one,
a strided conv down and a resize up. Module names follow the flax tree
(``temb_dense``, ``in_conv``, ``gn0``..``gn3``, ``down``, ``mid``, ``up``,
``out_conv``), so ``models.from_jax.from_jax_variables`` maps JAX weights
one to one. Everything runs in f32 (the flax model's convs promote to
their f32 parameters).

Two of flax's rules differ from torch's defaults:

- SAME padding of the stride-2 conv is (0, 1) on an even size and (1, 1)
  on an odd one;
- the up path resizes "nearest" to the skip's exact size, which is not 2×
  on odd sizes: ``jax.image.resize`` samples at half-pixel centres,
  floor((i + 0.5)·in/out), which is ``F.interpolate(mode="nearest-exact")``
  (``mode="nearest"`` takes floor(i·in/out); the two agree at exactly 2×).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import Conv
from surya_tpu_torch.models.common import reset_model
from surya_tpu_torch.models.norms import GroupNorm


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding of a scalar (train-timestep) → (dim,)."""
    half = dim // 2
    t = torch.as_tensor(t)
    # a 0-dim CPU tensor: f32's log, as jnp.log takes it; no copy
    log_period = torch.log(torch.tensor(max_period))
    freqs = torch.exp(-log_period
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float() * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)])


def same_pad(size: int, k: int = 3, stride: int = 2) -> tuple[int, int]:
    """flax SAME padding (low, high) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class TinyDenoiser(nn.Module):
    """(B,H,W,3) noisy + scalar t + (B,H,W,3) conditioning → (B,H,W,3)."""

    def __init__(self, features: int = 32, generator=None):
        super().__init__()
        f = self.features = features
        self.temb_dense = nn.Linear(2 * f, f)
        self.in_conv = Conv(6, f, 3, padding=1, bias=True)
        self.gn0 = GroupNorm(f, 8)
        self.down = Conv(f, 2 * f, 3, stride=2, bias=True)
        self.gn1 = GroupNorm(2 * f, 8)
        self.mid = Conv(2 * f, 2 * f, 3, padding=1, bias=True)
        self.gn2 = GroupNorm(2 * f, 8)
        self.up = Conv(2 * f, f, 3, padding=1, bias=True)
        self.gn3 = GroupNorm(f, 8)
        self.out_conv = Conv(2 * f, 3, 3, padding=1, bias=True)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """flax's init; ``out_conv``'s kernel starts at zeros, as in JAX."""
        reset_model(self, generator)
        with torch.no_grad():
            self.out_conv.weight.zero_()

    def forward(self, x, t, cond):
        f = self.features
        temb = F.linear(timestep_embedding(t, 2 * f).to(x.device),
                        self.temb_dense.weight, self.temb_dense.bias)
        h = torch.cat([x, cond], -1).float().permute(0, 3, 1, 2)
        h = self.in_conv(h) + temb[None, :, None, None]
        h = F.silu(self.gn0(h))
        skip = h
        ph, pw = same_pad(h.shape[2]), same_pad(h.shape[3])
        h = self.down(F.pad(h, (*pw, *ph)))
        h = F.silu(self.gn1(h))
        h = F.silu(self.gn2(self.mid(h)))
        # resize to the skip's exact dims (not 2×): SAME-padded stride-2
        # gives ceil(h/2), so doubling would mismatch odd inputs
        h = F.interpolate(h, size=skip.shape[2:], mode="nearest-exact")
        h = F.silu(self.gn3(self.up(h)))
        out = self.out_conv(torch.cat([h, skip], 1))
        return out.permute(0, 2, 3, 1).float()
