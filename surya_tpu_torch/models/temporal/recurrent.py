"""Stacked LSTM over (B, T, D) sequences, mirroring
``surya_tpu/models/temporal/recurrent.py`` (flax ``OptimizedLSTMCell``
layers under ``nn.RNN``).

The numerics are flax's with f32 parameters and a compute dtype:

- gates [i, f, g, o]; each pre-activation is ``(h @ Wh + b) + x @ Wi`` in
  the compute dtype (inputs, kernels and bias cast to it), then sigmoid,
  sigmoid, tanh, sigmoid in the compute dtype;
- the carry starts at zero in f32 and stays f32:
  ``c' = f·c + (i·g)`` and ``h' = o·tanh(c')`` run in f32, so every layer
  returns f32 outputs, as flax's does;
- inter-layer dropout on every layer's output but the last, drawn from the
  caller's ``torch.Generator`` (flax's ``"dropout"`` stream), never from
  the global one. ``nn.LSTM(dropout=...)`` would draw from the global
  generator, so the layers are written out.

``x @ Wi`` is one product over all T steps; the recurrence is a Python loop
over T (≤ 5 in every preset) of one ``F.linear`` each. No Pallas kernel
lies behind this module in JAX (a ``lax.scan`` of XLA ops).

Parameters per layer, module ``OptimizedLSTMCell_{k}`` (the flax name):
``weight_ih`` (4H, D) and ``weight_hh`` (4H, H), the four gates' kernels
stacked in [i, f, g, o] order, and ``bias`` (4H), the ``h{g}`` biases
(flax's ``i{g}`` kernels have none). ``models/from_jax.py`` stacks the flax
per-gate leaves into these.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from surya_tpu_torch.models.backbones.resnet import lecun_normal_
from surya_tpu_torch.models.common import flax_dropout

GATES = "ifgo"


class LSTMCell(nn.Module):
    """One flax ``OptimizedLSTMCell`` layer, run over a whole sequence."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def reset_parameters(self, generator=None):
        """flax's init: lecun_normal input kernels, orthogonal recurrent
        kernels (each gate's own (H, H) block), zero bias."""
        h = self.hidden
        with torch.no_grad():
            for k in range(4):
                lecun_normal_(self.weight_ih[k * h:(k + 1) * h],
                              self.weight_ih.shape[1], generator)
                # orthogonal per block, transposed as flax's (in, out) kernel
                block = torch.empty(h, h)
                nn.init.orthogonal_(block, generator=generator)
                self.weight_hh[k * h:(k + 1) * h] = block.T
            self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """(B, T, D) → (B, T, H) f32 outputs."""
        b, t, _ = x.shape
        xw = F.linear(x.to(dtype), self.weight_ih.to(dtype))   # all T at once
        wh, bias = self.weight_hh.to(dtype), self.bias.to(dtype)
        c = h = x.new_zeros((b, self.hidden), dtype=torch.float32)
        outs = []
        for s in range(t):
            z = F.linear(h.to(dtype), wh, bias) + xw[:, s]
            i, f, g, o = z.chunk(4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            c = f.float() * c + (i * g).float()
            h = o.float() * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


class StackedLSTM(nn.Module):
    """``num_layers`` LSTM layers; (B, T, D) → (B, T, hidden) f32 outputs of
    the top layer."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 1,
                 dropout: float = 0.0, dtype=torch.bfloat16):
        super().__init__()
        self.num_layers, self.dropout, self.dtype = num_layers, dropout, dtype
        for k in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{k}",
                            LSTMCell(in_dim if k == 0 else hidden, hidden))

    def reset_parameters(self, generator=None):
        for k in range(self.num_layers):
            getattr(self, f"OptimizedLSTMCell_{k}").reset_parameters(generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = x.to(self.dtype)
        for k in range(self.num_layers):
            x = getattr(self, f"OptimizedLSTMCell_{k}")(x, self.dtype)
            if k < self.num_layers - 1:
                x = flax_dropout(x, self.dropout, generator, self.training)
        return x


def last_step(outputs: torch.Tensor) -> torch.Tensor:
    """(B, T, H) → (B, H): the final time step's output."""
    return outputs[:, -1, :]
