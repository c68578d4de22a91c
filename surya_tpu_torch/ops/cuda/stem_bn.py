"""Train-mode BatchNorm + ReLU over an NHWC map as two passes: per-channel
statistics, then a folded affine + ReLU.

Replaces ``surya_tpu/ops/pallas/stem_bn.py``: :func:`channel_stats` for
``_stats_kernel``, :func:`affine_relu` for ``_affine_relu_kernel``, and
:func:`fused_bn_relu_train` combining them with JAX's folding. The kernels
are in ``csrc/stem_bn.cu``; its source note says what bounds them on the
card (memory: the (256, 112, 112, 64) bf16 stem map is 411 MB, read once by
the first pass, read and written once by the second) and what the design
does about it. The TPU kernels' lane packing, row padding and ``C = 64``
restriction are not carried over: any channel count and any number of rows
are taken, in f32 or bf16.

As in JAX these are wired into no model (the port's ``BatchNorm`` does not
call them) and have no backward; ``chip_smoke.py``'s ``stem_probe`` phase
drives them, as ``scripts/tpu_stem_fusion_probe.py`` drives the TPU ones.

Each wrapper picks by the tensor's device: a CUDA tensor launches the
kernel (and counts it in ``launches``), a CPU tensor runs the plain
version. :func:`reference_bn_relu_train` is the plain version of the whole.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.ops import on_cuda
from surya_tpu_torch.ops.cuda import _build

# kernel launches, counted where each kernel is launched
launches = {"channel_stats": 0, "affine_relu": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _L = _build.P, _build.I, _build.L
_SIGNATURES = {"stem_bn_stats_blocks": [_L, _I, _I],
               "stem_bn_channel_stats": [_P, _P, _P, _L, _I, _I, _P],
               "stem_bn_affine_relu": [_P, _P, _P, _P, _L, _I, _I, _P]}


def channel_stats_plain(x: torch.Tensor):
    """Per-channel (Σx, Σx²) in f32, plain PyTorch."""
    xf = x.float().reshape(-1, x.shape[-1])
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def affine_relu_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """relu(x·a + b) per channel in f32, output in x's dtype."""
    return torch.relu(x.float() * a.float() + b.float()).to(x.dtype)


def _check(x):
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"need a non-empty (..., C) map, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_DTYPES}")
    if on_cuda(x) and not x.is_contiguous():
        raise ValueError("x must be a contiguous channels-last tensor")


def channel_stats(x: torch.Tensor):
    """Per-channel (Σx, Σx²) of a channels-last map (..., C) → two (C,)
    f32 vectors. Deterministic: partial sums are added in a fixed order."""
    _check(x)
    if not on_cuda(x):
        return channel_stats_plain(x)
    c = x.shape[-1]
    n = x.numel() // c
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.load("stem_bn", _SIGNATURES)
    blocks = lib.stem_bn_stats_blocks(n, c, is_bf16)
    partial = torch.empty((blocks, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _build.launch("stem_bn_channel_stats", lib.stem_bn_channel_stats,
                  x.device, _build.ptr(x), _build.ptr(partial),
                  _build.ptr(out), n, c, is_bf16)
    launches["channel_stats"] += 1
    return out[0], out[1]


def affine_relu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """relu(x·a + b) with per-channel (C,) a/b: f32 compute, output in x's
    dtype and shape. Forward only."""
    _check(x)
    c = x.shape[-1]
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)} do not "
                         f"fit C={c}")
    if not on_cuda(x):
        return affine_relu_plain(x, a, b)
    _build.same_device("stem_bn_affine_relu", x.device, a, b)
    af, bf = a.float().contiguous(), b.float().contiguous()
    y = torch.empty_like(x)
    lib = _build.load("stem_bn", _SIGNATURES)
    _build.launch("stem_bn_affine_relu", lib.stem_bn_affine_relu, x.device,
                  _build.ptr(x), _build.ptr(af), _build.ptr(bf),
                  _build.ptr(y), x.numel() // c, c,
                  int(x.dtype == torch.bfloat16))
    launches["affine_relu"] += 1
    return y


def fused_bn_relu_train(x, scale, bias, eps: float = 1e-5):
    """Train-mode BN + ReLU on a channels-last map through the two passes
    → (y, batch_mean, batch_var) with the biased variance, which is what
    flax BN normalises with in train mode; the running-stats update stays
    with the caller. Forward only."""
    n = x.numel() // x.shape[-1]
    sums, sumsq = channel_stats(x)
    mean = sums / n
    var = torch.clamp(sumsq / n - mean * mean, min=0.0)
    a = scale.float() * torch.rsqrt(var + eps)
    b = bias.float() - mean * a
    return affine_relu(x, a, b), mean, var


def reference_bn_relu_train(x, scale, bias, eps: float = 1e-5):
    """Plain PyTorch oracle with the same math (for tests and the A/B)."""
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=dims)
    var = (xf * xf).mean(dim=dims) - mean * mean
    inv = scale.float() * torch.rsqrt(var + eps)
    y = torch.relu(xf * inv + (bias.float() - mean * inv))
    return y.to(x.dtype), mean, var
