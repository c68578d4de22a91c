"""Fused fusion-classifier head, inference form:
``relu(x @ w1.T + b1) @ w2.T + b2`` → f32 logits.

Replaces ``surya_tpu/ops/pallas/fusion_head.py::_fusion_head_kernel``
(entry ``_fusion_head_impl``) at rate 0 without the h output. The kernel
is ``csrc/fusion_head.cu``; its source note says what bounds it on the
card (memory: W1 is 28.9 MB in bf16 at the flagship) and how the design
answers that. The TPU kernel holds all of W1 in VMEM per batch block;
shared memory cannot, so the CUDA grid runs over hidden tiles and sums
f32 partial logits in a second, fixed-order launch.

Weights are in ``nn.Linear`` layout: w1 (H, D), w2 (C, H). Numerics
follow the Pallas kernel: f32 accumulation, b1 added in f32, h rounded to
the compute dtype before the second product, f32 logits.

:func:`fusion_head` picks by the tensor's device: a CUDA tensor launches
the kernel (and counts it in ``launches``), a CPU tensor runs
:func:`fusion_head_plain`. Dropout (rate > 0), the h output and the
backward come with the training slice.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.ops import on_cuda
from surya_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches, counted where the kernel is launched

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = _build.P, _build.I
_SIGNATURES = {"fusion_head_n_tiles": [_I],
               "fusion_head_forward": [_P] * 7 + [_I] * 5 + [_P]}


def fusion_head_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The same function in plain PyTorch, with the same rounding points:
    the CPU path and the kernel's oracle."""
    h = torch.addmm(b1.float(), x.float(), w1.to(x.dtype).float().t())
    h = torch.relu(h).to(x.dtype).float()
    return torch.addmm(b2.float(), h, w2.to(x.dtype).float().t())


def _check(x, w1, b1, w2, b2):
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("x, w1, w2 must be 2-D")
    (_, d), (h, d1), (c, h2) = x.shape, w1.shape, w2.shape
    if d1 != d or h2 != h or b1.shape != (h,) or b2.shape != (c,):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_DTYPES}")


def fusion_head(x, w1, b1, w2, b2, *, rate: float = 0.0) -> torch.Tensor:
    """(B, D) x, (H, D) w1, (H,) b1, (C, H) w2, (C,) b2 → (B, C) f32."""
    global launches
    _check(x, w1, b1, w2, b2)
    if rate > 0.0:
        raise NotImplementedError(
            "in-kernel dropout (rate > 0) comes with the training slice; "
            "serving runs the head at rate 0")
    if not on_cuda(x):
        return fusion_head_plain(x, w1, b1, w2, b2)
    b, d = x.shape
    hdim, c = w1.shape[0], w2.shape[0]
    w1c = w1.to(x.dtype).contiguous()   # no-op for weights already cast
    w2c = w2.to(x.dtype).contiguous()
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dtype == torch.bfloat16 and (
            d % 8 or x.data_ptr() % 16 or w1c.data_ptr() % 16):
        raise ValueError("the bf16 head kernel needs D % 8 == 0 and "
                         "16-byte aligned x and w1")
    lib = _build.load("fusion_head", _SIGNATURES)
    partial = torch.empty((lib.fusion_head_n_tiles(hdim), b, c),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    err = lib.fusion_head_forward(
        _build.ptr(x), _build.ptr(w1c), _build.ptr(b1f), _build.ptr(w2c),
        _build.ptr(b2f), _build.ptr(partial), _build.ptr(out),
        b, d, hdim, c, int(x.dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(err, "fusion_head_forward")
    launches += 1
    return out
