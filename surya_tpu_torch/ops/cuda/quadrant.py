"""Fused quadrant block: split → per-quadrant 3×3 conv + bias → ReLU →
VALID 2×2/2 max pool → (q, ph, pw, c) flatten.

Replaces ``surya_tpu/ops/pallas/quadrant.py::_quadrant_kernel`` (entry
``_quadrant_process_impl``), forward without the pre-pool activation.
The kernel is ``csrc/quadrant.cu``; its source note says what bounds it
on the card (arithmetic: ~5.4 GFLOP against ~7.6 MB at B=64) and how the
design answers that. The TPU design's row-shifted taps, iota masks and
0/1 selection matmul work around Mosaic and are not carried over.

Numerics follow the Pallas kernel: f32 accumulation, bias added in f32,
output in the input dtype.

:func:`quadrant_process` picks by the tensor's device: a CUDA tensor
launches the kernel (and counts it in ``launches``), a CPU tensor runs
:func:`quadrant_process_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from surya_tpu_torch.ops import on_cuda
from surya_tpu_torch.ops.cuda import _build
from surya_tpu_torch.ops.quadtree import quadrant_flatten, quadrant_split

launches = 0  # kernel launches, counted where the kernel is launched

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = _build.P, _build.I
_SIGNATURES = {"quadrant_forward": [_P] * 4 + [_I] * 5 + [_P]}


def quadrant_process_plain(fmap: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (f32 accumulation, output in
    fmap's dtype): the CPU path and the kernel's oracle."""
    b = fmap.shape[0]
    q = quadrant_split(fmap).permute(0, 3, 1, 2).float()   # (4B, C, hq, hq)
    w = kernel.to(fmap.dtype).float().permute(3, 2, 0, 1)   # OIHW
    y = F.conv2d(q, w, padding=1) + bias.float()[None, :, None, None]
    y = F.max_pool2d(F.relu(y), 2, 2)                        # floor: VALID
    return quadrant_flatten(y.permute(0, 2, 3, 1), b).to(fmap.dtype)


def _check(fmap, kernel, bias):
    if fmap.dim() != 4 or fmap.shape[1] != fmap.shape[2]:
        raise ValueError(f"need a square NHWC map, got {tuple(fmap.shape)}")
    b, h, _, cin = fmap.shape
    if h % 2 or h < 4 or (h // 4) ** 2 > 1024:
        raise ValueError(f"need even H in [4, 128], got H={h}")
    if kernel.shape[:3] != (3, 3, cin) or bias.shape != kernel.shape[3:]:
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit Cin={cin}")
    if fmap.dtype not in _DTYPES:
        raise TypeError(f"fmap dtype {fmap.dtype} not in {_DTYPES}")


def quadrant_process(fmap: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """(B, H, H, Cin) NHWC map, (3, 3, Cin, Cout) HWIO kernel, (Cout,)
    bias → (B, 4·(H/4)²·Cout) in fmap's dtype."""
    global launches
    _check(fmap, kernel, bias)
    if not on_cuda(fmap):
        return quadrant_process_plain(fmap, kernel, bias)
    if not fmap.is_contiguous():
        raise ValueError("fmap must be a contiguous NHWC tensor")
    b, h, _, cin = fmap.shape
    cout = kernel.shape[3]
    w = kernel.to(fmap.dtype).contiguous()   # no-op for weights already cast
    bf = bias.float().contiguous()
    if fmap.data_ptr() % 16 or w.data_ptr() % 32:
        raise ValueError("fmap must be 16-byte and kernel 32-byte aligned")
    out = torch.empty((b, 4 * (h // 4) ** 2 * cout), dtype=fmap.dtype,
                      device=fmap.device)
    lib = _build.load("quadrant", _SIGNATURES)
    err = lib.quadrant_forward(
        _build.ptr(fmap), _build.ptr(w), _build.ptr(bf), _build.ptr(out),
        b, h, cin, cout, int(fmap.dtype == torch.bfloat16),
        _build.stream_ptr(fmap.device))
    _build.check(err, "quadrant_forward")
    launches += 1
    return out
