"""Fused quadrant block: split → per-quadrant 3×3 conv + bias → ReLU →
VALID 2×2/2 max pool → (q, ph, pw, c) flatten.

Replaces ``surya_tpu/ops/pallas/quadrant.py::_quadrant_kernel`` (entry
``_quadrant_process_impl``) in both forms: the inference form, and the
training form that also writes ``act``, the post-ReLU pre-pool map
(B, H, H, Cout) in fmap's dtype, as the backward's residual. The kernel is
``csrc/quadrant.cu``; its source note says what bounds it on the card
(arithmetic: ~5.4 GFLOP against ~7.6 MB at B=64) and how the design
answers that. The TPU design's row-shifted taps, iota masks and 0/1
selection matmul work around Mosaic and are not carried over.

Numerics follow the Pallas kernel: f32 accumulation, bias added in f32,
the pool taken on the f32 values, outputs rounded once to the input dtype.

:func:`quadrant_process` picks by the tensor's device: a CUDA tensor
launches the kernel (and counts it in ``launches``), a CPU tensor runs
:func:`quadrant_process_plain`. Without a gradient it calls the inference
form as the operator ``torch.ops.surya_tpu_torch.quadrant_process``
(a ``torch.library.custom_op``: the kernel for a CUDA tensor, the plain
version for a CPU one, a fake for tracing and a flop formula), which
``torch.export`` keeps as one node of the exported graph. When a gradient
is wanted it goes through
:class:`QuadrantProcess`, whose backward mirrors JAX's ``_quadrant_bwd``:
pool VJP from the saved act, ReLU mask, the two transposed convolutions
(library convolutions, as XLA's in JAX), bias gradient summed in f32. The
forward convolution is never run again.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from surya_tpu_torch.ops import on_cuda
from surya_tpu_torch.ops.cuda import _build
from surya_tpu_torch.ops.quadtree import (
    quadrant_flatten,
    quadrant_merge,
    quadrant_split,
)

launches = 0  # kernel launches, counted where the kernel is launched
training_launches = 0  # of which in the training form (with_act)

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = _build.P, _build.I
_SIGNATURES = {"quadrant_forward": [_P] * 5 + [_I] * 5 + [_P],
               "quadrant_plan": [_I] * 6 + [_P]}


def quadrant_process_plain(fmap: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor, with_act: bool = False):
    """The same function in plain PyTorch (f32 accumulation, outputs in
    fmap's dtype): the CPU path and the kernel's oracle. ``with_act`` also
    returns the post-ReLU pre-pool map (B, H, H, Cout)."""
    b = fmap.shape[0]
    q = quadrant_split(fmap).permute(0, 3, 1, 2).float()   # (4B, C, hq, hq)
    w = kernel.to(fmap.dtype).float().permute(3, 2, 0, 1)   # OIHW
    y = F.relu(F.conv2d(q, w, padding=1) + bias.float()[None, :, None, None])
    out = quadrant_flatten(F.max_pool2d(y, 2, 2).permute(0, 2, 3, 1),  # VALID
                           b).to(fmap.dtype)
    if not with_act:
        return out
    return out, quadrant_merge(y.permute(0, 2, 3, 1), b).to(fmap.dtype)


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


def _forward(fmap, kernel, bias, with_act: bool):
    """Kernel (CUDA tensor) or plain version (CPU tensor) → (out, act);
    act is None without ``with_act``."""
    global launches, training_launches
    if not on_cuda(fmap):
        res = quadrant_process_plain(fmap, kernel, bias, with_act)
        return res if with_act else (res, None)
    if not fmap.is_contiguous():
        raise ValueError("fmap must be a contiguous NHWC tensor")
    b, h, _, cin = fmap.shape
    if with_act and h > 64:
        raise ValueError(f"the training form takes H <= 64, got H={h}")
    cout = kernel.shape[3]
    w = kernel.to(fmap.dtype).contiguous()   # no-op for weights already cast
    bf = bias.float().contiguous()
    if fmap.data_ptr() % 16 or w.data_ptr() % 32:
        raise ValueError("fmap must be 16-byte and kernel 32-byte aligned")
    out = torch.empty((b, 4 * (h // 4) ** 2 * cout), dtype=fmap.dtype,
                      device=fmap.device)
    act = (torch.empty((b, h, h, cout), dtype=fmap.dtype, device=fmap.device)
           if with_act else None)
    lib = _build.load("quadrant", _SIGNATURES)
    err = lib.quadrant_forward(
        _build.ptr(fmap), _build.ptr(w), _build.ptr(bf), _build.ptr(out),
        _build.ptr(act) if with_act else None,
        b, h, cin, cout, int(fmap.dtype == torch.bfloat16),
        _build.stream_ptr(fmap.device))
    _build.check(err, "quadrant_forward")
    launches += 1
    training_launches += int(with_act)
    return out, act



@torch.library.custom_op("surya_tpu_torch::quadrant_process",
                         mutates_args=(), device_types="cuda")
def quadrant_op(fmap: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The inference form as an operator: on the card, the kernel launch
    (counted in ``launches``). ``contiguous`` costs nothing for the NHWC
    map the model hands over, and keeps an exported graph on the kernel
    where a replay's strides differ from the trace's."""
    return _forward(fmap.contiguous(), kernel, bias, with_act=False)[0]


@quadrant_op.register_kernel("cpu")
def _quadrant_op_cpu(fmap, kernel, bias):
    return quadrant_process_plain(fmap, kernel, bias)


@quadrant_op.register_fake
def _quadrant_op_fake(fmap, kernel, bias):
    b, h = fmap.shape[:2]
    return fmap.new_empty((b, 4 * (h // 4) ** 2 * kernel.shape[3]))


@register_flop_formula(torch.ops.surya_tpu_torch.quadrant_process)
def quadrant_flops(fmap_shape, kernel_shape, *args, **kwargs) -> int:
    """2 FLOP per multiply-add of the four quadrants' 3x3 convolutions:
    2·B·4·(H/2)²·9·Cin·Cout."""
    b, h, _, cin = fmap_shape
    return 2 * b * 4 * (h // 2) ** 2 * 9 * cin * kernel_shape[3]

def launch_plan(b: int, h: int, cin: int, cout: int, with_act: bool,
                dtype=torch.bfloat16) -> dict:
    """The wgmma body's launch at these shapes (all 0 where the CUDA-core
    body runs): grid, threads, cluster size, dynamic shared-memory bytes,
    weight-ring stages. Builds the library on first use."""
    lib = _build.load("quadrant", _SIGNATURES)
    out = (ctypes.c_int * 6)()
    lib.quadrant_plan(b, h, cin, cout, int(dtype == torch.bfloat16),
                      int(with_act), out)
    return {"grid": [out[0], out[1]], "threads": out[2], "cluster": out[3],
            "smem_bytes": out[4], "stages": out[5]}


def quadrant_backward(fmap, kernel, bias, act, g, need=(True, True, True)):
    """JAX's ``_quadrant_bwd``: cotangent ``g`` of the flattened output and
    the saved ``act`` → (g_fmap, g_kernel, g_bias), each in its primal's
    dtype, None where ``need`` is False. Both devices run this code."""
    b = fmap.shape[0]
    hp, cout = fmap.shape[1] // 4, kernel.shape[3]
    # channels-first views of the NHWC quadrants, for the library calls
    act_q = quadrant_split(act).permute(0, 3, 1, 2)
    g_pool = g.to(act.dtype).reshape(4 * b, hp, hp, cout).permute(0, 3, 1, 2)
    # pool VJP: an elementwise re-run of the pool, never of the conv; ties
    # go to the first maximum of a window in row-major order
    with torch.enable_grad():
        a = act_q.detach().requires_grad_(True)
        g_act, = torch.autograd.grad(F.max_pool2d(a, 2, 2), a, g_pool)
    # the mask comes after the pool VJP: it also clears whatever the tie
    # rule sent into an all-zero window
    g_pre = torch.where(act_q > 0, g_act, torch.zeros_like(g_act))
    quads = quadrant_split(fmap).permute(0, 3, 1, 2)
    w = kernel.to(fmap.dtype).permute(3, 2, 0, 1)   # OIHW
    g_fmap = g_kernel = g_bias = None
    if need[0]:
        g_quads = torch.nn.grad.conv2d_input(quads.shape, w, g_pre, padding=1)
        g_fmap = quadrant_merge(g_quads.permute(0, 2, 3, 1), b).to(fmap.dtype)
    if need[1]:
        g_w = torch.nn.grad.conv2d_weight(quads, w.shape, g_pre, padding=1)
        g_kernel = g_w.permute(2, 3, 1, 0).to(kernel.dtype)   # HWIO
    if need[2]:
        g_bias = g_pre.float().sum(dim=(0, 2, 3)).to(bias.dtype)
    return g_fmap, g_kernel, g_bias


class QuadrantProcess(torch.autograd.Function):
    """The quadrant block with JAX's custom VJP: the training form's
    forward saves act, :func:`quadrant_backward` consumes it."""

    @staticmethod
    def forward(ctx, fmap, kernel, bias):
        out, act = _forward(fmap, kernel, bias, with_act=True)
        ctx.save_for_backward(fmap, kernel, bias, act)
        return out

    @staticmethod
    def backward(ctx, g):
        return quadrant_backward(*ctx.saved_tensors, g,
                                 ctx.needs_input_grad)


def quadrant_process(fmap: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """(B, H, H, Cin) NHWC map, (3, 3, Cin, Cout) HWIO kernel, (Cout,)
    bias → (B, 4·(H/4)²·Cout) in fmap's dtype. Differentiable: when a
    gradient is wanted the training form runs and saves act; otherwise
    the inference operator :func:`quadrant_op` runs."""
    _check(fmap, kernel, bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (fmap, kernel, bias)):
        return QuadrantProcess.apply(fmap, kernel, bias)
    return quadrant_op(fmap, kernel, bias)


def quadrant_process_with_act(fmap, kernel, bias):
    """The training form's forward alone → (out, act), no autograd."""
    _check(fmap, kernel, bias)
    return _forward(fmap, kernel, bias, with_act=True)
