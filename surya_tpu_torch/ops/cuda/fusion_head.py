"""Fused fusion-classifier head:
``dropout(relu(x @ w1.T + b1)) @ w2.T + b2`` → f32 logits.

Replaces ``surya_tpu/ops/pallas/fusion_head.py::_fusion_head_kernel``
(entry ``_fusion_head_impl``) in both forms: the inference form (rate 0,
the hidden activation never leaves the chip) and the training form with
in-kernel dropout and the post-dropout ``h`` written out as the backward's
residual. The kernel is ``csrc/fusion_head.cu``; its source note says what
bounds it on the card (memory: W1 is 28.9 MB in bf16 at the flagship) and
how the design answers that. The TPU kernel holds all of W1 in VMEM per
batch block; shared memory cannot, so the bf16 body (TMA ring, wgmma,
K split over a thread-block cluster) runs over 128-unit hidden tiles and
sums f32 partial logits in a second, fixed-order launch.

Weights are in ``nn.Linear`` layout: w1 (H, D), w2 (C, H). Numerics
follow the Pallas kernel: f32 accumulation, b1 added in f32, dropout in
f32, h rounded to the compute dtype before the second product, f32 logits.

Dropout keeps a unit iff its 32 random bits are at least
:func:`dropout_threshold` ``(rate)`` and scales kept units by
``1/(1-rate)``. The bits are Philox4x32-10 keyed by a 64-bit seed with the
counter (row, unit, 0, 0): a pure function of (seed, row, unit), written
once in the kernel and once here (:func:`philox_bits`), so a CPU tensor
gets the very mask the card draws. ``row`` is the row of the global batch:
a data-parallel rank passes its first row as ``row_offset``, so the ranks'
masks are the rows of the single-device mask. The TPU's hardware generator gives
other bits of the same law. ``seed`` is a Python int or an int64 tensor of
one element on x's device; the kernel reads it from device memory, so the
host never waits for it.

:func:`fusion_head` picks by the tensor's device: a CUDA tensor launches
the kernel (and counts it in ``launches``), a CPU tensor runs
:func:`fusion_head_plain`. Without a gradient and at rate 0 it calls the
inference form as the operator ``torch.ops.surya_tpu_torch.fusion_head``
(a ``torch.library.custom_op``: the kernel for a CUDA tensor, the plain
version for a CPU one, a fake for tracing and a flop formula), which
``torch.export`` keeps as one node of the exported graph. When a gradient
is wanted it goes through
:class:`FusionHead`, whose backward mirrors JAX's ``_bwd``: three matrix
products with the single gate ``h > 0`` times ``1/(1-rate)`` (library
products, as XLA's in JAX).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from surya_tpu_torch.ops import on_cuda
from surya_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches, counted where the kernel is launched
training_launches = 0  # of which in the training form (with_h)

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = _build.P, _build.I
_SIGNATURES = {"fusion_head_n_tiles": [_I] * 4,
               "fusion_head_plan": [_I] * 4 + [_P],
               "fusion_head_forward": ([_P] * 9 + [_I] * 5
                                       + [_build.U, _build.F, _I, _P])}
_M32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """uint32 threshold t: keep iff bits >= t, so P(drop) = rate."""
    return min(int(round(rate * 2 ** 32)), 2 ** 32 - 1)


def _philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 values: ``counter``
    four tensors of one shape, ``key`` two → the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        p0, p1 = c0 * 0xD2511F53, c2 * 0xCD9E8D57   # wraps mod 2^64: bits kept
        c0, c1, c2, c3 = (((p1 >> 32) & _M32) ^ c1 ^ k0, p1 & _M32,
                          ((p0 >> 32) & _M32) ^ c3 ^ k1, p0 & _M32)
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def philox_bits(seed, rows: int, units: int, device=None,
                row_offset: int = 0) -> torch.Tensor:
    """(rows, units) int64 tensor of the uint32 bits the kernel draws for
    ``seed``: first word of Philox4x32-10, key (seed low, seed high),
    counter (row_offset + row, unit, 0, 0)."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(())
    device = seed.device
    row = torch.arange(row_offset, row_offset + rows, dtype=torch.int64,
                       device=device)[:, None]
    unit = torch.arange(units, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((rows, units), dtype=torch.int64, device=device)
    return _philox4x32((row + zero, unit + zero, zero, zero),
                       (seed & _M32, (seed >> 32) & _M32))[0]


def fusion_head_plain(x, w1, b1, w2, b2, rate: float = 0.0, keep=None,
                      generator=None, with_h: bool = False):
    """The same function in plain PyTorch, with the same rounding points:
    the CPU path and the kernel's oracle. With ``rate > 0`` the kept units
    are ``keep`` (a (B, H) bool mask) or, without one, drawn from
    ``generator`` (the same law as the kernel's, another stream).
    ``with_h`` also returns the post-dropout h in x's dtype."""
    h = torch.addmm(b1.float(), x.float(), w1.to(x.dtype).float().t())
    h = torch.relu(h)
    if rate > 0.0:
        if keep is None:
            if generator is None:
                raise ValueError("rate > 0 needs a keep mask or a generator")
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) >= rate
        h = torch.where(keep, h * (1.0 / (1.0 - rate)), torch.zeros_like(h))
    h = h.to(x.dtype)
    out = torch.addmm(b2.float(), h.float(), w2.to(x.dtype).float().t())
    return (out, h) if with_h else out


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


def _forward(x, w1, b1, w2, b2, rate: float, seed, with_h: bool,
             row_offset: int = 0):
    """Kernel (CUDA tensor) or plain version (CPU tensor) → (logits, h);
    h is None without ``with_h``. ``row_offset``: the global row of x's
    first row, for the dropout bits."""
    global launches, training_launches
    b, d = x.shape
    hdim, c = w1.shape[0], w2.shape[0]
    if not on_cuda(x):
        keep = None
        if rate > 0.0:
            keep = philox_bits(seed, b, hdim, x.device,
                               row_offset) >= dropout_threshold(rate)
        res = fusion_head_plain(x, w1, b1, w2, b2, rate, keep, with_h=with_h)
        return res if with_h else (res, None)
    _build.same_device("fusion_head_forward", x.device, w1, b1, w2, b2)
    w1c = w1.to(x.dtype).contiguous()   # no-op for weights already cast
    w2c = w2.to(x.dtype).contiguous()
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dtype == torch.bfloat16 and (
            d % 8 or x.data_ptr() % 16 or w1c.data_ptr() % 16):
        raise ValueError("the bf16 head kernel needs D % 8 == 0 and "
                         "16-byte aligned x and w1")
    seed_t = None
    if rate > 0.0:
        seed_t = torch.as_tensor(seed, dtype=torch.int64,
                                 device=x.device).reshape(1)
    lib = _build.load("fusion_head", _SIGNATURES)
    is_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):   # the plan asks the launch's card
        tiles = lib.fusion_head_n_tiles(b, d, hdim, is_bf16)
    partial = torch.empty((tiles, b, c), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    h = (torch.empty((b, hdim), dtype=x.dtype, device=x.device)
         if with_h else None)
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    _build.launch(
        "fusion_head_forward", lib.fusion_head_forward, x.device,
        _build.ptr(x), _build.ptr(w1c), _build.ptr(b1f), _build.ptr(w2c),
        _build.ptr(b2f), _build.ptr(partial), _build.ptr(out),
        _build.ptr(h) if with_h else None,
        _build.ptr(seed_t) if rate > 0.0 else None,
        b, d, hdim, c, is_bf16,
        dropout_threshold(rate) if rate > 0.0 else 0,
        1.0 / (1.0 - rate) if rate > 0.0 else 1.0, int(row_offset))
    launches += 1
    training_launches += int(with_h)
    return out, h



@torch.library.custom_op("surya_tpu_torch::fusion_head", mutates_args=(),
                         device_types="cuda")
def fusion_head_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The inference form (rate 0) as an operator: on the card, the kernel
    launch (counted in ``launches``). ``contiguous`` costs nothing for the
    activations the model hands over, and keeps an exported graph on the
    kernel where a replay's strides differ from the trace's."""
    return _forward(x.contiguous(), w1, b1, w2, b2, 0.0, None,
                    with_h=False)[0]


@fusion_head_op.register_kernel("cpu")
def _fusion_head_op_cpu(x, w1, b1, w2, b2):
    return fusion_head_plain(x, w1, b1, w2, b2)


@fusion_head_op.register_fake
def _fusion_head_op_fake(x, w1, b1, w2, b2):
    return x.new_empty((x.shape[0], w2.shape[0]), dtype=torch.float32)


@register_flop_formula(torch.ops.surya_tpu_torch.fusion_head)
def fusion_head_flops(x_shape, w1_shape, b1_shape, w2_shape, *args,
                      **kwargs) -> int:
    """2 FLOP per multiply-add of the two products: 2·B·(D·H + H·C)."""
    (b, d), hdim, c = x_shape, w1_shape[0], w2_shape[0]
    return 2 * b * (d * hdim + hdim * c)

def launch_plan(b: int, d: int, h: int, dtype=torch.bfloat16) -> dict:
    """The bf16 body's launch at these shapes (all 0 for f32, which runs
    the CUDA-core body): grid, threads, cluster size, dynamic shared-memory
    bytes, ring stages. Builds the library on first use."""
    lib = _build.load("fusion_head", _SIGNATURES)
    out = (ctypes.c_int * 6)()
    lib.fusion_head_plan(b, d, h, int(dtype == torch.bfloat16), out)
    return {"grid": [out[0], out[1]], "threads": out[2], "cluster": out[3],
            "smem_bytes": out[4], "stages": out[5]}


class FusionHead(torch.autograd.Function):
    """The fused head with JAX's custom VJP (``_bwd``): ``h > 0`` iff the
    pre-activation was positive and the unit was kept, so that one gate
    times ``1/(1-rate)`` is the whole ReLU + dropout derivative."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, rate, seed, row_offset):
        out, h = _forward(x, w1, b1, w2, b2, rate, seed, with_h=True,
                          row_offset=row_offset)
        ctx.save_for_backward(x, w1, w2, h)
        ctx.scale = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
        ctx.bias_dtypes = (b1.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, h = ctx.saved_tensors
        need = ctx.needs_input_grad
        g16 = g.to(x.dtype)
        g_x = g_w1 = g_b1 = g_w2 = g_b2 = None
        # second layer; the weight gradients accumulate in f32
        if need[3]:
            g_w2 = (g16.float().t() @ h.float()).to(w2.dtype)
        if need[4]:
            g_b2 = g.sum(dim=0).to(ctx.bias_dtypes[1])
        if need[0] or need[1] or need[2]:
            g_h = g16 @ w2.to(x.dtype)
            g_pre = torch.where(h > 0, g_h * ctx.scale, torch.zeros_like(g_h))
            if need[1]:
                g_w1 = (g_pre.float().t() @ x.float()).to(w1.dtype)
            if need[2]:
                g_b1 = g_pre.float().sum(dim=0).to(ctx.bias_dtypes[0])
            if need[0]:
                g_x = (g_pre @ w1.to(x.dtype)).to(x.dtype)
        return g_x, g_w1, g_b1, g_w2, g_b2, None, None, None


def fusion_head(x, w1, b1, w2, b2, *, rate: float = 0.0,
                seed=None, row_offset: int = 0) -> torch.Tensor:
    """(B, D) x, (H, D) w1, (H,) b1, (C, H) w2, (C,) b2 → (B, C) f32.
    ``rate > 0`` needs ``seed``; ``row_offset`` is the global row of x's
    first row (a data-parallel rank's). Differentiable: when a gradient
    is wanted the training form runs and saves h; otherwise, at rate 0,
    the inference operator :func:`fusion_head_op` runs."""
    _check(x, w1, b1, w2, b2)
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("fusion_head: rate > 0 requires a seed")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return FusionHead.apply(x, w1, b1, w2, b2, rate, seed, row_offset)
    if rate == 0.0:
        return fusion_head_op(x, w1, b1, w2, b2)
    return _forward(x, w1, b1, w2, b2, rate, seed, with_h=False,
                    row_offset=row_offset)[0]


def fusion_head_with_h(x, w1, b1, w2, b2, *, rate: float = 0.0, seed=None,
                       row_offset: int = 0):
    """The training form's forward alone → (logits, h), no autograd."""
    _check(x, w1, b1, w2, b2)
    if rate > 0.0 and seed is None:
        raise ValueError("fusion_head: rate > 0 requires a seed")
    return _forward(x, w1, b1, w2, b2, float(rate), seed, with_h=True,
                    row_offset=row_offset)
