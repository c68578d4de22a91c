"""Image resizes that the port's pose and video paths need, without PIL or
cv2, so the card and the CPU run the same code. Both run on the tensors'
device.

- :func:`pil_bilinear_u8` follows Pillow's ``Image.resize(BILINEAR)`` on
  uint8 images (``libImaging/Resample.c``): a triangle filter whose
  support widens with the reduction (antialiased when shrinking),
  coefficients normalised per output pixel and quantised to 22 fractional
  bits, a horizontal pass rounded to uint8, then a vertical pass; an axis
  of equal size is not filtered, and an equal-size image comes back as a
  copy.
- :func:`linear_resize` is OpenCV's ``cv2.resize(INTER_LINEAR)`` on float
  images: bilinear at half-pixel centres, edges clamped, no antialias, the
  source coordinate in float64 as OpenCV's IPP path (its default build)
  takes it; its plain C++ path rounds the coordinate to float32 first
  and differs from this in the fifth decimal on large images.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_PRECISION_BITS = 32 - 8 - 2


def _pil_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter, then
    ``normalize_coeffs_8bpc`` → (first input index (out,), int64 fixed-point
    weights (out, ksize)); weights past each pixel's window are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
             for x in range(xmax)]
        ww = sum(w)
        first[xx] = xmin
        for x, k in enumerate(w):
            k = k / ww if ww != 0.0 else k
            kk[xx, x] = int((-0.5 if k < 0 else 0.5)
                            + k * (1 << _PRECISION_BITS))
    return first, kk


def _pil_pass(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """One separable pass over ``dim`` of a uint8 tensor."""
    in_size = x.shape[dim]
    first, kk = _pil_coeffs(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), in_size - 1)
    idx_t = torch.as_tensor(idx.reshape(-1), device=x.device)
    taps = x.index_select(dim, idx_t).long()
    shape = list(x.shape)
    shape[dim:dim + 1] = [out_size, kk.shape[1]]
    taps = taps.reshape(shape)
    w_shape = [1] * len(shape)
    w_shape[dim:dim + 2] = list(kk.shape)
    w = torch.as_tensor(kk, device=x.device).reshape(w_shape)
    acc = (taps * w).sum(dim + 1) + (1 << (_PRECISION_BITS - 1))
    return (acc >> _PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def pil_bilinear_u8(images: torch.Tensor, size: tuple[int, int]
                    ) -> torch.Tensor:
    """(..., H, W, C) uint8 → (..., h, w, C) uint8, as Pillow's
    ``Image.resize((w, h), Image.BILINEAR)`` computes it."""
    if images.dtype != torch.uint8:
        raise TypeError(f"pil_bilinear_u8 takes uint8 images, got "
                        f"{images.dtype}")
    h, w = size
    out = images.clone()
    if out.shape[-2] != w:
        out = _pil_pass(out, w, out.dim() - 2)
    if out.shape[-3] != h:
        out = _pil_pass(out, h, out.dim() - 3)
    return out


def _cv2_linear_taps(in_size: int, out_size: int):
    """OpenCV's INTER_LINEAR source index and weight per output pixel: the
    centre (dx + 0.5)·scale − 0.5 in float64, floored, its fraction the
    float32 weight; clamped to the first and last pixel at the edges."""
    scale = in_size / out_size
    fx = (np.arange(out_size) + 0.5) * scale - 0.5
    sx = np.floor(fx)
    fx = (fx - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    last = sx >= in_size - 1
    fx[last] = 0.0
    sx[last] = in_size - 1
    return sx, np.minimum(sx + 1, in_size - 1), fx


def _linear_pass(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    i0, i1, fx = _cv2_linear_taps(x.shape[dim], out_size)
    shape = [1] * x.dim()
    shape[dim] = out_size
    a1 = torch.as_tensor(fx, device=x.device).reshape(shape)
    a0 = torch.as_tensor(np.float32(1.0) - fx, device=x.device).reshape(shape)
    take = (lambda i: x.index_select(  # noqa: E731
        dim, torch.as_tensor(i, device=x.device)))
    return take(i0) * a0 + take(i1) * a1


def linear_resize(images: torch.Tensor, size: tuple[int, int]
                  ) -> torch.Tensor:
    """(..., H, W, C) float32 → (..., h, w, C), as ``cv2.resize(img, (w,
    h))`` (INTER_LINEAR) resizes a float image: a horizontal pass, then a
    vertical one, each a two-tap lerp."""
    h, w = size
    out = _linear_pass(images, w, images.dim() - 2)
    return _linear_pass(out, h, images.dim() - 3)
