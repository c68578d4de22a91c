"""Quadrant split/merge/flatten on NHWC tensors.

Counterpart of ``surya_tpu/ops/quadtree.py``, with the same batch order:
output index ``b*4 + q``, q in raster order (0 top-left, 1 top-right,
2 bottom-left, 3 bottom-right). H and W must be even.
"""

from __future__ import annotations

import torch


def quadrant_split(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B*4, H/2, W/2, C), quadrant-major batch order."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"quadrant_split needs even H,W; got {h}x{w}")
    hh, hw = h // 2, w // 2
    x = x.reshape(b, 2, hh, 2, hw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * 4, hh, hw, c)


def quadrant_merge(x: torch.Tensor, batch: int) -> torch.Tensor:
    """Inverse of :func:`quadrant_split`: (B*4, h, w, C) → (B, 2h, 2w, C)."""
    b4, h, w, c = x.shape
    if b4 != batch * 4:
        raise ValueError(f"expected batch*4={batch * 4}, got {b4}")
    x = x.reshape(batch, 2, 2, h, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(batch, 2 * h, 2 * w, c)


def quadrant_flatten(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*4, h, w, C) → (B, 4*h*w*C), flattened in (q, h, w, c) order."""
    if x.shape[0] != batch * 4:
        raise ValueError(f"expected batch*4={batch * 4}, got {x.shape[0]}")
    return x.reshape(batch, -1)
