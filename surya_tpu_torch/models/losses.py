"""Losses: cross-entropy (+ label smoothing) and focal loss, mirroring
``surya_tpu/models/losses.py``. Logits (B, C), integer labels (B,); the
math runs in the logits' dtype (f32 from every model of the port)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _soft_targets(logits, labels, label_smoothing: float):
    num_classes = logits.shape[-1]
    one_hot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0:
        one_hot = (one_hot * (1.0 - label_smoothing)
                   + label_smoothing / num_classes)
    return one_hot


def cross_entropy_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                             label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-sample softmax cross-entropy (B,) — for masked eval sums."""
    targets = _soft_targets(logits, labels, label_smoothing)
    return -(targets * F.log_softmax(logits, dim=-1)).sum(dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch."""
    return cross_entropy_per_sample(logits, labels, label_smoothing).mean()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha=None) -> torch.Tensor:
    """FL(p_t) = -alpha_t (1-p_t)^gamma log(p_t), mean-reduced. ``alpha``:
    None skips the weighting, a scalar weighs class 0 with ``1 - alpha`` and
    every other class with ``alpha``, a vector weighs per class."""
    log_probs = F.log_softmax(logits, dim=-1)
    log_pt = log_probs.gather(-1, labels.long()[:, None])[:, 0]
    pt = log_pt.exp()
    loss = -((1.0 - pt) ** gamma) * log_pt
    if alpha is not None:
        alpha = torch.as_tensor(alpha, dtype=logits.dtype,
                                device=logits.device)
        if alpha.dim() == 0:
            alpha_t = torch.where(labels > 0, alpha, 1.0 - alpha)
        else:
            alpha_t = alpha[labels.long()]
        loss = alpha_t * loss
    return loss.mean()
