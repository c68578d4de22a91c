"""Classification metrics on tensors + structured JSONL metric logging,
mirroring ``surya_tpu/core/metrics.py``.

The metrics run on whatever device their tensors are on; ``MetricsLogger``
writes one JSON object per record and optionally mirrors scalars to
TensorBoard (a gated tensorboardX import, as in JAX).
"""

from __future__ import annotations

import json
import os
import time
from typing import IO

import numpy as np
import torch


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(B,), (B,) int → (C, C) int32 counts; rows = true class, cols =
    predicted. Negative entries (the -1 eval-padding sentinel) are dropped."""
    labels, preds = labels.long(), preds.long()
    valid = (labels >= 0) & (preds >= 0)
    flat = (torch.where(valid, labels, 0) * num_classes
            + torch.where(valid, preds, 0))
    cm = torch.zeros(num_classes * num_classes, dtype=torch.int64,
                     device=labels.device)
    cm.index_add_(0, flat, valid.long())
    return cm.reshape(num_classes, num_classes).int()


def accuracy(labels: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    return (labels == preds).float().mean()


def precision_recall_f1(cm, average: str = "weighted"):
    """Per-class or averaged precision/recall/F1 from a confusion matrix,
    sklearn's ``precision_recall_fscore_support`` with zero_division=0."""
    cm = torch.as_tensor(cm).float()
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)           # true counts per class
    pred_count = cm.sum(dim=0)        # predicted counts per class
    precision = torch.where(pred_count > 0,
                            tp / pred_count.clamp(min=1), 0.0)
    recall = torch.where(support > 0, tp / support.clamp(min=1), 0.0)
    denom = precision + recall
    f1 = torch.where(denom > 0,
                     2 * precision * recall / denom.clamp(min=1e-12), 0.0)
    if average == "none":
        return precision, recall, f1
    if average == "macro":
        return precision.mean(), recall.mean(), f1.mean()
    if average == "weighted":
        w = support / support.sum().clamp(min=1)
        return (precision * w).sum(), (recall * w).sum(), (f1 * w).sum()
    raise ValueError(f"unknown average {average!r}")


def r2_score(labels: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """R² on class indices (constant labels: 1.0 for a perfect fit, else
    0.0, as sklearn)."""
    labels, preds = labels.float(), preds.float()
    ss_res = ((labels - preds) ** 2).sum()
    ss_tot = ((labels - labels.mean()) ** 2).sum()
    return torch.where(ss_tot > 0, 1.0 - ss_res / ss_tot.clamp(min=1e-12),
                       torch.where(ss_res > 0, 0.0, 1.0))


class MetricsLogger:
    """Append-only JSONL metric stream (one dict per record).

    ``tensorboard_dir`` also mirrors scalar fields as TensorBoard
    summaries: epoch records under ``train/``, ``val/`` etc. with the
    epoch as global step, mid-epoch ``step`` records under ``step/``.
    Without tensorboardX the option is ignored with a warning.
    """

    def __init__(self, path: str | None = None, echo: bool = True,
                 tensorboard_dir: str | None = None):
        self.path = path
        self.echo = echo
        self._fh: IO | None = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._tb = None
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                print("[metrics] tensorboardX not available; "
                      "--tensorboard ignored", flush=True)

    def log(self, record: dict) -> None:
        record = {"ts": round(time.time(), 3), **_to_py(record)}
        line = json.dumps(record)
        if self._fh:
            self._fh.write(line + "\n")
        if self._tb is not None:
            self._log_tb(record)
        if self.echo:
            kv = " ".join(f"{k}={_fmt(v)}" for k, v in record.items()
                          if k != "ts")
            print(kv, flush=True)

    def _log_tb(self, record: dict) -> None:
        is_step = "step" in record and "epoch" in record
        step = int(record.get("step", record.get("epoch", 0)))
        for k, v in record.items():
            if k in ("ts", "step", "epoch", "event") or not isinstance(
                    v, (int, float)):
                continue
            if is_step:
                tag = f"step/{k}"
            elif "_" in k and k.split("_", 1)[0] in ("train", "val",
                                                     "test"):
                tag = k.replace("_", "/", 1)
            else:
                tag = k
            self._tb.add_scalar(tag, float(v), step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _to_py(tree):
    if isinstance(tree, dict):
        return {k: _to_py(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_py(v) for v in tree]
    if torch.is_tensor(tree):
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        if tree.ndim == 0:
            return float(tree)
        return tree.tolist()
    if isinstance(tree, (np.floating, np.integer)):
        return float(tree)
    return tree


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4f}"
    return v
