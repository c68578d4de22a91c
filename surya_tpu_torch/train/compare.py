"""Multi-model comparison, mirroring ``surya_tpu/train/compare.py``:
evaluate several checkpoints on one split and report accuracy, weighted
P/R/F1 and R² per model, with confusion-matrix and comparison plots when
an output directory is given.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
from surya_tpu_torch.core.config import Config
from surya_tpu_torch.core.metrics import r2_score
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.backbones import trunk_channels_last
from surya_tpu_torch.ops import resolve_device
from surya_tpu_torch.train.loop import as_mesh, evaluate
from surya_tpu_torch.train.steps import make_eval_step


def evaluate_checkpoint(cfg: Config, state_dict, data, split: str = "valid",
                        device=None, mesh=None) -> dict:
    """Evaluate one model's weights (the port's state_dict) on a split of
    ``data``, on the card unless ``device="cpu"``. On a ``mesh`` of
    several ranks (JAX's default: every device on 'data') each rank
    evaluates its rows and the sums are all-reduced."""
    device = resolve_device(device)
    mesh = as_mesh(mesh, device)
    model = get_model(cfg.model, image_size=cfg.data.image_size)
    model.load_state_dict(state_dict, strict=True)
    trunk_channels_last(model)   # as in training
    eval_step = make_eval_step(model.to(device), cfg.model.num_classes,
                               cfg.train.label_smoothing)
    tf = getattr(data, "device_transform", None)
    out = evaluate(eval_step, data.eval_batches(split), device,
                   transform=(None if tf is None else
                              (lambda b: tf(split, None, b))), mesh=mesh)
    cm = out["confusion"]
    if cm is None:  # empty split: evaluate() returns zeroed metrics
        out["confusion"] = np.zeros(
            (cfg.model.num_classes, cfg.model.num_classes), np.int32)
        out["r2"] = 0.0
        return out
    # R² over the (true, predicted) pairs, rebuilt exactly from the matrix
    idx = np.indices(cm.shape).reshape(2, -1)
    counts = cm.reshape(-1)
    if counts.sum():
        labels, preds = (torch.from_numpy(np.repeat(i, counts)) for i in idx)
        out["r2"] = float(r2_score(labels, preds))
    return out


def compare_models(entries: list[dict], data, split: str = "valid",
                   out_dir: str | None = None, device=None,
                   mesh=None) -> dict:
    """entries: [{name, cfg, params_path}] → {name: metrics}.

    Writes per-model confusion PNGs and a comparison bar chart when
    ``out_dir`` is given (rank 0 of a mesh)."""
    mesh = as_mesh(mesh, resolve_device(device))
    results = {}
    for e in entries:
        results[e["name"]] = evaluate_checkpoint(
            e["cfg"], load_checkpoint_variables(e["params_path"]), data,
            split, device, mesh)
    if out_dir and mesh.is_main:
        os.makedirs(out_dir, exist_ok=True)
        from surya_tpu_torch.utils.plotting import (
            plot_confusion_matrix,
            plot_model_comparison,
        )

        names = getattr(data, "class_names", None) or [
            str(i) for i in range(
                next(iter(results.values()))["confusion"].shape[0])]
        for name, r in results.items():
            plot_confusion_matrix(
                r["confusion"], names,
                os.path.join(out_dir, f"confusion_{name}.png"),
                title=f"{name} ({split})")
        plot_model_comparison(
            {n: {k: v for k, v in r.items()
                 if k in ("accuracy", "precision", "recall", "f1")}
             for n, r in results.items()},
            os.path.join(out_dir, "comparison.png"))
    return {n: {k: (float(v) if not isinstance(v, np.ndarray) else
                    v.tolist())
                for k, v in r.items() if k != "confusion"}
            for n, r in results.items()}
