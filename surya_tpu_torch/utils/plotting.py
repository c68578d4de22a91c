"""Headless training-artifact plots, mirroring
``surya_tpu/utils/plotting.py``: loss/accuracy history with a best-epoch
marker, the confusion-matrix heatmap and per-metric model comparison
bars, saved to files only. matplotlib is imported when a plot is drawn.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_history(history: list[dict], out_path: str,
                 best_epoch: int | None = None) -> str:
    plt = _plt()
    epochs = [h["epoch"] for h in history]
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    axes[0].plot(epochs, [h["train_loss"] for h in history],
                 label="train")
    axes[0].plot(epochs, [h["val_loss"] for h in history], label="val")
    axes[0].set_title("loss")
    axes[1].plot(epochs, [h["train_accuracy"] for h in history],
                 label="train")
    axes[1].plot(epochs, [h["val_accuracy"] for h in history],
                 label="val")
    axes[1].set_title("accuracy")
    for ax in axes:
        if best_epoch is not None and best_epoch >= 0:
            ax.axvline(best_epoch, color="g", ls="--", lw=1,
                       label=f"best epoch {best_epoch}")
        ax.set_xlabel("epoch")
        ax.legend()
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_confusion_matrix(cm: np.ndarray, class_names: list[str],
                          out_path: str, title: str = "Confusion matrix",
                          normalize: bool = False) -> str:
    plt = _plt()
    cm = np.asarray(cm, np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(1.0 + 0.6 * len(class_names),) * 2)
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)))
    ax.set_yticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=45, ha="right", fontsize=8)
    ax.set_yticklabels(class_names, fontsize=8)
    thresh = cm.max() / 2 if cm.size else 0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            v = cm[i, j]
            ax.text(j, i, f"{v:.2f}" if normalize else f"{int(v)}",
                    ha="center", va="center", fontsize=7,
                    color="white" if v > thresh else "black")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title(title)
    fig.colorbar(im, fraction=0.046)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_model_comparison(results: dict[str, dict], out_path: str,
                          metrics=("accuracy", "precision", "recall",
                                   "f1")) -> str:
    """results: {model_name: {metric: value}} → grouped bar chart."""
    plt = _plt()
    names = list(results)
    x = np.arange(len(names))
    width = 0.8 / len(metrics)
    fig, ax = plt.subplots(figsize=(2 + 1.2 * len(names), 4.5))
    for mi, metric in enumerate(metrics):
        vals = [results[n].get(metric, 0.0) for n in names]
        ax.bar(x + mi * width, vals, width, label=metric)
    ax.set_xticks(x + 0.4 - width / 2)
    ax.set_xticklabels(names, rotation=20, ha="right")
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
