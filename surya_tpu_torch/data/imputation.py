"""Per-class feature imputation + standardization, mirroring
``surya_tpu/data/imputation.py``.

Stats are (num_classes, F) tables indexed by the sample's own label: NaN
→ the class mean, then any NaN left → 0; optionally (x − μ_c)/(σ_c +
1e-6). ``impute``/``standardize`` run on the batch's device (the tables
move there once and are kept); ``from_json`` and ``aligned_to`` run on
the host, and ``compute_class_stats`` stays numpy.
"""

from __future__ import annotations

import json

import numpy as np
import torch


class ClassFeatureStats:
    """(num_classes, F) mean/std tables indexed by integer label."""

    def __init__(self, means: np.ndarray, stds: np.ndarray | None,
                 class_names: list[str],
                 feature_names: list[str] | None = None):
        self.means = torch.as_tensor(np.asarray(means, np.float32))
        self.stds = (torch.as_tensor(np.asarray(stds, np.float32))
                     if stds is not None else None)
        self.class_names = list(class_names)
        self.feature_names = feature_names

    @classmethod
    def from_json(cls, means_path: str, stds_path: str | None = None,
                  feature_names: list[str] | None = None
                  ) -> "ClassFeatureStats":
        """Load the prep's JSON artifacts: {class: {feature: val}}."""
        with open(means_path) as f:
            means_raw = json.load(f)
        class_names = sorted(means_raw)
        if feature_names is None:
            from surya_tpu_torch.features import FEATURE_NAMES_47
            feature_names = list(FEATURE_NAMES_47)

        def table(raw):
            out = np.zeros((len(class_names), len(feature_names)),
                           np.float32)
            for ci, cname in enumerate(class_names):
                row = raw.get(cname, {})
                for fi, fname in enumerate(feature_names):
                    out[ci, fi] = float(row.get(fname, 0.0))
            return out

        means = table(means_raw)
        stds = None
        if stds_path:
            with open(stds_path) as f:
                stds = table(json.load(f))
        return cls(means, stds, class_names, feature_names)

    def aligned_to(self, class_names) -> "ClassFeatureStats":
        """Reorder the stat rows to a dataset's class order; raise if the
        dataset has a class the stats do not cover (indexing by label
        would otherwise impute with the wrong class's means)."""
        wanted = list(class_names)
        if wanted == self.class_names:
            return self
        try:
            idx = [self.class_names.index(c) for c in wanted]
        except ValueError:
            missing = sorted(set(wanted) - set(self.class_names))
            raise ValueError(
                f"feature stats cover classes {self.class_names} but "
                f"the dataset has {wanted} (missing {missing}); "
                "regenerate class_feature_means.json")
        return ClassFeatureStats(
            self.means.cpu().numpy()[idx],
            self.stds.cpu().numpy()[idx] if self.stds is not None else None,
            wanted, self.feature_names)

    def _on(self, device: torch.device) -> None:
        if self.means.device != device:
            self.means = self.means.to(device)
            if self.stds is not None:
                self.stds = self.stds.to(device)

    def impute(self, features: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
        """NaN → per-class mean, then any NaN left → 0."""
        self._on(features.device)
        m = self.means[labels.long()]
        return torch.nan_to_num(torch.where(torch.isnan(features), m,
                                            features))

    def standardize(self, features: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
        """(x − μ_c) / (σ_c + 1e-6) after imputation; features with
        σ_c < 1e-6 standardize to 0."""
        if self.stds is None:
            raise ValueError("no stds loaded")
        x = self.impute(features, labels)
        std = self.stds[labels.long()]
        z = (x - self.means[labels.long()]) / (std + 1e-6)
        return torch.where(std < 1e-6, 0.0, z)


def compute_class_stats(features: np.ndarray, labels: np.ndarray,
                        num_classes: int) -> tuple[np.ndarray, np.ndarray]:
    """Train-split per-class NaN-aware mean/std (a prep-time helper)."""
    f = features.shape[-1]
    means = np.zeros((num_classes, f), np.float32)
    stds = np.ones((num_classes, f), np.float32)
    for c in range(num_classes):
        rows = features[labels == c]
        if len(rows) == 0:
            continue
        with np.errstate(all="ignore"):
            m = np.nanmean(rows, axis=0)
            s = np.nanstd(rows, axis=0)
        means[c] = np.nan_to_num(m)
        stds[c] = np.nan_to_num(s)
    return means, stds
