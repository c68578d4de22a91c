"""L1: flat still-image dataset prep with 47-feature extraction, ported from
``surya_tpu/data/prep/still_image_dataset.py``.

Parity with ``experiment/1_prepare_still_image_dataset.py:125-350``:
merge label CSVs (dedupe, drop NaN labels), walk the renamed clip dirs,
map frames to original names via the frame-map CSVs, run pose-landmark
detection per frame, compute the 47 engineered features, copy each image
+ save its ``.npy`` side-by-side under
``<out>/<split>/<class>/``, and accumulate train-split per-class
mean/std JSONs (std guarded downstream by +1e-6).

Landmark DETECTION sits behind the ``LandmarkExtractor`` protocol (the
MediaPipe adapter below is a gated import; ``models.pose`` gives the
neural extractor); the feature MATH is ``features.pose47`` on tensors,
over all frames of a clip at once, on the device the caller names (the
card by default).

Usage:
  python -m surya_tpu_torch.data.prep.still_image_dataset RENAMED_ROOT OUT \
      --labels labeled_data.csv labeled_data_test.csv ... [--device cpu]
"""

from __future__ import annotations

import csv
import json
import os
import shutil
from typing import Protocol

import numpy as np
import torch

from surya_tpu_torch.data.prep.frame_renaming import load_frame_map
from surya_tpu_torch.features import FEATURE_NAMES_47, extract_features_47
from surya_tpu_torch.ops import resolve_device

SPLITS = ("train", "test", "valid")


class LandmarkExtractor(Protocol):
    """image path → ((33,4) float32 landmarks, detected: bool)."""

    def __call__(self, image_path: str) -> tuple[np.ndarray, bool]: ...


def mediapipe_extractor(model_complexity: int = 2,
                        min_detection_confidence: float = 0.5
                        ) -> LandmarkExtractor:
    """MediaPipe static-image adapter (``:30``: static mode,
    complexity 2). Gated import: raises with guidance if mediapipe is
    absent."""
    try:
        import cv2
        import mediapipe as mp
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "mediapipe/cv2 are required for landmark extraction; install "
            "them or pass a custom LandmarkExtractor (e.g. precomputed "
            "landmarks)") from e

    pose = mp.solutions.pose.Pose(
        static_image_mode=True, model_complexity=model_complexity,
        enable_segmentation=False,
        min_detection_confidence=min_detection_confidence)

    def process_array(img_bgr):
        """In-memory BGR frame → (landmarks, detected). Used by the
        video loop (infer/video.py) to skip the encode/decode round
        trip a path-based call would need (the reference feeds frames
        straight to POSE.process, ``test_on_video_cnn.py:282-283``)."""
        res = pose.process(cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB))
        if not res.pose_landmarks:
            return np.zeros((33, 4), np.float32), False
        lm = np.asarray([[p.x, p.y, p.z, p.visibility]
                         for p in res.pose_landmarks.landmark],
                        np.float32)
        return lm, True

    def extract(image_path: str):
        img = cv2.imread(image_path)
        if img is None:
            return np.zeros((33, 4), np.float32), False
        return process_array(img)

    extract.process_array = process_array
    return extract


def load_labels(csv_paths: list[str]) -> dict[str, str]:
    """Merged filename → label map (dedupe keeps first; NaN dropped)."""
    out: dict[str, str] = {}
    for path in csv_paths:
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                name = str(row.get("filename", "")).strip()
                label = str(row.get("label", "")).strip()
                if not name or not label or label.lower() == "nan":
                    continue
                out.setdefault(name, label)
    return out


def prepare_still_image_dataset(
        renamed_root: str, out_root: str, label_csvs: list[str],
        extractor: LandmarkExtractor | None = None,
        feature_set: str = "47", device=None) -> dict:
    """Returns per-split image counts. Resumable: existing outputs are
    overwritten (copy) — deterministic re-runs converge.

    ``feature_set='extended'`` saves the 443-feature extended vectors
    instead (parity with ``img process/analyze_flat_image_counts.py``,
    whose flat prep keeps inter-frame velocity state per clip —
    computed here over the whole clip sequence at once). Caveat: the
    dynamics are computed over the LABELED frames only, so a gap in
    label coverage makes the velocity at the frame after the gap span
    the gap (a multi-frame displacement reported as one step) — same
    as the reference, which also only processes labeled frames, but
    worth knowing when labels are sparse.
    """
    if feature_set not in ("47", "extended"):
        raise ValueError("feature_set must be '47' or 'extended'")
    device = resolve_device(device)
    extractor = extractor or mediapipe_extractor()
    labels = load_labels(label_csvs)
    classes = sorted(set(labels.values()))
    os.makedirs(out_root, exist_ok=True)

    counts = {s: 0 for s in SPLITS}
    train_stats: dict[str, list[np.ndarray]] = {}

    for split in SPLITS:
        split_dir = os.path.join(renamed_root, split)
        if not os.path.isdir(split_dir):
            continue
        for clip in sorted(os.listdir(split_dir)):
            clip_dir = os.path.join(split_dir, clip)
            if not os.path.isdir(clip_dir):
                continue
            try:
                frame_map = load_frame_map(clip_dir, clip)
            except FileNotFoundError:
                continue
            image_files = sorted(
                f for f in os.listdir(clip_dir)
                if f.lower().endswith((".jpg", ".png")))

            # Gather the clip's labeled frames, extract landmarks.
            todo = []
            for i, fname in enumerate(image_files):
                original = frame_map.get(fname)
                label = labels.get(original) if original else None
                if label is None:
                    continue
                todo.append((i, fname, label))
            if not todo:
                continue
            lms = np.zeros((len(todo), 33, 4), np.float32)
            detected = np.zeros((len(todo),), bool)
            for j, (_, fname, _) in enumerate(todo):
                lms[j], detected[j] = extractor(
                    os.path.join(clip_dir, fname))

            # Batched feature math: one call per clip.
            lms_t = torch.from_numpy(lms).to(device)
            if feature_set == "47":
                feats = extract_features_47(
                    lms_t, torch.from_numpy(detected).to(device)
                ).cpu().numpy()
            else:
                from PIL import Image

                from surya_tpu_torch.features.pose_extended import (
                    extract_features_extended,
                )
                with Image.open(os.path.join(
                        clip_dir, todo[0][1])) as im:
                    w0, h0 = im.size
                feats = extract_features_extended(
                    lms_t, float(w0), float(h0)).cpu().numpy()
                feats[~detected] = np.nan

            for j, (i, fname, label) in enumerate(todo):
                dest_dir = os.path.join(out_root, split, label)
                os.makedirs(dest_dir, exist_ok=True)
                unique = f"{clip}_frame_{i:05d}_{fname}"
                shutil.copy2(os.path.join(clip_dir, fname),
                             os.path.join(dest_dir, unique))
                np.save(os.path.join(
                    dest_dir, os.path.splitext(unique)[0] + ".npy"),
                    feats[j])
                counts[split] += 1
                if split == "train":
                    train_stats.setdefault(label, []).append(feats[j])

    # Per-class per-feature NaN-aware stats (``:323-349``).
    if feature_set == "47":
        feature_names = FEATURE_NAMES_47
    else:
        from surya_tpu_torch.features.pose_extended import (
            FEATURE_NAMES_EXTENDED,
        )
        feature_names = FEATURE_NAMES_EXTENDED
    nf = len(feature_names)
    means: dict = {}
    stds: dict = {}
    for label in classes:
        rows = np.stack(train_stats[label]) if label in train_stats \
            else np.zeros((0, nf), np.float32)
        with np.errstate(all="ignore"):
            m = np.nanmean(rows, axis=0) if len(rows) else np.zeros(nf)
            s = np.nanstd(rows, axis=0) if len(rows) else np.ones(nf)
        means[label] = {n: float(np.nan_to_num(v))
                        for n, v in zip(feature_names, m)}
        stds[label] = {n: float(np.nan_to_num(v))
                       for n, v in zip(feature_names, s)}
    with open(os.path.join(out_root, "class_feature_means.json"),
              "w") as f:
        json.dump(means, f, indent=2)
    with open(os.path.join(out_root, "class_feature_stds.json"),
              "w") as f:
        json.dump(stds, f, indent=2)
    return counts


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("renamed_root")
    ap.add_argument("out_root")
    ap.add_argument("--labels", nargs="+", required=True)
    ap.add_argument("--pose-ckpt", default=None,
                    help="msgpack checkpoint of the landmark net "
                         "(models/pose): replaces MediaPipe")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args()
    ext = None
    if args.pose_ckpt:
        from surya_tpu_torch.models.pose import load_pose_extractor

        ext = load_pose_extractor(args.pose_ckpt, device=args.device)
    print(prepare_still_image_dataset(args.renamed_root, args.out_root,
                                      args.labels, extractor=ext,
                                      device=args.device))
