"""L0: CSV-driven sequence dataset builder (the early 10-frame pipeline), a
copy of ``surya_tpu/data/prep/sequence_csv.py``.

Parity with ``sqn process/create_sequential_dataset.py:31-217``: joins
per-clip feature CSVs (from the 575-feature extraction stage) to labels
through the frame-map CSVs, drops unlabeled/NaN frames, slides a window
of SEQUENCE_LENGTH (10) with stride 1 requiring ONE consistent label
across the window, and writes
``<out>/<split>/<class>/sequence_%05d/{features.npy, images/}`` plus a
``dataset_metadata.json`` listing every sequence (video id, clip, frame
range, path).

``organize_by_video`` reproduces ``sqn process/Data_organiser.py:
151-171``'s video-ID-level re-splitting: clips from the same source
video never straddle train/val/test (prevents frame-level leakage).
"""

from __future__ import annotations

import csv
import json
import os
import shutil

import numpy as np

from surya_tpu_torch.data.prep.frame_renaming import extract_video_id

SEQUENCE_LENGTH = 10

_NON_FEATURE_COLS = {"clip_id", "frame_index", "original_image_filename",
                     "long_original_filename", "label_string", "label",
                     "annotated_image_path"}


def _read_csv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def create_dataset_sequences(processed_root: str, renamed_root: str,
                             label_csvs: list[str], out_root: str,
                             seq_len: int = SEQUENCE_LENGTH) -> dict:
    """Returns sequence counts per split."""
    from surya_tpu_torch.data.prep.still_image_dataset import load_labels

    labels = load_labels(label_csvs)
    classes = sorted(set(labels.values()))
    class_to_idx = {c: i for i, c in enumerate(classes)}

    counters = {"train": 0, "valid": 0, "test": 0}
    metadata = []
    for split in ("train", "valid", "test"):
        split_proc = os.path.join(processed_root, split)
        split_renamed = os.path.join(renamed_root, split)
        if not os.path.isdir(split_proc):
            continue
        for entry in sorted(os.listdir(split_proc)):
            if not entry.endswith("_annotated_images"):
                continue
            clip = entry[:-len("_annotated_images")]
            img_dir = os.path.join(split_proc, entry)
            feat_csv = os.path.join(split_proc, f"{clip}_features.csv")
            map_csv = os.path.join(split_renamed, clip,
                                   f"{clip}_frame_map.csv")
            if not (os.path.exists(feat_csv) and os.path.exists(map_csv)):
                continue

            from surya_tpu_torch.data.prep.frame_renaming import load_frame_map

            frame_map = load_frame_map(os.path.dirname(map_csv), clip)
            rows = []
            for r in _read_csv(feat_csv):
                original = frame_map.get(r["original_image_filename"])
                label = labels.get(original) if original else None
                if label is None:
                    continue
                r["_label"] = label
                rows.append(r)
            if not rows:
                continue
            rows.sort(key=lambda r: int(r["frame_index"]))
            video_id = extract_video_id(
                frame_map[rows[0]["original_image_filename"]])
            feat_cols = [c for c in rows[0]
                         if c not in _NON_FEATURE_COLS
                         and not c.startswith("_")]

            for i in range(0, len(rows) - seq_len + 1):
                window = rows[i:i + seq_len]
                win_labels = {r["_label"] for r in window}
                if len(win_labels) != 1:   # consistent-label requirement
                    continue
                label = window[0]["_label"]
                seq_id = f"sequence_{counters[split]:05d}"
                seq_dir = os.path.join(out_root, split, label, seq_id)
                os.makedirs(os.path.join(seq_dir, "images"),
                            exist_ok=True)
                feats = np.asarray(
                    [[float(r[c]) if r[c] not in ("", None) else np.nan
                      for c in feat_cols] for r in window], np.float32)
                np.save(os.path.join(seq_dir, "features.npy"), feats)
                for r in window:
                    stem = os.path.splitext(
                        r["original_image_filename"])[0]
                    src = os.path.join(img_dir, f"{stem}_annotated.jpg")
                    if os.path.exists(src):
                        shutil.copy(src, os.path.join(
                            seq_dir, "images",
                            r["original_image_filename"]))
                metadata.append({
                    "final_split": split,
                    "class_label_string": label,
                    "class_label_int": class_to_idx[label],
                    "sequence_id_in_split": seq_id,
                    "source_video_id": video_id,
                    "source_clip_name": clip,
                    "start_frame_index": i,
                    "end_frame_index": i + seq_len - 1,
                    "path": os.path.relpath(seq_dir, out_root)})
                counters[split] += 1

    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, "dataset_metadata.json"), "w") as f:
        json.dump(metadata, f, indent=4)
    return counters


def organize_by_video(clip_video_ids: dict[str, str], seed: int = 42,
                      ratios=(0.7, 0.15, 0.15)) -> dict[str, str]:
    """clip → split assignment with video-level grouping: all clips of
    one source video land in the same split (Data_organiser.py:151-171
    semantics, sklearn train_test_split replaced by a seeded shuffle)."""
    videos = sorted(set(clip_video_ids.values()))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(videos))
    n = len(videos)
    n_train = max(int(round(ratios[0] * n)), 1)
    n_valid = max(int(round(ratios[1] * n)), 1) if n > 2 else 0
    split_of_video = {}
    for rank, vi in enumerate(order):
        if rank < n_train:
            s = "train"
        elif rank < n_train + n_valid:
            s = "valid"
        else:
            s = "test"
        split_of_video[videos[vi]] = s
    return {clip: split_of_video[vid]
            for clip, vid in clip_video_ids.items()}
