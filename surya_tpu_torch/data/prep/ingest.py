"""Reference-artifact ingestion, a copy of ``surya_tpu/data/prep/ingest.py``:
read the reference repo's own on-disk outputs and convert them to this
framework's formats, so a user arriving with reference-prepared data needs
zero reference code.

Two artifact families are covered:

1. torch ``.pt`` sequence windows, written by
   ``cnn+lstm/prepare_sequential_dataset.py:98-104`` (==
   ``VIT/prepare_sequential_dataset.py``): per-window dicts
   ``{image_sequence (T,3,H,W) float ImageNet-normalized,
   numerical_sequence (T,47), label int, video_clip str, view_id str}``
   laid out as ``<root>/<split>/<class>/<clip>_view_<v>_seq_<i>.pt``
   plus ``<root>/class_to_idx.json`` (``:124-132``). Converted to this
   repo's ``.npz`` window layout (``data/sequences.py``): uint8 image
   stacks (T,H,W,3 — the baked-in normalization is inverted so the
   on-device normalize of our loader reproduces the same floats to
   quantization precision) + float32 features, same basenames, same
   directory shape, ``class_to_idx.json`` carried over.

2. per-clip ``<clip>_features.csv`` files, written by
   ``sqn process/processing_image_sequence.py:443-447`` under
   ``<processed>/<split>/``. The reference rows carry ``clip_id,
   frame_index, original_image_filename, annotated_image_path`` plus
   the extended landmark feature columns; converted to this repo's
   canonical per-clip CSV (``data/prep/sequence_features.py`` header:
   the 443 ``FEATURE_NAMES_EXTENDED`` columns in fixed order), with
   any column the reference did not emit filled with NaN and any
   column this framework does not model dropped (reported). Output
   feeds ``data/prep/sequence_csv.create_dataset_sequences`` directly.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
from typing import Iterable

import numpy as np

from surya_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from surya_tpu_torch.features.pose_extended import FEATURE_NAMES_EXTENDED

_SPLITS = ("train", "valid", "test")


def _denormalize_to_uint8(img_chw: np.ndarray) -> np.ndarray:
    """Invert torchvision Normalize(ImageNet)+ToTensor → HWC uint8.

    The reference bakes ``(x/255 - mean)/std`` floats into its ``.pt``
    files (``prepare_sequential_dataset.py:29-34``); our loaders store
    uint8 and re-normalize on device, so the inverse is applied here.
    Round-trip error ≤ 1/255 per channel (quantization).
    """
    mean = np.asarray(IMAGENET_MEAN, np.float32).reshape(3, 1, 1)
    std = np.asarray(IMAGENET_STD, np.float32).reshape(3, 1, 1)
    x = img_chw.astype(np.float32) * std + mean
    x = np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
    return np.transpose(x, (1, 2, 0))  # CHW → HWC


def convert_pt_windows(pt_root: str, out_root: str,
                       splits: Iterable[str] = _SPLITS) -> dict:
    """Convert a reference ``.pt`` window tree to the ``.npz`` layout.

    Returns ``{split: n_converted}``. Resumable: existing ``.npz``
    outputs are skipped (the reference's own skip-if-exists semantics,
    ``prepare_sequential_dataset.py:72-74``).
    """
    import torch  # reference artifacts are torch-serialized

    os.makedirs(out_root, exist_ok=True)
    cmap = os.path.join(pt_root, "class_to_idx.json")
    if os.path.exists(cmap):
        shutil.copy2(cmap, os.path.join(out_root, "class_to_idx.json"))

    counts = {}
    for split in splits:
        split_dir = os.path.join(pt_root, split)
        if not os.path.isdir(split_dir):
            continue
        n = 0
        for label in sorted(os.listdir(split_dir)):
            label_dir = os.path.join(split_dir, label)
            if not os.path.isdir(label_dir):
                continue
            out_dir = os.path.join(out_root, split, label.strip())
            for fn in sorted(os.listdir(label_dir)):
                if not fn.endswith(".pt"):
                    continue
                out = os.path.join(out_dir,
                                   os.path.splitext(fn)[0] + ".npz")
                if os.path.exists(out):
                    n += 1
                    continue
                data = torch.load(os.path.join(label_dir, fn),
                                  map_location="cpu", weights_only=True)
                img_seq = np.asarray(data["image_sequence"].numpy())
                num_seq = np.asarray(
                    data["numerical_sequence"].numpy(), np.float32)
                imgs = np.stack([_denormalize_to_uint8(f)
                                 for f in img_seq])
                os.makedirs(out_dir, exist_ok=True)
                np.savez_compressed(
                    out, image_sequence=imgs, numerical_sequence=num_seq,
                    label=int(data["label"]),
                    video_clip=str(data.get("video_clip", "")),
                    view_id=str(data.get("view_id", "")))
                n += 1
        counts[split] = n
    return counts


def convert_clip_features_csvs(processed_root: str, out_root: str,
                               splits: Iterable[str] = _SPLITS) -> dict:
    """Normalize reference per-clip feature CSVs to the canonical
    443-column header.

    Returns ``{split: {clip: n_rows}, "_dropped_columns": [...]}``.
    Columns present in the reference file but not in
    ``FEATURE_NAMES_EXTENDED`` are dropped (the reference's own "575"
    column list is internally inconsistent — see
    ``img process/analyze_flat_image_counts.py:119-137`` analysis in
    ``features/pose_extended.py``); missing columns become NaN.
    """
    report: dict = {"_dropped_columns": set()}
    meta_cols = ["clip_id", "frame_index", "original_image_filename"]
    for split in splits:
        split_dir = os.path.join(processed_root, split)
        if not os.path.isdir(split_dir):
            continue
        out_split = os.path.join(out_root, split)
        os.makedirs(out_split, exist_ok=True)
        report[split] = {}
        for fn in sorted(os.listdir(split_dir)):
            if not fn.endswith("_features.csv"):
                continue
            clip = fn[:-len("_features.csv")]
            with open(os.path.join(split_dir, fn), newline="") as f:
                rows = list(csv.DictReader(f))
            if rows:
                known = set(meta_cols) | set(FEATURE_NAMES_EXTENDED) | {
                    "annotated_image_path"}
                report["_dropped_columns"].update(
                    c for c in rows[0] if c not in known)
            with open(os.path.join(out_split, fn), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(meta_cols + list(FEATURE_NAMES_EXTENDED))
                for i, r in enumerate(rows):
                    def val(c):
                        v = r.get(c, "")
                        return v if v not in ("", None) else "nan"
                    w.writerow([r.get("clip_id", clip),
                                r.get("frame_index", i),
                                r.get("original_image_filename", "")]
                               + [val(c) for c in FEATURE_NAMES_EXTENDED])
            report[split][clip] = len(rows)
    report["_dropped_columns"] = sorted(report["_dropped_columns"])
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m surya_tpu_torch ingest",
        description="Convert reference-repo artifacts to surya_tpu_torch "
                    "formats (.pt windows → .npz; per-clip feature "
                    "CSVs → canonical 443-column CSVs)")
    sub = ap.add_subparsers(dest="kind", required=True)
    p1 = sub.add_parser("pt-windows",
                        help=".pt sequence windows → .npz windows")
    p1.add_argument("pt_root")
    p1.add_argument("out_root")
    p2 = sub.add_parser("clip-csv",
                        help="per-clip <clip>_features.csv → canonical "
                             "443-column CSVs")
    p2.add_argument("processed_root")
    p2.add_argument("out_root")
    args = ap.parse_args(argv)

    if args.kind == "pt-windows":
        counts = convert_pt_windows(args.pt_root, args.out_root)
        print(json.dumps({"converted": counts}))
    else:
        report = convert_clip_features_csvs(args.processed_root,
                                            args.out_root)
        print(json.dumps({"clips": {s: len(v) for s, v in report.items()
                                    if not s.startswith("_")},
                          "dropped_columns":
                              report["_dropped_columns"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
