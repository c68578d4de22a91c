"""Per-clip extended-feature extraction → ``<clip>_features.csv``, ported
from ``surya_tpu/data/prep/sequence_features.py``.

Parity with ``sqn process/processing_image_sequence.py:322-452``: for
every renamed clip, run landmark detection on each frame (streaming
history for the dynamics features), compute the extended feature set
(``features.pose_extended`` on tensors, one call per clip, on the device
the caller names: the card by default), and write
``<out>/<split>/<clip>_features.csv`` with columns
``clip_id, frame_index, original_image_filename, <443 features>``,
plus optional annotated skeleton frames into
``<out>/<split>/<clip>_annotated_images/`` (cv2-gated — parity with
``draw_enhanced_skeleton``, ``:250-318``).

Output feeds ``surya_tpu_torch.data.prep.sequence_csv.create_dataset_sequences``.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from surya_tpu_torch.data.prep.frame_renaming import IMG_EXTS
from surya_tpu_torch.features.pose_extended import (
    FEATURE_NAMES_EXTENDED,
    extract_features_extended,
)
from surya_tpu_torch.ops import resolve_device

# MediaPipe POSE_CONNECTIONS subset for the annotated skeleton.
_CONNECTIONS = ((11, 12), (11, 13), (13, 15), (12, 14), (14, 16),
                (11, 23), (12, 24), (23, 24), (23, 25), (25, 27),
                (24, 26), (26, 28))


def _annotate(img, lm, min_vis=0.5):
    import cv2

    h, w = img.shape[:2]
    pts = [(int(x * w), int(y * h)) if v > min_vis else None
           for x, y, _, v in lm]
    for a, b in _CONNECTIONS:
        if pts[a] and pts[b]:
            cv2.line(img, pts[a], pts[b], (0, 255, 0), 2)
    for p in pts:
        if p:
            cv2.circle(img, p, 3, (0, 0, 255), -1)
    return img


def process_image_sequences(renamed_root: str, out_root: str,
                            extractor=None, annotate: bool = False,
                            image_size: tuple[int, int] | None = None,
                            splits=("train", "valid", "test"),
                            device=None) -> dict:
    """Returns {split: {clip: n_frames}}."""
    if extractor is None:
        from surya_tpu_torch.data.prep.still_image_dataset import (
            mediapipe_extractor,
        )
        extractor = mediapipe_extractor()

    device = resolve_device(device)
    report: dict = {}
    for split in splits:
        split_dir = os.path.join(renamed_root, split)
        if not os.path.isdir(split_dir):
            continue
        out_split = os.path.join(out_root, split)
        os.makedirs(out_split, exist_ok=True)
        report[split] = {}
        for clip in sorted(os.listdir(split_dir)):
            clip_dir = os.path.join(split_dir, clip)
            if not os.path.isdir(clip_dir):
                continue
            if not os.path.exists(os.path.join(
                    clip_dir, f"{clip}_frame_map.csv")):
                continue  # only renamed clips have frame maps
            frames = sorted(f for f in os.listdir(clip_dir)
                            if f.lower().endswith(IMG_EXTS))
            if not frames:
                continue

            lms = np.zeros((len(frames), 33, 4), np.float32)
            det = np.zeros((len(frames),), bool)
            # per-frame sizes: the reference reads h, w from every
            # frame (processing_image_sequence.py:386) — mixed-size
            # clips must not inherit the first frame's dims
            ws = np.empty((len(frames),), np.float32)
            hs = np.empty((len(frames),), np.float32)
            for i, fname in enumerate(frames):
                path = os.path.join(clip_dir, fname)
                lms[i], det[i] = extractor(path)
                if image_size is not None:
                    ws[i], hs[i] = image_size
                else:
                    from PIL import Image

                    with Image.open(path) as im:
                        ws[i], hs[i] = im.size

            feats = extract_features_extended(
                torch.from_numpy(lms).to(device), torch.from_numpy(ws),
                torch.from_numpy(hs)).cpu().numpy()
            # no-pose frames: all features NaN, like the reference's
            # all-NaN row (processing_image_sequence.py:419-431) — zero
            # landmarks are NOT valid measurements
            feats[~det] = np.nan

            csv_path = os.path.join(out_split, f"{clip}_features.csv")
            with open(csv_path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["clip_id", "frame_index",
                                 "original_image_filename"]
                                + list(FEATURE_NAMES_EXTENDED))
                for i, fname in enumerate(frames):
                    writer.writerow([clip, i, fname]
                                    + [f"{v:.6g}" for v in feats[i]])

            if annotate:
                import cv2

                ann_dir = os.path.join(out_split,
                                       f"{clip}_annotated_images")
                os.makedirs(ann_dir, exist_ok=True)
                for i, fname in enumerate(frames):
                    img = cv2.imread(os.path.join(clip_dir, fname))
                    if img is None:
                        continue
                    stem = os.path.splitext(fname)[0]
                    cv2.imwrite(os.path.join(ann_dir,
                                             f"{stem}_annotated.jpg"),
                                _annotate(img, lms[i]))
            report[split][clip] = len(frames)
    return report


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("renamed_root")
    ap.add_argument("out_root")
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
    print(process_image_sequences(args.renamed_root, args.out_root,
                                  extractor=ext, annotate=True,
                                  device=args.device))
