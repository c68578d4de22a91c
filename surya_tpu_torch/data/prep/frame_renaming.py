"""L0: non-in-place frame renaming + per-clip frame-map CSVs (a copy of
``surya_tpu/data/prep/frame_renaming.py``).

Parity with ``sqn process/Frame_Renaming.py:24-139``: for each
``<raw_root>/<split>/<clip>/`` directory, natural-sort the image files,
copy them to ``<renamed_root>/<split>/<clip>/frame_%05d.<ext>`` (1-based
index), and write ``<clip>_frame_map.csv`` with columns
(new_filename, original_filename, clip_name, split).

Usage: python -m surya_tpu_torch.data.prep.frame_renaming RAW_ROOT OUT_ROOT
"""

from __future__ import annotations

import csv
import os
import re
import shutil

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")
SPLITS = ("train", "test", "valid")


def natural_sort_key(s: str):
    """Natural sort: 'frame2' < 'frame10' (ref ``:61-62``)."""
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"([0-9]+)", s)]


def rename_frames(raw_root: str, renamed_root: str,
                  splits=SPLITS) -> dict:
    """Returns {split: {clip: n_frames}}. Idempotent (copies overwrite)."""
    if not os.path.isdir(raw_root):
        raise FileNotFoundError(raw_root)
    os.makedirs(renamed_root, exist_ok=True)
    report: dict = {}
    for split in splits:
        split_raw = os.path.join(raw_root, split)
        if not os.path.isdir(split_raw):
            continue
        report[split] = {}
        for clip in sorted(os.listdir(split_raw)):
            clip_raw = os.path.join(split_raw, clip)
            if not os.path.isdir(clip_raw):
                continue
            clip_out = os.path.join(renamed_root, split, clip)
            os.makedirs(clip_out, exist_ok=True)
            frames = sorted(
                (f for f in os.listdir(clip_raw)
                 if f.lower().endswith(IMG_EXTS)),
                key=natural_sort_key)
            rows = []
            for i, original in enumerate(frames):
                ext = os.path.splitext(original)[1]
                new_name = f"frame_{i + 1:05d}{ext}"
                shutil.copy(os.path.join(clip_raw, original),
                            os.path.join(clip_out, new_name))
                rows.append({"new_filename": new_name,
                             "original_filename": original,
                             "clip_name": clip, "split": split})
            if rows:
                map_path = os.path.join(clip_out,
                                        f"{clip}_frame_map.csv")
                with open(map_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=list(rows[0]))
                    w.writeheader()
                    w.writerows(rows)
            report[split][clip] = len(rows)
    return report


def load_frame_map(clip_dir: str, clip_name: str) -> dict[str, str]:
    """new_filename → original_filename (consumed by L1 prep,
    ``1_prepare_still_image_dataset.py:191-198``)."""
    path = os.path.join(clip_dir, f"{clip_name}_frame_map.csv")
    out = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out[row["new_filename"]] = row["original_filename"]
    return out


def extract_video_id(original_filename: str) -> str:
    """Video-id extraction regex (``1_prepare_still_image_dataset.py:
    115-123``; used for video-level splits in Data_organiser)."""
    m = re.match(r"(.+?)(-\d{4,5}_jpg|\.mp4)", original_filename)
    if m:
        return m.group(1).replace("_mp4", "").strip()
    m = re.match(r"(.+?)\.rf\.", original_filename)
    if m:
        return m.group(1).replace("_mp4", "").strip()
    return (original_filename.split("-")[0].split(".rf.")[0]
            .replace("_mp4", "").strip())


if __name__ == "__main__":
    import sys

    raw, out = sys.argv[1], sys.argv[2]
    rep = rename_frames(raw, out)
    for split, clips in rep.items():
        print(f"{split}: {sum(clips.values())} frames in "
              f"{len(clips)} clips")
