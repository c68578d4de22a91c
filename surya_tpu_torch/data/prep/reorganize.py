"""Flatten sequence directories into the flat image layout (a copy of
``surya_tpu/data/prep/reorganize.py``).

Parity with ``img process/reorganize_single_frame_dataset.py:17-83``:
given a sequence dataset root
(``<split>/<class>/sequence_xxxxx/{features.npy, images/*.jpg}`` with a
``dataset_metadata.json``), copy every frame to
``<out>/<split>/<class>/<seq_id>_<frame>.jpg`` uniquified by sequence id.
"""

from __future__ import annotations

import json
import os
import shutil


def reorganize_to_flat(seq_root: str, out_root: str) -> dict:
    meta_path = os.path.join(seq_root, "dataset_metadata.json")
    metadata = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    del metadata  # informational only; layout walk below is the source

    counts: dict[str, int] = {}
    # the reference sequence builder names the split 'val'
    # (create_sequential_dataset.py split_name_map); accept both and
    # emit the flat layout's 'valid'
    for out_split, src_names in (("train", ("train",)),
                                 ("valid", ("valid", "val")),
                                 ("test", ("test",))):
        split = out_split
        split_dir = next(
            (d for d in (os.path.join(seq_root, s) for s in src_names)
             if os.path.isdir(d)), None)
        if split_dir is None:
            continue
        n = 0
        for cls in sorted(os.listdir(split_dir)):
            cdir = os.path.join(split_dir, cls)
            if not os.path.isdir(cdir):
                continue
            out_dir = os.path.join(out_root, split, cls)
            os.makedirs(out_dir, exist_ok=True)
            for seq in sorted(os.listdir(cdir)):
                sdir = os.path.join(cdir, seq)
                img_dir = os.path.join(sdir, "images")
                if not os.path.isdir(img_dir):
                    continue
                for img in sorted(os.listdir(img_dir)):
                    if not img.lower().endswith((".jpg", ".png")):
                        continue
                    shutil.copy2(os.path.join(img_dir, img),
                                 os.path.join(out_dir,
                                              f"{seq}_{img}"))
                    n += 1
        counts[split] = n
    return counts


if __name__ == "__main__":
    import sys

    print(reorganize_to_flat(sys.argv[1], sys.argv[2]))
