"""Sliding-window sequence dataset, mirroring ``surya_tpu/data/sequences.py``:
the dataset build, the loading source and the device-side finish.

- :func:`build_sequence_dataset` groups augmented frames by (clip, view)
  with the reference's filename regex, slides a window of ``seq_len`` with
  ``stride``, labels each window by its last frame, joins the numerical
  ``.npy`` vectors from the flat dataset by (clip, frame index) with
  zero-fill for missing files, skips outputs that exist (resume) and
  writes ``class_to_idx.json``. Windows are compressed ``.npz`` files:
  uint8 frames (T,H,W,3) and f32 features (T,47). PIL is imported inside
  the function (the card's machine has none). :func:`write_windows`
  writes windows already in memory (the temporal replay set) in the same
  layout.
- :class:`SequenceDataSource` serves (uint8 (B,T,H,W,3), f32 (B,T,47),
  int32 labels) host batches in JAX's file order, epoch order and eval
  padding; a window is padded (repeating its last frame) or truncated to
  ``seq_len``, its features ``nan_to_num``-ed.
- :func:`sequence_device_transform` finishes a batch on its device:
  uint8 → /255 → ImageNet normalisation (no augmentation), then the
  per-class per-time-step standardisation when ``standardize_features``
  is set, else NaN → 0.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Iterator

import numpy as np
import torch

from surya_tpu_torch.core.config import DataConfig
from surya_tpu_torch.data.batching import epoch_order, pad_eval_iter
from surya_tpu_torch.data.dataset import load_stats

# Matches: video_clip_001_frame_00101.jpg_view_01.png
FILENAME_PATTERN = re.compile(
    r"(video_clip_\d+)_frame_(\d+)(?:\.[a-zA-Z]+)?_view_(\d+)\.png")


def build_sequence_dataset(aug_root: str, flat_root: str, out_root: str,
                           seq_len: int = 4, stride: int = 2,
                           image_size: int = 224,
                           splits=("train", "valid", "test")) -> dict:
    """Build the windowed dataset; returns counts per split."""
    from PIL import Image

    os.makedirs(out_root, exist_ok=True)
    # the class map from the train split's label dirs
    classes = sorted(d for d in os.listdir(os.path.join(aug_root, "train"))
                     if os.path.isdir(os.path.join(aug_root, "train", d)))
    class_to_idx = {c.strip(): i for i, c in enumerate(classes)}
    with open(os.path.join(out_root, "class_to_idx.json"), "w") as f:
        json.dump(class_to_idx, f, indent=4)

    counts = {}
    for split in splits:
        split_path = os.path.join(aug_root, split)
        if not os.path.isdir(split_path):
            continue
        n_saved = 0
        for label in sorted(os.listdir(split_path)):
            label_path = os.path.join(split_path, label)
            if not os.path.isdir(label_path):
                continue
            # (clip, frame index) → the flat dataset's .npy
            npy_lookup = {}
            flat_label_dir = os.path.join(flat_root, split, label)
            if os.path.isdir(flat_label_dir):
                for fn in os.listdir(flat_label_dir):
                    if fn.endswith(".npy"):
                        parts = fn.split("_frame_")
                        if len(parts) >= 3:
                            npy_lookup[(parts[0],
                                        parts[-1][:-4])] = os.path.join(
                                            flat_label_dir, fn)

            grouped = defaultdict(list)
            for img_file in os.listdir(label_path):
                m = FILENAME_PATTERN.match(img_file)
                if not m:
                    continue
                clip, fidx, view = m.group(1), m.group(2), m.group(3)
                grouped[(clip, view)].append(
                    {"frame_idx": int(fidx), "fidx_str": fidx,
                     "img_path": os.path.join(label_path, img_file),
                     "label": label})

            for (clip, view), frames in grouped.items():
                frames.sort(key=lambda d: d["frame_idx"])
                for i in range(0, len(frames) - seq_len + 1, stride):
                    window = frames[i:i + seq_len]
                    label_str = window[-1]["label"].strip()
                    if label_str not in class_to_idx:
                        continue
                    cdir = os.path.join(out_root, split, label_str)
                    os.makedirs(cdir, exist_ok=True)
                    out = os.path.join(
                        cdir, f"{clip}_view_{view}_seq_{i:05d}.npz")
                    if os.path.exists(out):   # resumable
                        n_saved += 1
                        continue
                    imgs = np.empty((seq_len, image_size, image_size, 3),
                                    np.uint8)
                    feats = np.empty((seq_len, 47), np.float32)
                    for t, fd in enumerate(window):
                        with Image.open(fd["img_path"]) as im:
                            imgs[t] = np.asarray(
                                im.convert("RGB").resize(
                                    (image_size, image_size),
                                    Image.BILINEAR), np.uint8)
                        npy = npy_lookup.get((clip, fd["fidx_str"]))
                        feats[t] = (np.load(npy).astype(np.float32)
                                    if npy and os.path.exists(npy)
                                    else np.zeros(47, np.float32))
                    np.savez_compressed(
                        out, image_sequence=imgs, numerical_sequence=feats,
                        label=class_to_idx[label_str], video_clip=clip,
                        view_id=view)
                    n_saved += 1
        counts[split] = n_saved
    return counts


def write_windows(root: str, splits: dict[str, tuple],
                  class_names: list[str]) -> None:
    """Write in-memory windows {split: (uint8 clips (N,T,H,W,3), f32
    features (N,T,47), labels (N,))} in the layout the sequence sources
    read, as ``scripts/make_replay_disk.py`` writes the temporal replay
    set: ``class_to_idx.json`` and ``<split>/<class>/window_{i:05d}.npz``
    (``image_sequence``, ``numerical_sequence``, ``label``)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "class_to_idx.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(class_names)}, f, indent=4)
    for split, (clips, feats, labels) in splits.items():
        for i, (clip, feat, y) in enumerate(zip(clips, feats, labels)):
            cdir = os.path.join(root, split, class_names[y])
            os.makedirs(cdir, exist_ok=True)
            np.savez(os.path.join(cdir, f"window_{i:05d}.npz"),
                     image_sequence=clip, numerical_sequence=feat,
                     label=np.int64(y))


def _pad_or_truncate(arr: np.ndarray, seq_len: int) -> np.ndarray:
    """Repeat-last-frame pad, or truncate, to ``seq_len`` steps."""
    t = arr.shape[0]
    if t == seq_len:
        return arr
    if t > seq_len:
        return arr[:seq_len]
    pad = np.repeat(arr[-1:], seq_len - t, axis=0)
    return np.concatenate([arr, pad], axis=0)


def pinned(batch: tuple) -> tuple:
    """A host batch as pinned CPU tensors (an asynchronous copy to a card)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                 for a in batch)


class SequenceDataSource:
    """Batches of (image_seq uint8 (B,T,H,W,3), feature_seq (B,T,47),
    label) from the ``.npz`` window layout; pinned tensors with
    ``pin_memory`` (for batches bound for a card), numpy arrays otherwise."""

    def __init__(self, cfg: DataConfig, seed: int = 0,
                 splits=("train", "valid", "test"), stats=None,
                 pad_eval_to: int = 1, pin_memory: bool = False):
        self.cfg = cfg
        self.seed = seed
        self.pad_eval_to = pad_eval_to
        self.pin_memory = pin_memory
        root = cfg.seq_root
        with open(os.path.join(root, "class_to_idx.json")) as f:
            self.class_to_idx = json.load(f)
        self._set_classes(sorted(self.class_to_idx, key=self.class_to_idx.get),
                          stats, root)
        self.index = {}
        for s in splits:
            sdir = os.path.join(root, s)
            if not os.path.isdir(sdir):
                continue
            files = []
            for label in sorted(os.listdir(sdir)):
                ldir = os.path.join(sdir, label)
                if not os.path.isdir(ldir):
                    continue
                files += [os.path.join(ldir, f)
                          for f in sorted(os.listdir(ldir))
                          if f.endswith(".npz")]
            self.index[s] = files

    def _set_classes(self, class_names, stats, stats_root: str) -> None:
        """The class names in label order, and the per-class stats for the
        per-time-step standardisation (given, or read from ``stats_root``
        when ``standardize_features`` is set), aligned to them."""
        self.class_names = list(class_names)
        self.num_classes = len(self.class_names)
        if stats is not None:
            self.stats = stats.aligned_to(self.class_names)
        else:
            self.stats = (load_stats(stats_root, self.class_names)
                          if self.cfg.standardize_features else None)

    def _load(self, path: str):
        t = self.cfg.seq_len
        try:
            with np.load(path) as z:
                imgs = _pad_or_truncate(z["image_sequence"], t)
                feats = np.nan_to_num(
                    _pad_or_truncate(z["numerical_sequence"], t))
                return imgs, feats.astype(np.float32), int(z["label"])
        except Exception as e:   # a corrupt window: a zero one, as JAX
            print(f"[data] failed to load {path}: {e}; using dummy")
            h = self.cfg.image_size
            return (np.zeros((t, h, h, 3), np.uint8),
                    np.zeros((t, 47), np.float32), 0)

    def _load_batch(self, split: str, idx: np.ndarray) -> tuple:
        samples = [self._load(self.index[split][j]) for j in idx]
        return (np.stack([s[0] for s in samples]),
                np.stack([s[1] for s in samples]),
                np.asarray([s[2] for s in samples], np.int32))

    def _batches(self, split: str, order) -> Iterator[tuple]:
        bs = self.cfg.batch_size
        for i in range(0, len(order), bs):
            batch = self._load_batch(split, order[i:i + bs])
            yield pinned(batch) if self.pin_memory else batch

    def train_batches(self, epoch_seed: int = 0) -> Iterator[tuple]:
        n = len(self.index["train"])
        order = epoch_order(n, self.cfg.batch_size, self.seed, epoch_seed)
        return self._batches("train", order)

    def eval_batches(self, split: str) -> Iterator[tuple]:
        if split not in self.index:
            raise KeyError(split)   # eager: callers probe availability
        it = self._batches(split, np.arange(len(self.index[split])))
        return pad_eval_iter(it, self.pad_eval_to)

    def device_transform(self, split: str, generator, batch):
        return sequence_device_transform(self.cfg, self.stats, split,
                                         generator, batch)


def sequence_device_transform(cfg: DataConfig, stats, split: str, generator,
                              batch):
    """uint8 frames → normalised f32 on the batch's device (no augmentation:
    the reference's sequence loader has none); with ``stats`` and
    ``cfg.standardize_features`` the per-class standardisation of every
    time step (NaN → the class mean, then (x − μ_c)/σ_c, σ < 1e-6 → 0),
    else NaN → 0. ``split`` and ``generator`` are unused (the interface of
    ``device_transform``)."""
    from surya_tpu_torch.data.augment import div, normalize

    images, feats, labels = (torch.as_tensor(a) for a in batch)
    images = normalize(div(images.float(), 255.0))
    if stats is not None and cfg.standardize_features:
        # labels broadcast over the time axis: (B,) → (B, T)
        feats = stats.standardize(
            feats, labels[:, None].expand(feats.shape[:2]))
    else:
        feats = torch.nan_to_num(feats)
    return images, feats, labels
