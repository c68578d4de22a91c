"""Disk-backed multimodal image dataset, mirroring
``surya_tpu/data/dataset.py``.

Scans ``<root>/<split>/<class>/*.jpg`` with sibling ``.npy`` 47-vectors
and serves global batches:

- host side: threaded JPEG decode + resize to a fixed staging size,
  shuffle, batch, prefetch; with ``pin_memory`` (the caller's choice,
  for batches bound for a card) each host batch is pinned in the
  producer thread, so its copy to the card can run asynchronously;
- device side: :func:`device_transform` turns the uint8
  batch into f32/255 on the batch's device, applies the augmentation
  (``data/augment.py``) or the eval resize, then the per-class NaN
  imputation or standardization (``data/imputation.py``).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from surya_tpu_torch.core.config import DataConfig
from surya_tpu_torch.data.batching import epoch_order, pad_eval_iter
from surya_tpu_torch.data.imputation import ClassFeatureStats

IMG_EXTS = (".jpg", ".jpeg", ".png")
STATS_FILES = ("class_feature_means.json", "class_feature_stds.json")


def scan_image_dataset(root: str, split: str):
    """Returns (image_paths, feature_paths, labels, class_names).

    Classes are the sorted subdirectories; images without a sibling
    ``.npy`` are skipped with a warning."""
    split_dir = os.path.join(root, split)
    if not os.path.isdir(split_dir):
        raise FileNotFoundError(split_dir)
    class_names = sorted(d for d in os.listdir(split_dir)
                         if os.path.isdir(os.path.join(split_dir, d)))
    image_paths, feature_paths, labels = [], [], []
    skipped = 0
    for ci, cname in enumerate(class_names):
        cdir = os.path.join(split_dir, cname)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith(IMG_EXTS):
                continue
            ipath = os.path.join(cdir, fname)
            npy = os.path.splitext(ipath)[0] + ".npy"
            if not os.path.exists(npy):
                skipped += 1
                continue
            image_paths.append(ipath)
            feature_paths.append(npy)
            labels.append(ci)
    if skipped:
        print(f"[data] {split}: skipped {skipped} images without .npy")
    return (image_paths, feature_paths,
            np.asarray(labels, np.int32), class_names)


def load_stats(root: str, class_names) -> ClassFeatureStats | None:
    """The per-class stats next to a dataset or pack, aligned to its class
    order, or None when ``class_feature_means.json`` is absent."""
    means, stds = (os.path.join(root, f) for f in STATS_FILES)
    if not os.path.exists(means):
        return None
    stats = ClassFeatureStats.from_json(
        means, stds if os.path.exists(stds) else None)
    return stats.aligned_to(class_names)


def _decode(path: str, staging: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((staging, staging),
                                      Image.BILINEAR)
        return np.asarray(im, np.uint8)


class DiskDataSource:
    """train_batches/eval_batches over the on-disk layout.

    Batches are (images uint8 (B,S,S,3), features f32 (B,47), labels
    i32), numpy arrays, or pinned CPU tensors with ``pin_memory`` (pass it
    when the batches go to a card); :meth:`device_transform` finishes the
    pipeline on the device.
    """

    def __init__(self, cfg: DataConfig, splits=("train", "valid", "test"),
                 stats: ClassFeatureStats | None = None,
                 staging_size: int = 256, num_threads: int = 8,
                 seed: int = 0, use_native: bool = True,
                 pad_eval_to: int = 1, pin_memory: bool = False):
        self.cfg = cfg
        self.pin_memory = pin_memory
        self.staging = staging_size
        self.num_threads = num_threads
        self.seed = seed
        # the C++ libjpeg decoder (surya_tpu_torch.native) when it builds,
        # PIL otherwise; the two resize filters differ slightly
        self.use_native = use_native
        self.pad_eval_to = pad_eval_to
        self.index = {}
        for s in splits:
            try:
                self.index[s] = scan_image_dataset(cfg.data_root, s)
            except FileNotFoundError:
                pass
        if "train" not in self.index:
            raise FileNotFoundError(
                f"no train split under {cfg.data_root}")
        self.class_names = self.index["train"][3]
        self.num_classes = len(self.class_names)
        # labels index each split's OWN sorted class dirs: a missing or
        # extra dir would silently shift every later label
        for s, (_, _, _, names) in self.index.items():
            if list(names) != list(self.class_names):
                raise ValueError(
                    f"split {s!r} class dirs {list(names)} != train's "
                    f"{list(self.class_names)}; eval labels would be "
                    "misaligned (create empty dirs for absent classes)")
        self.stats = (stats.aligned_to(self.class_names) if stats is not None
                      else load_stats(cfg.data_root, self.class_names))

    # -- host batching ----------------------------------------------------

    def _load_batch(self, split: str, idx: np.ndarray):
        paths, fpaths, labels, _ = self.index[split]
        batch_paths = [paths[i] for i in idx]
        imgs = None
        if self.use_native and all(
                p.lower().endswith((".jpg", ".jpeg"))
                for p in batch_paths):
            from surya_tpu_torch import native

            if native.available():
                imgs, n_ok = native.decode_batch(batch_paths,
                                                 self.staging)
                if n_ok != len(batch_paths):
                    # don't train on zero-filled frames: the PIL path
                    # below raises with the bad file's name
                    imgs = None
        if imgs is None:
            imgs = np.empty((len(idx), self.staging, self.staging, 3),
                            np.uint8)
            for j, p in enumerate(batch_paths):
                imgs[j] = _decode(p, self.staging)
        feats = np.empty((len(idx), 47), np.float32)
        for j, i in enumerate(idx):
            feats[j] = np.load(fpaths[i]).astype(np.float32)
        return imgs, feats, labels[idx]

    def _batches(self, split: str, order: np.ndarray,
                 bs: int) -> Iterator[tuple]:
        """Threaded double-buffered batch producer.

        Abandoning the iterator early (a preemption break, a consumer
        error) unblocks the producer through the stop event; otherwise
        the thread would sit on a full queue holding decoded batches."""
        chunks = [order[i:i + bs] for i in range(0, len(order), bs)]
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for ch in chunks:
                    batch = self._load_batch(split, ch)
                    if self.pin_memory:
                        batch = tuple(torch.from_numpy(a).pin_memory()
                                      for a in batch)
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:  # surface, don't deadlock
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def train_batches(self, epoch_seed: int = 0) -> Iterator[tuple]:
        n = len(self.index["train"][2])
        bs = self.cfg.batch_size
        order = epoch_order(n, bs, self.seed, epoch_seed)
        yield from self._batches("train", order, bs)

    def eval_batches(self, split: str) -> Iterator[tuple]:
        if split not in self.index:
            raise KeyError(split)   # eager: callers probe availability
        n = len(self.index[split][2])
        it = self._batches(split, np.arange(n), self.cfg.batch_size)
        return pad_eval_iter(it, self.pad_eval_to)

    # -- device-side finish -------------------------------------------------

    def device_transform(self, split: str, generator, batch):
        """See :func:`device_transform`."""
        return device_transform(self.cfg, self.stats, split, generator,
                                batch)


def device_transform(cfg: DataConfig, stats: ClassFeatureStats | None,
                     split: str, generator, batch):
    """uint8 batch → (normalised f32 images, features, labels) on the
    batch's device: /255, then the augmentation (train split with a
    generator and ``cfg.augment``) or the eval resize, then per-class
    imputation or standardization (``stats``) or NaN → 0. ``generator``
    is None for eval preprocessing, even on the train split (the read-only
    consumers pass none); it may live on another device than the batch,
    and the drawn parameters move to the batch."""
    from surya_tpu_torch.data.augment import (
        augment_batch,
        div,
        eval_preprocess,
    )

    images, feats, labels = (torch.as_tensor(a) for a in batch)
    images = div(images.float(), 255.0)
    if split == "train" and cfg.augment and generator is not None:
        images = augment_batch(
            generator, images, out_size=cfg.image_size,
            scale_min=cfg.rrc_scale_min, hflip_prob=cfg.hflip_prob,
            jitter=(cfg.jitter_brightness, cfg.jitter_contrast,
                    cfg.jitter_saturation, cfg.jitter_hue),
            rotation_deg=cfg.rotation_deg,
            blur_sigma=(cfg.blur_sigma_min, cfg.blur_sigma_max))
    else:
        images = eval_preprocess(images, out_size=cfg.image_size)

    if stats is not None:
        feats = (stats.standardize(feats, labels)
                 if cfg.standardize_features
                 else stats.impute(feats, labels))
    else:
        feats = torch.nan_to_num(feats)
    return images, feats, labels
