"""Packed pre-decoded dataset cache, mirroring ``surya_tpu/data/packed.py``:
decode once, then serve batches at memcpy speed.

- :func:`pack_dataset` decodes every image once at the staging size
  (through the same native/PIL path ``DiskDataSource`` uses) into
  ``<split>_images.npy`` uint8 memmaps plus feature and label arrays, and
  writes ``packed_meta.json``; already-packed splits whose sizes match are
  skipped (resume).
- :func:`pack_arrays` writes arrays already in memory (synthetic data)
  in the same layout.
- :class:`PackedDataSource` serves batches from those memmaps as a
  drop-in ``DiskDataSource``: a fancy-indexed read per batch, no decode,
  and the device-side augment and imputation unchanged.
- :func:`pack_sequences` packs the windowed ``.npz`` sequence dataset
  (``data/sequences.py``) the same way, each window padded or truncated
  to ``seq_len`` as the live loader does, into (N,T,H,W,3) memmaps; and
  :class:`PackedSequenceSource` serves them as a drop-in
  ``SequenceDataSource``.

The layout and the metadata format (version 1) are the JAX package's, so
a pack written by either package is read by the other.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from surya_tpu_torch.core.config import DataConfig
from surya_tpu_torch.data.dataset import (
    STATS_FILES,
    DiskDataSource,
    load_stats,
)
from surya_tpu_torch.data.imputation import (
    ClassFeatureStats,
    compute_class_stats,
)
from surya_tpu_torch.data.sequences import SequenceDataSource
from surya_tpu_torch.features import FEATURE_NAMES_47

META_NAME = "packed_meta.json"
FORMAT_VERSION = 1


def _check_source_root(meta: dict, cfg_root: str, pdir: str) -> None:
    """A pack records the dataset it was decoded from; serving it for a
    different configured root would train on the wrong bytes."""
    recorded = meta.get("source_root")
    if cfg_root and recorded and os.path.abspath(cfg_root) != recorded:
        raise ValueError(
            f"packed cache {pdir} was built from {recorded} but the "
            f"config points at {os.path.abspath(cfg_root)}; repack "
            "(overwrite=True / a fresh out dir) or fix the data root")


def split_paths(out_dir: str, split: str) -> dict:
    return {
        "images": os.path.join(out_dir, f"{split}_images.npy"),
        "features": os.path.join(out_dir, f"{split}_features.npy"),
        "labels": os.path.join(out_dir, f"{split}_labels.npy"),
    }


def _new_meta(kind: str, source_root: str, class_names, **shape) -> dict:
    """A pack's metadata with no split yet; ``shape`` holds the keys that
    fix its sample shape (``staging`` for a flat pack, ``seq_len`` for a
    sequence pack)."""
    return {"format_version": FORMAT_VERSION, "kind": kind, **shape,
            "source_root": source_root, "class_names": list(class_names),
            "splits": {}}


def _write_meta(out_dir: str, meta: dict) -> None:
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)


def _write_split(out_dir: str, meta: dict, split: str, labels, chunks,
                 sample_shape: tuple | None = None) -> None:
    """Write one split from ``chunks``, an iterable of (uint8 images
    (k, *sample_shape), features (k, ..., 47)) in sample order, then
    record it in the metadata (written per split, so a pack can resume
    mid-way). ``sample_shape`` is one image's, (S,S,3) at the staging size
    by default; a sequence pack's is (T,H,W,3), with (T,47) features."""
    files = split_paths(out_dir, split)
    n = len(labels)
    if sample_shape is None:
        sample_shape = (meta["staging"], meta["staging"], 3)
    images = np.lib.format.open_memmap(
        files["images"], mode="w+", dtype=np.uint8,
        shape=(n, *sample_shape))
    feats = np.empty((n, *sample_shape[:-3], 47), np.float32)
    start = 0
    for imgs, f in chunks:
        images[start:start + len(imgs)] = imgs
        feats[start:start + len(imgs)] = f
        start += len(imgs)
    if start != n:
        raise ValueError(f"{split}: {start} images for {n} labels")
    images.flush()
    del images
    np.save(files["features"], feats)
    np.save(files["labels"], np.asarray(labels, np.int32))
    meta["splits"][split] = {"count": n}
    _write_meta(out_dir, meta)


def _pack(out_dir: str, meta: dict, counts: dict, write, copy_from: str,
          copy_names, overwrite: bool, verbose: bool, noun: str) -> dict:
    """The packers' shared frame. A pack already in ``out_dir`` lends its
    finished splits when its kind, shape keys and classes match ``meta``
    (and raises otherwise, unless ``overwrite``); each split of ``counts``
    ({split: n samples}) is written by ``write(split)`` unless it is
    already packed at that size (resume); ``copy_names`` are copied from
    ``copy_from`` so the pack is self-contained. Returns the metadata."""
    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, META_NAME)
    if os.path.exists(meta_path) and not overwrite:
        with open(meta_path) as f:
            old = json.load(f)
        old.setdefault("kind", "flat")
        shape = [k for k in meta if k not in (
            "format_version", "kind", "source_root", "class_names",
            "splits")]
        if any(old.get(k) != meta[k]
               for k in ("kind", *shape, "class_names")):
            have = " ".join(f"{k}={old.get(k)}" for k in shape)
            want = " ".join(f"{k}={meta[k]}" for k in shape)
            raise ValueError(
                f"{out_dir} holds a {old['kind']} pack with {have} "
                f"classes={old.get('class_names')}; requested a "
                f"{meta['kind']} pack with {want}. Pass overwrite=True or "
                "use a fresh out_dir.")
        meta["splits"] = old.get("splits", {})

    for split, n in counts.items():
        done = meta["splits"].get(split)
        if (done and done.get("count") == n and not overwrite
                and all(os.path.exists(p)
                        for p in split_paths(out_dir, split).values())):
            if verbose:
                print(f"[pack] {split}: {n} {noun} already packed, skipping")
            continue
        write(split)

    for name in copy_names:
        s = os.path.join(copy_from, name)
        if os.path.exists(s):
            shutil.copy2(s, os.path.join(out_dir, name))
    _write_meta(out_dir, meta)
    return meta


def pack_dataset(data_root: str, out_dir: str, staging: int = 256,
                 splits=("train", "valid", "test"), use_native: bool = True,
                 chunk: int = 256, overwrite: bool = False,
                 verbose: bool = True) -> dict:
    """Decode the flat-image dataset once into memmap arrays.

    Returns the metadata dict (also written to ``out_dir/packed_meta.json``).
    Already-packed splits whose sizes match are skipped (resume);
    ``overwrite=True`` forces a rebuild.
    """
    cfg = DataConfig(data_root=data_root, batch_size=chunk)
    src = DiskDataSource(cfg, splits=splits, staging_size=staging,
                         use_native=use_native)
    meta = _new_meta("flat", os.path.abspath(data_root), src.class_names,
                     staging=staging)

    def write(split):
        labels = src.index[split][2]
        n = len(labels)
        if verbose:
            print(f"[pack] {split}: decoding {n} images at {staging}px")
        _write_split(out_dir, meta, split, labels, (
            src._load_batch(split, np.arange(start, min(start + chunk, n)))
            [:2] for start in range(0, n, chunk)))

    # the per-class stats go next to the pack, so it is self-contained
    return _pack(out_dir, meta,
                 {split: len(ix[2]) for split, ix in src.index.items()},
                 write, data_root, STATS_FILES, overwrite, verbose, "images")


def pack_arrays(out_dir: str, splits: dict[str, tuple],
                class_names: list[str]) -> dict:
    """Write in-memory splits {name: (uint8 images (N,S,S,3), features
    (N,47), labels (N,))} in the pack layout through the writer of
    :func:`pack_dataset`, with no source dataset (the source-root check
    is then skipped), and the per-class feature stats of the train split
    where a decoded dataset keeps them. Returns the metadata."""
    os.makedirs(out_dir, exist_ok=True)
    staging = {imgs.shape[1] for imgs, _, _ in splits.values()}
    if len(staging) != 1:
        raise ValueError(f"splits have different staging sizes {staging}")
    meta = _new_meta("flat", "", class_names, staging=staging.pop())
    for split, (imgs, feats, labels) in splits.items():
        if imgs.dtype != np.uint8 or imgs.ndim != 4 or imgs.shape[3] != 3:
            raise ValueError(f"{split}: images must be uint8 (N,S,S,3), "
                             f"got {imgs.dtype} {imgs.shape}")
        _write_split(out_dir, meta, split, labels, [(imgs, feats)])
    if "train" in splits:
        _, feats, labels = splits["train"]
        for name, table in zip(STATS_FILES, compute_class_stats(
                np.asarray(feats, np.float32), np.asarray(labels),
                len(class_names))):
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump({c: dict(zip(FEATURE_NAMES_47, map(float, row)))
                           for c, row in zip(class_names, table)}, f)
    return meta


class PackedDataSource(DiskDataSource):
    """DiskDataSource drop-in serving batches from the packed memmaps.

    Inherits the threaded prefetch, epoch shuffling, eval-tail padding and
    the device-side transform; only ``_load_batch`` differs (a memmap
    gather instead of decode + np.load)."""

    def __init__(self, cfg: DataConfig, packed_dir: str | None = None,
                 stats: ClassFeatureStats | None = None, seed: int = 0,
                 staging_size: int = 256, use_native: bool = True,
                 pad_eval_to: int = 1, build: bool = True,
                 pin_memory: bool = False):
        pdir = packed_dir or cfg.packed_dir
        if not pdir:
            raise ValueError("PackedDataSource needs packed_dir "
                             "(or data.packed_dir in the config)")
        meta_path = os.path.join(pdir, META_NAME)
        if not os.path.exists(meta_path):
            if not build:
                raise FileNotFoundError(meta_path)
            pack_dataset(cfg.data_root, pdir, staging=staging_size,
                         use_native=use_native)
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("kind", "flat") != "flat":
            raise ValueError(f"{pdir} is a {meta['kind']} pack; "
                             "use PackedSequenceSource")
        _check_source_root(meta, cfg.data_root, pdir)

        self.cfg = cfg
        self.staging = int(meta["staging"])
        self.num_threads = 1
        self.seed = seed
        self.use_native = False
        self.pad_eval_to = pad_eval_to
        self.pin_memory = pin_memory
        self.packed_dir = pdir
        self.class_names = list(meta["class_names"])
        self.num_classes = len(self.class_names)

        self._images, self._feats = {}, {}
        self.index = {}
        for split in meta["splits"]:
            files = split_paths(pdir, split)
            self._images[split] = np.load(files["images"], mmap_mode="r")
            self._feats[split] = np.load(files["features"])
            labels = np.load(files["labels"])
            # the index tuple of DiskDataSource: train_batches and
            # eval_batches read only the labels (2) and class names (3)
            self.index[split] = ((), (), labels, self.class_names)
        if "train" not in self.index:
            raise FileNotFoundError(f"no packed train split under {pdir}")
        self.stats = (stats.aligned_to(self.class_names) if stats is not None
                      else load_stats(pdir, self.class_names))

    def _load_batch(self, split: str, idx: np.ndarray):
        imgs = self._images[split][idx]  # memmap gather -> fresh ndarray
        return imgs, self._feats[split][idx], self.index[split][2][idx]


# --- sequence (temporal) pack ------------------------------------------------

def pack_sequences(seq_root: str, out_dir: str, seq_len: int = 4,
                   splits=("train", "valid", "test"),
                   overwrite: bool = False, verbose: bool = True) -> dict:
    """Pack the windowed ``.npz`` sequence dataset into memmap arrays: a
    window's zlib decompression becomes one fancy-indexed read of a
    (N, T, H, W, 3) uint8 memmap. Windows are padded or truncated to
    ``seq_len`` with the live loader's rule, so packed batches are
    byte-identical to ``SequenceDataSource``'s. Returns the metadata."""
    src = SequenceDataSource(DataConfig(seq_root=seq_root, seq_len=seq_len),
                             splits=splits)
    meta = _new_meta("sequences", os.path.abspath(seq_root),
                     src.class_names, seq_len=seq_len)

    def write(split):
        files = src.index[split]
        n = len(files)
        if verbose:
            print(f"[pack] {split}: packing {n} windows (T={seq_len})")
        shape = src._load(files[0])[0].shape if n else (seq_len, 1, 1, 3)
        labels = np.empty((n,), np.int32)

        def chunks():
            for i, path in enumerate(files):
                imgs, feats, labels[i] = src._load(path)
                yield imgs[None], feats[None]

        _write_split(out_dir, meta, split, labels, chunks(), shape)

    return _pack(out_dir, meta,
                 {split: len(files) for split, files in src.index.items()},
                 write, seq_root, ("class_to_idx.json",) + STATS_FILES,
                 overwrite, verbose, "windows")


class PackedSequenceSource(SequenceDataSource):
    """``SequenceDataSource`` drop-in over the packed sequence memmaps.

    Inherits the batching, epoch order, eval padding, pinning and the
    device transform; only the index (labels per split) and
    ``_load_batch`` (a memmap gather instead of reading ``.npz`` windows)
    differ."""

    def __init__(self, cfg: DataConfig, packed_dir: str | None = None,
                 stats: ClassFeatureStats | None = None, seed: int = 0,
                 pad_eval_to: int = 1, build: bool = True,
                 pin_memory: bool = False):
        pdir = packed_dir or cfg.packed_dir
        if not pdir:
            raise ValueError("PackedSequenceSource needs packed_dir "
                             "(or data.packed_dir in the config)")
        meta_path = os.path.join(pdir, META_NAME)
        if not os.path.exists(meta_path):
            if not build:
                raise FileNotFoundError(meta_path)
            pack_sequences(cfg.seq_root, pdir, seq_len=cfg.seq_len)
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("kind") != "sequences":
            raise ValueError(f"{pdir} is a {meta.get('kind', 'flat')} "
                             "pack; use PackedDataSource")
        if meta["seq_len"] != cfg.seq_len:
            raise ValueError(
                f"pack was built with seq_len={meta['seq_len']}, config "
                f"wants {cfg.seq_len}; repack or fix data.seq_len")
        _check_source_root(meta, cfg.seq_root, pdir)

        self.cfg = cfg
        self.seed = seed
        self.pad_eval_to = pad_eval_to
        self.pin_memory = pin_memory
        self.packed_dir = pdir
        self._set_classes(meta["class_names"], stats, pdir)

        self._images, self._feats = {}, {}
        self.index = {}      # the labels: the batching reads only len()
        for split in meta["splits"]:
            files = split_paths(pdir, split)
            self._images[split] = np.load(files["images"], mmap_mode="r")
            self._feats[split] = np.load(files["features"])
            self.index[split] = np.load(files["labels"])
        if "train" not in self.index:
            raise FileNotFoundError(f"no packed train split under {pdir}")

    def _load_batch(self, split: str, idx: np.ndarray):
        return (self._images[split][idx], self._feats[split][idx],
                self.index[split][idx])
