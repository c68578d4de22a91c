"""In-memory data source, mirroring ``surya_tpu/data/pipeline.py``.

``ArrayDataSource`` serves (images, features, labels) numpy splits as
host batches: shuffled full batches for training (wrap-padded when the
split is smaller than one batch), the eval tail as-is or padded with
sentinel rows. The train step copies each batch to the card.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from surya_tpu_torch.data.batching import pad_batch


class ArrayDataSource:
    """In-memory (images, features, labels) splits with epoch shuffling."""

    def __init__(self, splits: dict[str, tuple], batch_size: int,
                 seed: int = 0, drop_last_train: bool = True,
                 pad_eval_to: int = 1):
        self.splits = splits
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last_train = drop_last_train
        self.pad_eval_to = pad_eval_to
        first = next(iter(splits.values()))
        self.num_classes = int(np.max(first[2])) + 1
        for name, (imgs, feats, labels) in splits.items():
            if not (len(imgs) == len(feats) == len(labels)):
                raise ValueError(f"split {name!r} length mismatch")

    def train_batches(self, epoch_seed: int = 0) -> Iterator[tuple]:
        imgs, feats, labels = self.splits["train"]
        n = len(labels)
        rng = np.random.default_rng((self.seed, epoch_seed))
        order = rng.permutation(n)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last_train else n
        if stop == 0:  # tiny dataset: wrap-pad one batch
            order = np.resize(order, bs)
            stop = bs
        for i in range(0, stop, bs):
            idx = order[i:i + bs]
            if len(idx) < bs:
                idx = np.resize(idx, bs)
            yield imgs[idx], feats[idx], labels[idx]

    def eval_batches(self, split: str) -> Iterator[tuple]:
        if split not in self.splits:
            raise KeyError(split)   # eager: callers probe availability
        return self._eval_iter(split)

    def _eval_iter(self, split: str) -> Iterator[tuple]:
        imgs, feats, labels = self.splits[split]
        n = len(labels)
        bs = self.batch_size
        for i in range(0, n, bs):
            sl = slice(i, min(i + bs, n))
            yield pad_batch((imgs[sl], feats[sl], labels[sl]),
                            self.pad_eval_to)
