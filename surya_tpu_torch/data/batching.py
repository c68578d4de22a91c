"""Shared host-side batching helpers, a copy of
``surya_tpu/data/batching.py`` (the orders must be identical).

- :func:`epoch_order`: shuffled full-batch epoch order; datasets smaller
  than one batch wrap-pad to exactly one full batch.
- :func:`pad_batch` / :func:`pad_eval_iter`: eval tail padding to a
  multiple of ``pad_to``, repeating the last row with sentinel label -1,
  which the eval step masks out of every statistic.
"""

from __future__ import annotations

import numpy as np


def epoch_order(n: int, bs: int, seed, epoch_seed) -> np.ndarray:
    rng = np.random.default_rng((seed, epoch_seed))
    order = rng.permutation(n)
    stop = (n // bs) * bs if n >= bs else bs
    return np.resize(order, stop) if n < bs else order[:stop]


def pad_batch(batch: tuple, pad_to: int) -> tuple:
    """Pad every array to a pad_to multiple; labels (last slot) get -1."""
    labels = batch[-1]
    extra = (-len(labels)) % pad_to
    if not extra:
        return batch
    arrs = [np.concatenate([a, np.repeat(a[-1:], extra, 0)])
            for a in batch[:-1]]
    arrs.append(np.concatenate(
        [labels, np.full((extra,), -1, dtype=labels.dtype)]))
    return tuple(arrs)


def pad_eval_iter(it, pad_to: int):
    if pad_to > 1:
        return (pad_batch(b, pad_to) for b in it)
    return it
