"""Reference-replay synthetic datasets, a copy of
``surya_tpu/data/replay.py`` (pure numpy; the same arrays, bit for bit,
for the same arguments).

224 px, 8 classes, Bayes-limited difficulty: class ``c = 2*q + b``, the
image carries only ``q`` (4-way) and the 47-feature vector only the bit
``b``, whose Bayes error is :func:`bayes_bit_error`. Spatial: ``q = 2*row
+ tex``, a checkerboard patch with fine or coarse cells in the top or
bottom half, its contrast drawn as ``amp_hi * u**amp_pow`` so that some
samples' image cue is invisible. Temporal: ``q = 2*dir + tex``, the patch
drifting up or down by ``dy`` px a frame and wrapping inside a fixed band,
so every frame's marginal position is uniform for both directions and
only a spatiotemporal model reads the direction; the numeric-bit noise is
drawn once a window (plus a small per-frame jitter).

The temporal windows are raw uint8 arrays, written as ``.npz`` windows
with no JPEG (``scripts/make_replay_disk.py``), so a set made here is the
very set the JAX package trains on.
"""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 8


def _board(patch: int, cell: int) -> np.ndarray:
    py, px = np.mgrid[0:patch, 0:patch]
    return (((py // cell) + (px // cell)) % 2).astype(np.float32) * 2 - 1


def _features(labels, rng, num_features, n_info, feat_sep, feat_noise,
              class_seed):
    """47-dim vectors carrying only the bit b = label % 2."""
    n = labels.shape[0]
    feats = rng.normal(0.0, 1.0, (n, num_features)).astype(np.float32)
    info = np.random.default_rng(class_seed).choice(
        num_features, size=n_info, replace=False)
    bits = (labels % 2).astype(np.float32) * 2 - 1          # ±1
    for j in info:
        feats[:, j] = (bits * feat_sep / 2 + rng.normal(
            0.0, feat_noise, n)).astype(np.float32)
    return feats


def bayes_bit_error(n_info: int = 4, feat_sep: float = 1.55,
                    feat_noise: float = 1.0) -> float:
    """Analytic Bayes error of the numeric bit (Gaussian Q-function)."""
    from math import erf, sqrt

    z = feat_sep * sqrt(n_info) / (2 * feat_noise)
    return 0.5 * (1 - erf(z / sqrt(2)))


def make_replay_spatial(per_class: int = 96, image_size: int = 224,
                        seed: int = 0, *, num_features: int = 47,
                        bg_noise: float = 0.16, amp_hi: float = 0.45,
                        amp_pow: float = 1.5, cell_fine: int = 4,
                        cell_coarse: int = 13, n_info: int = 4,
                        feat_sep: float = 1.55, feat_noise: float = 1.0,
                        class_seed: int = 77):
    """Returns (images uint8 NHWC, features f32, labels i32).

    Images are uint8 in [0,255] (mid-gray background) so they can be
    written as JPEGs losslessly-enough for the real disk pipeline.
    """
    rng = np.random.default_rng(seed)
    h = image_size
    n = NUM_CLASSES * per_class
    labels = np.repeat(np.arange(NUM_CLASSES), per_class).astype(np.int32)
    patch = h // 4

    imgs = rng.normal(0.5, bg_noise, (n, h, h, 1)).astype(np.float32)
    imgs = np.repeat(imgs, 3, axis=-1)
    boards = {0: _board(patch, cell_fine), 1: _board(patch, cell_coarse)}

    for i, c in enumerate(labels):
        q = c // 2
        row, tex = q // 2, q % 2
        amp = amp_hi * rng.random() ** amp_pow
        sign = 1.0 if rng.random() < 0.5 else -1.0
        cell = cell_fine if tex == 0 else cell_coarse
        roll = int(rng.integers(0, 2 * cell))
        tex_img = np.roll(np.roll(boards[tex], roll, 0), roll, 1)
        # vertical center 0.25h/0.75h ± 0.06h keeps the patch inside
        # its half through crop/rotation augmentation margins
        cy = int((0.25 + 0.5 * row) * h + rng.uniform(-0.06, 0.06) * h)
        cx = int(rng.uniform(0.18, 0.82) * h)
        y0, x0 = cy - patch // 2, cx - patch // 2
        imgs[i, y0:y0 + patch, x0:x0 + patch, :] += (
            amp * sign * tex_img)[..., None]

    imgs = np.clip(imgs * 255.0, 0, 255).astype(np.uint8)
    feats = _features(labels, rng, num_features, n_info, feat_sep,
                      feat_noise, class_seed)
    perm = rng.permutation(n)
    return imgs[perm], feats[perm], labels[perm]


def make_replay_temporal(per_class: int = 64, image_size: int = 224,
                         seq_len: int = 5, seed: int = 0, *,
                         num_features: int = 47, bg_noise: float = 0.16,
                         amp_hi: float = 0.45, amp_pow: float = 1.5,
                         cell_fine: int = 4, cell_coarse: int = 13,
                         dy_frac: float = 0.09, n_info: int = 4,
                         feat_sep: float = 1.55, feat_noise: float = 1.0,
                         frame_jitter: float = 0.25, class_seed: int = 77):
    """Returns (image_seqs uint8 (N,T,H,W,3), feature_seqs f32 (N,T,F),
    labels i32). Class = 2*(2*dir + tex) + b; dir ∈ {up, down}."""
    rng = np.random.default_rng(seed)
    h = image_size
    n = NUM_CLASSES * per_class
    labels = np.repeat(np.arange(NUM_CLASSES), per_class).astype(np.int32)
    patch = h // 4
    boards = {0: _board(patch, cell_fine), 1: _board(patch, cell_coarse)}
    # vertical band the patch CENTER wraps inside: every frame's
    # marginal position is uniform for both directions (no leak)
    band_lo, band_hi = int(0.25 * h), int(0.75 * h)
    band = band_hi - band_lo
    dy = int(dy_frac * h)

    seqs = rng.normal(0.5, bg_noise,
                      (n, seq_len, h, h, 1)).astype(np.float32)
    seqs = np.repeat(seqs, 3, axis=-1)
    for i, c in enumerate(labels):
        q = c // 2
        direction, tex = q // 2, q % 2          # 0 = up (y decreases)
        amp = amp_hi * rng.random() ** amp_pow
        sign = 1.0 if rng.random() < 0.5 else -1.0
        cell = cell_fine if tex == 0 else cell_coarse
        roll = int(rng.integers(0, 2 * cell))
        tex_img = np.roll(np.roll(boards[tex], roll, 0),
                          roll, 1) * sign * amp
        y0 = int(rng.integers(0, band))
        cx = int(rng.uniform(0.18, 0.82) * h)
        step = -dy if direction == 0 else dy
        for t in range(seq_len):
            cy = band_lo + (y0 + step * t) % band
            yy, xx = cy - patch // 2, cx - patch // 2
            seqs[i, t, yy:yy + patch, xx:xx + patch, :] += \
                tex_img[..., None]

    seqs = np.clip(seqs * 255.0, 0, 255).astype(np.uint8)
    base = _features(labels, rng, num_features, n_info, feat_sep,
                     feat_noise, class_seed)
    # window-level bit noise + small per-frame jitter: T frames must
    # NOT average the bit ambiguity away
    feat_seq = (base[:, None, :] + frame_jitter * rng.standard_normal(
        (n, seq_len, num_features)).astype(np.float32))
    perm = rng.permutation(n)
    return seqs[perm], feat_seq[perm].astype(np.float32), labels[perm]
