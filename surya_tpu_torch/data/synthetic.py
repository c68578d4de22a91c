"""Synthetic multimodal datasets for tests and benchmarks, a numpy copy
of ``surya_tpu/data/synthetic.py``: the same seed gives the same arrays.

Class-separable (image, 47-feature, label) samples: each class gets a
distinct spatial frequency pattern in the image and a distinct mean
vector in feature space, with additive noise.
"""

from __future__ import annotations

import numpy as np


def make_synthetic_spatial(num_classes: int = 8, per_class: int = 16,
                           image_size: int = 64, num_features: int = 47,
                           seed: int = 0, noise: float = 0.1,
                           class_seed: int = 1234):
    """Returns (images NHWC f32, features f32, labels i32).

    ``class_seed`` fixes the class-conditional signal (feature centers)
    so different ``seed`` values draw fresh samples from the SAME
    distribution — train/valid/test splits stay consistent.
    """
    rng = np.random.default_rng(seed)
    n = num_classes * per_class
    labels = np.repeat(np.arange(num_classes), per_class).astype(np.int32)

    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    yy /= image_size
    xx /= image_size
    images = np.empty((n, image_size, image_size, 3), np.float32)
    for i, c in enumerate(labels):
        freq = 1.0 + c
        phase = rng.uniform(0, 2 * np.pi)
        pattern = np.sin(2 * np.pi * freq * xx + phase) * np.cos(
            2 * np.pi * freq * yy)
        img = np.stack([pattern, -pattern, pattern * 0.5], axis=-1)
        images[i] = img + rng.normal(0, noise, img.shape)

    centers = np.random.default_rng(class_seed).normal(
        0, 1.0, (num_classes, num_features)).astype(np.float32)
    features = centers[labels] + rng.normal(
        0, noise, (n, num_features)).astype(np.float32)

    perm = rng.permutation(n)
    return images[perm], features[perm], labels[perm]


def make_synthetic_capability(per_class: int = 16, image_size: int = 96,
                              num_features: int = 47, seed: int = 0,
                              image_noise: float = 0.8,
                              feat_noise: float = 0.75,
                              class_seed: int = 1234):
    """Capability-discrimination set: 8 classes = quadrant × numeric bit.

    Designed so quadrant locality and the numeric modality each carry a
    DISJOINT part of the label (the structure behind the reference's
    published ordering, ``README.md:140-143`` — fusion > image_only >
    numerical_only, QuadtreeCNN > GAP-pooled standard backbones):

    - class c = 2*q + b with q ∈ {0..3}, b ∈ {0,1};
    - the IMAGE carries only q: an identical checkerboard patch (random
      per-sample phase/contrast sign so texture identity leaks nothing)
      is centered in quadrant q, fully interior to it — a
      translation-equivariant trunk + global average pooling is blind
      to WHERE the patch is, while quadrant-split features are not;
    - the 47-FEATURE vector carries only b: two fixed class centers
      plus noise.

    Ceilings: numerical_only ≈ 2/8 resolved (~25% + margin noise),
    image_only ≈ 4/8 (~50%), fusion ≈ 100%; GAP-pooled models lose q.
    Returns (images NHWC f32, features f32, labels i32).
    """
    rng = np.random.default_rng(seed)
    num_classes = 8
    n = num_classes * per_class
    labels = np.repeat(np.arange(num_classes), per_class).astype(np.int32)

    h = image_size
    patch = h // 4                      # patch side, centered in quadrant
    cell = max(patch // 6, 1)           # checkerboard cell
    py, px = np.mgrid[0:patch, 0:patch]
    board = (((py // cell) + (px // cell)) % 2).astype(np.float32) * 2 - 1

    images = rng.normal(0.0, image_noise,
                        (n, h, h, 3)).astype(np.float32)
    for i, c in enumerate(labels):
        q = c // 2
        qy, qx = divmod(q, 2)
        cy = qy * (h // 2) + h // 4 - patch // 2
        cx = qx * (h // 2) + h // 4 - patch // 2
        sign = 1.0 if rng.random() < 0.5 else -1.0   # contrast sign
        roll = rng.integers(0, 2 * cell)             # phase
        tex = np.roll(np.roll(board, roll, 0), roll, 1) * sign
        images[i, cy:cy + patch, cx:cx + patch, :] += tex[..., None]

    centers = np.random.default_rng(class_seed).normal(
        0, 1.0, (2, num_features)).astype(np.float32)
    bits = labels % 2
    features = centers[bits] + rng.normal(
        0, feat_noise, (n, num_features)).astype(np.float32)

    perm = rng.permutation(n)
    return images[perm], features[perm], labels[perm]


def make_synthetic_temporal(num_classes: int = 8, per_class: int = 8,
                            seq_len: int = 4, image_size: int = 64,
                            num_features: int = 47, seed: int = 0,
                            noise: float = 0.1):
    """Returns (image_seqs (N,T,H,W,3), feature_seqs (N,T,F), labels)."""
    images, features, labels = make_synthetic_spatial(
        num_classes, per_class, image_size, num_features, seed, noise)
    rng = np.random.default_rng(seed + 1)
    img_seq = np.repeat(images[:, None], seq_len, axis=1)
    feat_seq = np.repeat(features[:, None], seq_len, axis=1)
    # small per-frame jitter so time steps differ; f32 draws directly —
    # a float64 rng.normal temp would double peak memory of the
    # largest allocation on this 1-core host
    img_seq += (noise / 2) * rng.standard_normal(img_seq.shape,
                                                 dtype=np.float32)
    feat_seq += (noise / 2) * rng.standard_normal(feat_seq.shape,
                                                  dtype=np.float32)
    return img_seq.astype(np.float32), feat_seq.astype(np.float32), labels
