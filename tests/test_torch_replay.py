"""The port's copy of the reference-replay generators
(``surya_tpu_torch/data/replay.py``) against the JAX package's: the same
arrays, bit for bit, for the same arguments, and the same Bayes error."""

import numpy as np
import pytest

from surya_tpu.data import replay as jr
from surya_tpu_torch.data import replay as tr


def _eq(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(per_class=2, image_size=32, seed=0),
    dict(per_class=3, image_size=48, seed=1001, amp_pow=0.5),
    dict(per_class=1, image_size=64, seed=7, num_features=12, n_info=3,
         feat_sep=2.0, cell_fine=2, cell_coarse=5)])
def test_make_replay_spatial_is_identical(kw):
    _eq(tr.make_replay_spatial(**kw), jr.make_replay_spatial(**kw))


@pytest.mark.parametrize("kw", [
    dict(per_class=2, image_size=32, seq_len=5, seed=2000),
    dict(per_class=1, image_size=48, seq_len=4, seed=2002, amp_pow=0.5),
    dict(per_class=2, image_size=32, seq_len=2, seed=3, dy_frac=0.2,
         frame_jitter=0.5, class_seed=5)])
def test_make_replay_temporal_is_identical(kw):
    got = tr.make_replay_temporal(**kw)
    _eq(got, jr.make_replay_temporal(**kw))
    clips, feats, labels = got
    n = tr.NUM_CLASSES * kw["per_class"]
    assert clips.shape == (n, kw["seq_len"], kw["image_size"],
                           kw["image_size"], 3) and clips.dtype == np.uint8
    assert feats.shape == (n, kw["seq_len"], 47)
    assert sorted(np.bincount(labels)) == [kw["per_class"]] * tr.NUM_CLASSES


@pytest.mark.parametrize("args", [(), (4, 1.55, 1.0), (1, 0.5, 2.0),
                                  (8, 3.0, 0.7)])
def test_bayes_bit_error_is_identical(args):
    assert tr.bayes_bit_error(*args) == jr.bayes_bit_error(*args)
