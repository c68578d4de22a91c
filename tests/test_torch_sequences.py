"""The port's sequence (temporal) data path and serving against the JAX
package, on a temporary window tree written from ``make_replay_temporal``:

- the window writer gives the layout and arrays of
  ``scripts/make_replay_disk.py``'s temporal writer;
- ``SequenceDataSource``: the same class map, file order, train batches
  (epoch order) and eval batches (tail padding), windows padded or
  truncated to ``seq_len`` alike;
- sequence packs: one written by either package is read by the other,
  with identical arrays and metadata; resume and the kind/seq_len checks;
- ``sequence_device_transform`` with and without the per-class
  standardisation (1e-6);
- ``Predictor`` and ``PredictionServer`` on temporal inputs against JAX's
  (uint8 and f32 wires, chunks with a padded tail).
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surya_tpu.core.config import DataConfig as JDataConfig
from surya_tpu.core.config import ModelConfig as JaxModelConfig
from surya_tpu.data.packed import PackedSequenceSource as JPackedSeq
from surya_tpu.data.packed import pack_sequences as j_pack_sequences
from surya_tpu.data.sequences import SequenceDataSource as JSeq
from surya_tpu.infer.http_server import PredictionServer as JaxServer
from surya_tpu.infer.serve import Predictor as JaxPredictor
from surya_tpu.models import get_model as jax_get_model
from surya_tpu_torch.core.config import DataConfig, ModelConfig
from surya_tpu_torch.data.imputation import compute_class_stats
from surya_tpu_torch.data.packed import (
    PackedDataSource,
    PackedSequenceSource,
    pack_sequences,
)
from surya_tpu_torch.data.replay import make_replay_temporal
from surya_tpu_torch.data.sequences import (
    SequenceDataSource,
    sequence_device_transform,
    write_windows,
)
from surya_tpu_torch.features import FEATURE_NAMES_47
from surya_tpu_torch.infer.http_server import PredictionServer
from surya_tpu_torch.infer.serve import Predictor
from surya_tpu_torch.models.from_jax import from_jax_variables
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

NAMES = [f"pose_{i}" for i in range(8)]


def _eq(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def seq_root(tmp_path_factory):
    """Windows of T = 5 (train), 3 (valid: padded) and 6 (test: truncated)
    at 16 px, with per-class feature stats of the train split."""
    root = str(tmp_path_factory.mktemp("seq"))
    splits = {s: make_replay_temporal(per_class=pc, image_size=16,
                                      seq_len=t, seed=2000 + i)
              for i, (s, pc, t) in enumerate((("train", 2, 5),
                                              ("valid", 1, 3),
                                              ("test", 1, 6)))}
    write_windows(root, splits, NAMES)
    _, feats, labels = splits["train"]
    tables = compute_class_stats(feats.reshape(-1, 47),
                                 np.repeat(labels, 5), 8)
    for name, table in zip(("class_feature_means.json",
                            "class_feature_stds.json"), tables):
        with open(os.path.join(root, name), "w") as f:
            json.dump({c: dict(zip(FEATURE_NAMES_47, map(float, row)))
                       for c, row in zip(NAMES, table)}, f)
    return root


def test_window_writer_matches_make_replay_disk(tmp_path):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    try:
        from make_replay_disk import SPLIT_SEEDS, write_temporal
    finally:
        sys.path.pop(0)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    write_temporal(a, per_class=8, image_size=16, seq_len=2)
    write_windows(b, {s: make_replay_temporal(
        per_class=8, image_size=16, seq_len=2, seed=2000 + off)
        for s, off in SPLIT_SEEDS.items()}, NAMES)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert len(files) == 1 + 3 * 64
    for name in files:
        if name.endswith(".npz"):
            with np.load(os.path.join(a, name)) as za, \
                    np.load(os.path.join(b, name)) as zb:
                assert za.files == zb.files
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype
                    np.testing.assert_array_equal(za[k], zb[k])
        else:
            with open(os.path.join(a, name)) as f, \
                    open(os.path.join(b, name)) as g:
                assert json.load(f) == json.load(g)


@pytest.mark.parametrize("seq_len,bs,pad_to", [(5, 4, 1), (4, 3, 4)])
def test_sequence_source_batches_are_identical(seq_root, seq_len, bs,
                                               pad_to):
    kw = dict(seq_root=seq_root, seq_len=seq_len, batch_size=bs)
    port = SequenceDataSource(DataConfig(**kw), seed=3, pad_eval_to=pad_to)
    ref = JSeq(JDataConfig(**kw), seed=3, pad_eval_to=pad_to)
    assert port.class_names == ref.class_names == NAMES
    assert port.index == ref.index and len(port.index["train"]) == 16
    for epoch in (1, 2):
        for a, b in zip(port.train_batches(epoch), ref.train_batches(epoch),
                        strict=True):
            assert a[0].shape == (bs, seq_len, 16, 16, 3)
            _eq(a, b)
    for split in ("valid", "test"):
        for a, b in zip(port.eval_batches(split), ref.eval_batches(split),
                        strict=True):
            _eq(a, b)
    with pytest.raises(KeyError):
        port.eval_batches("nope")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sequence_packs_are_read_by_the_other_package(seq_root, tmp_path,
                                                      writer):
    pdir = str(tmp_path / "pack")
    pack = j_pack_sequences if writer == "jax" else pack_sequences
    meta = pack(seq_root, pdir, seq_len=4, verbose=False)
    assert meta["kind"] == "sequences" and meta["seq_len"] == 4
    assert {s: v["count"] for s, v in meta["splits"].items()} == {
        "train": 16, "valid": 8, "test": 8}
    kw = dict(seq_root=seq_root, seq_len=4, batch_size=3,
              standardize_features=True)
    port = PackedSequenceSource(DataConfig(**kw), packed_dir=pdir, seed=1,
                                pad_eval_to=2)
    ref = JPackedSeq(JDataConfig(**kw), packed_dir=pdir, seed=1,
                     pad_eval_to=2)
    live = JSeq(JDataConfig(**kw), seed=1, pad_eval_to=2)
    assert port.class_names == ref.class_names == NAMES
    assert port.stats is not None
    for a, b, c in zip(port.train_batches(2), ref.train_batches(2),
                       live.train_batches(2), strict=True):
        _eq(a, b)
        _eq(a, c)       # packed batches = the live loader's
    for split in ("valid", "test"):
        for a, b in zip(port.eval_batches(split), ref.eval_batches(split),
                        strict=True):
            _eq(a, b)
    batch = next(iter(port.eval_batches("test")))
    got = port.device_transform("test", None, batch)
    want = ref.device_transform("test", None, batch)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_sequence_packs_of_both_packages_are_identical(seq_root, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    j_pack_sequences(seq_root, a, seq_len=5, verbose=False)
    pack_sequences(seq_root, b, seq_len=5, verbose=False)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name.endswith(".npy"):
            x, y = np.load(os.path.join(a, name)), np.load(
                os.path.join(b, name))
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            with open(os.path.join(a, name)) as f, \
                    open(os.path.join(b, name)) as g:
                assert json.load(f) == json.load(g)


def test_sequence_pack_resume_and_checks(seq_root, tmp_path, capsys):
    pdir = str(tmp_path / "pack")
    pack_sequences(seq_root, pdir, seq_len=4)
    pack_sequences(seq_root, pdir, seq_len=4)
    assert "already packed, skipping" in capsys.readouterr().out
    with pytest.raises(ValueError, match="seq_len"):
        pack_sequences(seq_root, pdir, seq_len=5)
    with pytest.raises(ValueError, match="seq_len=4, config wants 5"):
        PackedSequenceSource(DataConfig(seq_root=seq_root, seq_len=5),
                             packed_dir=pdir)
    with pytest.raises(ValueError, match="built from"):
        PackedSequenceSource(DataConfig(seq_root=str(tmp_path), seq_len=4),
                             packed_dir=pdir)
    with pytest.raises(ValueError, match="use PackedSequenceSource"):
        PackedDataSource(DataConfig(), packed_dir=pdir)
    built = str(tmp_path / "built")   # a missing pack is built on first use
    src = PackedSequenceSource(DataConfig(seq_root=seq_root, seq_len=4,
                                          batch_size=8), packed_dir=built)
    assert len(list(src.train_batches(0))) == 2
    with pytest.raises(FileNotFoundError):
        PackedSequenceSource(DataConfig(seq_len=4),
                             packed_dir=str(tmp_path / "none"), build=False)


@pytest.mark.parametrize("standardize", [False, True])
def test_sequence_device_transform_matches_jax(seq_root, standardize):
    kw = dict(seq_root=seq_root, seq_len=5, batch_size=5,
              standardize_features=standardize)
    port = SequenceDataSource(DataConfig(**kw))
    ref = JSeq(JDataConfig(**kw))
    assert (port.stats is not None) == standardize
    images, feats, labels = next(iter(port.eval_batches("train")))
    feats = feats.copy()
    feats[0, 1, 3] = feats[2, 4, 0] = np.nan
    batch = (images, feats, labels)
    got = port.device_transform("train", None, batch)
    want = ref.device_transform("train", None, batch)
    assert got[0].dtype == torch.float32 and got[0].shape == images.shape
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert torch.isfinite(got[1]).all()
    # the same function without a source around it
    again = sequence_device_transform(port.cfg, port.stats, "train", None,
                                      batch)
    _eq(again, got)


@pytest.fixture(scope="module")
def predictors():
    """ji_3dcnn at 32 px, T = 3, on random weights: JAX's and the port's
    Predictor at batch 4, for the uint8 and the f32 wire."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (6, 3, 32, 32, 3), dtype=np.uint8)
    feats = rng.normal(size=(6, 3, 47)).astype(np.float32)
    kw = dict(name="ji_3dcnn", num_classes=5, compute_dtype="float32",
              seq_len=3)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    variables = numpy_variables(jax_get_model(jcfg), jnp.asarray(raw / 255.),
                                jnp.asarray(feats), seed=2)
    sd = from_jax_variables(variables)
    out = {}
    for wire, jwire in (("uint8", jnp.uint8), ("float32", jnp.float32)):
        out[wire] = (JaxPredictor(jcfg, variables, batch_size=4,
                                  image_size=32, input_dtype=jwire),
                     Predictor(cfg, sd, batch_size=4, image_size=32,
                               input_dtype=wire, device="cpu"))
    return out, raw, feats


@pytest.mark.parametrize("wire,n", [("uint8", 6), ("uint8", 3),
                                    ("float32", 6)])
def test_predictor_on_clips_matches_jax(predictors, wire, n):
    pairs, raw, feats = predictors
    ref, port = pairs[wire]
    images = raw[:n] if wire == "uint8" else raw[:n] / np.float32(255)
    want_p, want = ref.predict(images, feats[:n])
    got_p, got = port.predict(images, feats[:n])
    assert got.shape == (n, 5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got_p, np.asarray(want_p))


def test_server_answers_a_sequence_npz_like_jax(predictors):
    pairs, raw, feats = predictors
    buf = io.BytesIO()
    np.savez(buf, images=raw[:5], features=feats[:5])
    body = buf.getvalue()
    got = PredictionServer(pairs["uint8"][1], NAMES[:5]).handle_bytes(
        body, "application/x-npz")
    want = JaxServer(pairs["uint8"][0], NAMES[:5]).handle_bytes(
        body, "application/x-npz")
    assert got["n"] == want["n"] == 5
    assert got["predictions"] == want["predictions"]
    assert got["labels"] == want["labels"]
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               atol=2e-6)
