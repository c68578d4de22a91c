"""The port's input pipeline (``surya_tpu_torch/data``, ``native``) against
``surya_tpu/data`` on the CPU.

- batching orders, eval padding, ``ArrayDataSource`` batches and the
  synthetic arrays: identical;
- imputation and standardization: to 1e-6 absolute;
- ``DiskDataSource`` on the ``disk_dataset`` fixture: the same scanned
  paths, labels and host batches, and the same eval batches after
  ``device_transform`` to 1e-5 absolute (PIL decode on both sides; the
  256-px staging size resized to 224, the real path);
- packs: one written by either package is read by the other, with
  identical bytes;
- the native decoder's ctypes wrapper against the JAX package's (the same
  C++ source): identical pixels, skipped without g++/libjpeg.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surya_tpu.core.config import DataConfig as JDataConfig
from surya_tpu.data import batching as jb
from surya_tpu.data import pipeline as jp
from surya_tpu.data import synthetic as js
from surya_tpu.data.dataset import DiskDataSource as JDisk
from surya_tpu.data.imputation import ClassFeatureStats as JStats
from surya_tpu.data.imputation import compute_class_stats as j_class_stats
from surya_tpu.data.packed import PackedDataSource as JPacked
from surya_tpu.data.packed import pack_dataset as j_pack
from surya_tpu_torch.core.config import DataConfig
from surya_tpu_torch.data import batching as tb
from surya_tpu_torch.data import pipeline as tp
from surya_tpu_torch.data import synthetic as ts
from surya_tpu_torch.data.dataset import DiskDataSource
from surya_tpu_torch.data.imputation import ClassFeatureStats
from surya_tpu_torch.data.imputation import compute_class_stats
from surya_tpu_torch.data.packed import (
    PackedDataSource,
    PackedSequenceSource,
    pack_arrays,
    pack_dataset,
    pack_sequences,
    split_paths,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401


def _eq(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("n,bs", [(24, 8), (25, 8), (5, 8), (8, 8), (0, 4)])
def test_epoch_order_is_identical(n, bs):
    for epoch in range(3):
        np.testing.assert_array_equal(tb.epoch_order(n, bs, 42, epoch),
                                      jb.epoch_order(n, bs, 42, epoch))


@pytest.mark.parametrize("n,pad_to", [(5, 4), (8, 4), (3, 1)])
def test_pad_batch_is_identical(n, pad_to):
    rng = np.random.default_rng(n)
    batch = (rng.normal(size=(n, 4, 4, 3)).astype(np.float32),
             rng.normal(size=(n, 47)).astype(np.float32),
             rng.integers(0, 3, n).astype(np.int32))
    got = tb.pad_batch(batch, pad_to)
    _eq(got, jb.pad_batch(batch, pad_to))
    assert len(got[2]) % pad_to == 0
    _eq(next(iter(tb.pad_eval_iter(iter([batch]), pad_to))),
        next(iter(jb.pad_eval_iter(iter([batch]), pad_to))))


@pytest.mark.parametrize("kw", [{}, {"drop_last_train": False},
                                {"pad_eval_to": 4}])
def test_array_source_batches_are_identical(kw):
    splits = {s: js.make_synthetic_spatial(num_classes=3, per_class=5,
                                           image_size=8, seed=i)
              for i, s in enumerate(("train", "valid"))}
    port = tp.ArrayDataSource(splits, 4, seed=3, **kw)
    ref = jp.ArrayDataSource(splits, 4, seed=3, **kw)
    assert port.num_classes == ref.num_classes == 3
    for epoch in (0, 1):
        for a, b in zip(port.train_batches(epoch), ref.train_batches(epoch),
                        strict=True):
            _eq(a, b)
    for a, b in zip(port.eval_batches("valid"), ref.eval_batches("valid"),
                    strict=True):
        _eq(a, b)
    with pytest.raises(KeyError):
        port.eval_batches("test")


def test_synthetic_arrays_are_identical():
    _eq(ts.make_synthetic_spatial(num_classes=4, per_class=3, image_size=16,
                                  seed=5),
        js.make_synthetic_spatial(num_classes=4, per_class=3, image_size=16,
                                  seed=5))
    _eq(ts.make_synthetic_capability(per_class=2, image_size=24, seed=1),
        js.make_synthetic_capability(per_class=2, image_size=24, seed=1))
    _eq(ts.make_synthetic_temporal(num_classes=2, per_class=2, seq_len=3,
                                   image_size=8, seed=2),
        js.make_synthetic_temporal(num_classes=2, per_class=2, seq_len=3,
                                   image_size=8, seed=2))


def _stats(c=3, f=47, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(c, f)).astype(np.float32)
    stds = rng.uniform(0.5, 2.0, (c, f)).astype(np.float32)
    stds[1, 3] = 1e-7                       # standardizes to 0
    feats = rng.normal(size=(9, f)).astype(np.float32)
    feats[rng.random(feats.shape) < 0.2] = np.nan
    labels = rng.integers(0, c, 9).astype(np.int32)
    labels[:3] = [0, 1, 2]
    return means, stds, feats, labels


def test_imputation_and_standardization_match_jax():
    means, stds, feats, labels = _stats()
    means[2, 5] = np.nan                    # unseen stat → 0 after impute
    names = ["a", "b", "c"]
    port = ClassFeatureStats(means, stds, names)
    ref = JStats(means, stds, names)
    for got, want in (
            (port.impute(torch.from_numpy(feats), torch.from_numpy(labels)),
             ref.impute(jnp.asarray(feats), jnp.asarray(labels))),
            (port.standardize(torch.from_numpy(feats),
                              torch.from_numpy(labels)),
             ref.standardize(jnp.asarray(feats), jnp.asarray(labels)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    assert torch.isfinite(port.impute(torch.from_numpy(feats),
                                      torch.from_numpy(labels))).all()
    with pytest.raises(ValueError, match="no stds"):
        ClassFeatureStats(means, None, names).standardize(
            torch.from_numpy(feats), torch.from_numpy(labels))


def test_stats_from_json_and_alignment_match_jax(tmp_path):
    from surya_tpu.features import FEATURE_NAMES_47
    from surya_tpu_torch.features import FEATURE_NAMES_47 as PORT_NAMES

    assert PORT_NAMES == FEATURE_NAMES_47
    rng = np.random.default_rng(1)
    raw = {c: {n: float(rng.normal()) for n in FEATURE_NAMES_47[::2]}
           for c in ("plank", "cobra", "tree")}
    means = tmp_path / "m.json"
    means.write_text(json.dumps(raw))
    stds = tmp_path / "s.json"
    stds.write_text(json.dumps(raw))
    port = ClassFeatureStats.from_json(str(means), str(stds))
    ref = JStats.from_json(str(means), str(stds))
    assert port.class_names == ref.class_names == ["cobra", "plank", "tree"]
    np.testing.assert_array_equal(port.means.numpy(), np.asarray(ref.means))
    order = ["tree", "cobra", "plank"]
    np.testing.assert_array_equal(port.aligned_to(order).stds.numpy(),
                                  np.asarray(ref.aligned_to(order).stds))
    assert port.aligned_to(port.class_names) is port
    with pytest.raises(ValueError, match="missing"):
        port.aligned_to(["cobra", "lotus"])


def test_compute_class_stats_is_identical():
    _, _, feats, labels = _stats(seed=2)
    _eq(compute_class_stats(feats, labels, 4),
        j_class_stats(feats, labels, 4))


def _sources(root, **kw):
    port = DiskDataSource(DataConfig(data_root=root, batch_size=4, **kw),
                          use_native=False)
    ref = JDisk(JDataConfig(data_root=root, batch_size=4, **kw),
                use_native=False)
    return port, ref


def test_disk_source_scan_and_host_batches_match_jax(disk_dataset):
    port, ref = _sources(disk_dataset)
    assert port.class_names == ref.class_names == ["cobra", "plank"]
    for split in ("train", "valid", "test"):
        p, r = port.index[split], ref.index[split]
        assert p[0] == r[0] and p[1] == r[1] and p[3] == r[3]
        np.testing.assert_array_equal(p[2], r[2])
    for a, b in zip(port.train_batches(2), ref.train_batches(2),
                    strict=True):
        _eq(a, b)
    np.testing.assert_array_equal(port.stats.means.numpy(),
                                  np.asarray(ref.stats.means))


def test_disk_source_eval_transform_matches_jax(disk_dataset):
    """uint8 → f32/255 → antialiased 256 → 224 resize → normalise, and the
    per-class imputation of the NaN feature, to 1e-5."""
    port, ref = _sources(disk_dataset)
    n = 0
    for pb, rb in zip(port.eval_batches("valid"), ref.eval_batches("valid"),
                      strict=True):
        assert pb[0].shape[1:] == (256, 256, 3) and pb[0].dtype == np.uint8
        got = port.device_transform("valid", None, pb)
        want = ref.device_transform("valid", None, rb)
        assert got[0].shape == (len(pb[2]), 224, 224, 3)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)
        n += int(np.isnan(pb[1]).any())
    assert n > 0                   # a NaN feature was imputed


def test_disk_source_train_transform_augments(disk_dataset):
    port, _ = _sources(disk_dataset, image_size=32)
    batch = next(iter(port.train_batches(0)))
    a = port.device_transform("train", torch.Generator().manual_seed(0),
                              batch)
    b = port.device_transform("train", torch.Generator().manual_seed(1),
                              batch)
    assert a[0].shape == (4, 32, 32, 3) and torch.isfinite(a[1]).all()
    assert not torch.allclose(a[0], b[0])
    # no generator: eval preprocessing even on the train split
    c = port.device_transform("train", None, batch)
    d = port.device_transform("valid", None, batch)
    assert torch.equal(c[0], d[0])


def test_disk_source_rejects_misaligned_classes(disk_dataset):
    import shutil

    shutil.rmtree(os.path.join(disk_dataset, "test", "cobra"))
    with pytest.raises(ValueError, match="class dirs"):
        DiskDataSource(DataConfig(data_root=disk_dataset), use_native=False)


def test_disk_loader_surfaces_worker_errors(disk_dataset):
    port, _ = _sources(disk_dataset)
    with open(port.index["train"][1][0], "wb") as f:
        f.write(b"not-a-npy")
    with pytest.raises(Exception):
        for _ in port._batches("train", np.arange(4), 4):
            pass


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packs_are_read_by_the_other_package(disk_dataset, tmp_path, writer):
    pdir = str(tmp_path / "pack")
    pack = j_pack if writer == "jax" else pack_dataset
    meta = pack(disk_dataset, pdir, staging=48, use_native=False,
                verbose=False)
    assert meta["format_version"] == 1 and meta["kind"] == "flat"
    assert meta["splits"]["train"]["count"] == 12
    port = PackedDataSource(DataConfig(data_root=disk_dataset, batch_size=4,
                                       image_size=32), packed_dir=pdir)
    ref = JPacked(JDataConfig(data_root=disk_dataset, batch_size=4,
                              image_size=32), packed_dir=pdir)
    assert port.class_names == ref.class_names and port.staging == 48
    for split in ("train", "valid", "test"):
        idx = np.arange(len(ref.index[split][2]))
        _eq(port._load_batch(split, idx), ref._load_batch(split, idx))
    for a, b in zip(port.train_batches(1), ref.train_batches(1),
                    strict=True):
        _eq(a, b)
    assert port.stats is not None


def test_packs_of_both_packages_are_byte_identical(disk_dataset, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    j_pack(disk_dataset, a, staging=40, use_native=False, verbose=False)
    pack_dataset(disk_dataset, b, staging=40, use_native=False, verbose=False)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(a, name)),
                                          np.load(os.path.join(b, name)))
    with open(os.path.join(a, "packed_meta.json")) as f, \
            open(os.path.join(b, "packed_meta.json")) as g:
        assert json.load(f) == json.load(g)


def test_pack_resume_and_root_check(disk_dataset, tmp_path, capsys):
    pdir = str(tmp_path / "pack")
    pack_dataset(disk_dataset, pdir, staging=32, use_native=False)
    pack_dataset(disk_dataset, pdir, staging=32, use_native=False)
    assert "already packed, skipping" in capsys.readouterr().out
    with pytest.raises(ValueError, match="staging"):
        pack_dataset(disk_dataset, pdir, staging=40, use_native=False)
    with pytest.raises(ValueError, match="built from"):
        PackedDataSource(DataConfig(data_root=str(tmp_path)),
                         packed_dir=pdir)
    with pytest.raises(FileNotFoundError):
        PackedDataSource(DataConfig(), packed_dir=str(tmp_path / "none"),
                         build=False)


def test_pack_arrays_writes_what_pack_dataset_writes(disk_dataset, tmp_path):
    """One writer behind both: the arrays a decoded pack holds, packed
    again from memory, give the same files and the same metadata (but the
    source root, which an in-memory pack has not)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    meta = pack_dataset(disk_dataset, a, staging=40, use_native=False,
                        verbose=False)
    src = PackedDataSource(DataConfig(data_root=disk_dataset), packed_dir=a)
    splits = {s: src._load_batch(s, np.arange(len(src.index[s][2])))
              for s in meta["splits"]}
    again = pack_arrays(b, splits, src.class_names)
    assert again == {**meta, "source_root": ""}
    for split in splits:
        for name in ("images", "features", "labels"):
            with open(split_paths(a, split)[name], "rb") as f, \
                    open(split_paths(b, split)[name], "rb") as g:
                assert f.read() == g.read(), (split, name)


def test_sources_pin_only_when_asked(disk_dataset, tmp_path):
    """Host batches stay numpy unless the caller, which knows the batches
    go to a card, asks for pinned memory."""
    port, _ = _sources(disk_dataset)
    pdir = str(tmp_path / "pack")
    pack_dataset(disk_dataset, pdir, staging=40, use_native=False,
                 verbose=False)
    packed = PackedDataSource(DataConfig(data_root=disk_dataset,
                                         batch_size=4), packed_dir=pdir)
    for src in (port, packed):
        assert src.pin_memory is False
        batch = next(iter(src.train_batches(0)))
        assert all(isinstance(x, np.ndarray) for x in batch)
    assert PackedDataSource(DataConfig(data_root=disk_dataset),
                            packed_dir=pdir, pin_memory=True).pin_memory


def test_pack_arrays_round_trip(tmp_path):
    """In-memory uint8 splits in the pack layout, read by both packages,
    with the train split's per-class stats beside them."""
    rng = np.random.default_rng(0)
    splits = {s: (rng.integers(0, 256, (n, 40, 40, 3), dtype=np.uint8),
                  rng.normal(size=(n, 47)).astype(np.float32),
                  np.arange(n, dtype=np.int32) % 2)
              for s, n in (("train", 6), ("valid", 3))}
    splits["train"][1][0, 4] = np.nan
    pdir = str(tmp_path / "pack")
    meta = pack_arrays(pdir, splits, ["a", "b"])
    assert meta["staging"] == 40 and meta["splits"]["valid"]["count"] == 3
    port = PackedDataSource(DataConfig(batch_size=2), packed_dir=pdir)
    ref = JPacked(JDataConfig(batch_size=2), packed_dir=pdir)
    for split, arrays in splits.items():
        idx = np.arange(len(arrays[2]))
        _eq(port._load_batch(split, idx), arrays)
        _eq(ref._load_batch(split, idx), arrays)
    means, stds = compute_class_stats(splits["train"][1], splits["train"][2],
                                      2)
    np.testing.assert_allclose(port.stats.means.numpy(), means, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.stats.stds), stds, rtol=1e-6)
    with pytest.raises(ValueError, match="uint8"):
        pack_arrays(pdir, {"train": (splits["train"][0].astype(np.float32),
                                     *splits["train"][1:])}, ["a", "b"])


def test_sequence_packs_wait_for_a9(tmp_path):
    """Sequence packs are ported (ROADMAP A9a; ``tests/
    test_torch_sequences.py`` holds them to JAX's): a dataset without a
    class map, or a source without a pack directory, is refused as JAX
    refuses it."""
    with pytest.raises(FileNotFoundError, match="class_to_idx"):
        pack_sequences(str(tmp_path), str(tmp_path / "p"))
    with pytest.raises(ValueError, match="needs packed_dir"):
        PackedSequenceSource(DataConfig())


def test_native_decoder_matches_jax_wrapper(tmp_path):
    from PIL import Image

    from surya_tpu import native as jnative
    from surya_tpu_torch import native

    if not native.available():
        pytest.skip("the native decoder did not build (needs g++ and "
                    "libjpeg)")
    assert str(native._so_path()).startswith(str(native.BUILD_DIR))
    assert not (native.SRC.parent / "libsurya_decode.so").exists()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"i{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (40, 60, 3),
                                     np.uint8)).save(p, quality=95)
        paths.append(p)
    paths.append(str(tmp_path / "missing.jpg"))
    out, ok = native.decode_batch(paths, 32)
    assert out.shape == (4, 32, 32, 3) and ok == 3 and out[-1].sum() == 0
    if jnative.available():
        ref, ref_ok = jnative.decode_batch(paths, 32)
        assert ref_ok == ok
        np.testing.assert_array_equal(out, ref)
