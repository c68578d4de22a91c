"""The port's prep tier (``surya_tpu_torch/data/prep``) against the JAX
package's on the same small trees: frame renaming, the flat layout, the
CSV sequence builder and the video-level split, still-image prep (47 and
443 features), the per-clip extended-feature CSVs, and ``ingest``'s two
converters (through the port's CLI).

File tools must give the same trees byte for byte. Feature outputs (the
``.npy`` files, the class statistics, the feature CSVs) are the port's
tensor math against JAX's: NaN positions equal, values within 1e-5
relative (f32; the CSVs print 6 significant digits, so a value may differ
there by one unit in the 6th digit, 1e-5 relative)."""

import csv
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from surya_tpu.data.prep import frame_renaming as jfr
from surya_tpu.data.prep import ingest as jin
from surya_tpu.data.prep import reorganize as jro
from surya_tpu.data.prep import sequence_csv as jsc
from surya_tpu.data.prep import sequence_features as jsf
from surya_tpu.data.prep import still_image_dataset as jsi
from surya_tpu_torch.__main__ import main as port_main
from surya_tpu_torch.data.prep import frame_renaming as tfr
from surya_tpu_torch.data.prep import reorganize as tro
from surya_tpu_torch.data.prep import sequence_csv as tsc
from surya_tpu_torch.data.prep import sequence_features as tsf
from surya_tpu_torch.data.prep import still_image_dataset as tsi
from torch_port_fixtures import one_torch_thread  # noqa: F401

REL = 1e-5


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def _same_bytes(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        with open(fa[k], "rb") as x, open(fb[k], "rb") as y:
            assert x.read() == y.read(), k


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=REL, atol=REL)


def _same_outputs(a, b):
    """Trees with feature outputs: names equal; .npy, .csv and .json held
    numerically; every other file byte for byte."""
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if k.endswith(".npy"):
            _close(np.load(fa[k]), np.load(fb[k]))
        elif k.endswith(".json"):
            with open(fa[k]) as x, open(fb[k]) as y:
                ja, jb = json.load(x), json.load(y)
            assert ja.keys() == jb.keys()
            for c in ja:
                if isinstance(ja[c], dict):
                    assert list(ja[c]) == list(jb[c])
                    _close(list(ja[c].values()), list(jb[c].values()))
                else:
                    assert ja[c] == jb[c]
        elif k.endswith(".csv"):
            with open(fa[k], newline="") as x, open(fb[k], newline="") as y:
                ra, rb = list(csv.reader(x)), list(csv.reader(y))
            assert ra[0] == rb[0] and len(ra) == len(rb)
            for r1, r2 in zip(ra[1:], rb[1:]):
                assert r1[:3] == r2[:3]
                _close([float(v) for v in r1[3:]],
                       [float(v) for v in r2[3:]])
        else:
            with open(fa[k], "rb") as x, open(fb[k], "rb") as y:
                assert x.read() == y.read(), k


@pytest.fixture
def raw_tree(tmp_path):
    """Two splits × two clips of frames named out of natural order."""
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    for split in ("train", "valid"):
        for clip in ("video_clip_001", "video_clip_002"):
            d = raw / split / clip
            d.mkdir(parents=True)
            for i in (10, 2, 1, 33):
                Image.fromarray(rng.integers(0, 255, (24, 32, 3),
                                             np.uint8)).save(
                    d / f"{clip}src_mp4-{i:05d}_jpg.rf.h{i}.jpg")
            (d / "notes.txt").write_text("not a frame")
    return str(raw)


def test_natural_sort_and_video_id_match_jax():
    names = ["frame10.jpg", "Frame2.jpg", "frame1.jpg", "a11b2", "a11b10"]
    assert (sorted(names, key=tfr.natural_sort_key)
            == sorted(names, key=jfr.natural_sort_key))
    for name in ("yoga_vid_mp4-00123_jpg.rf.abc.jpg", "myvideo.mp4",
                 "clipx.rf.hash.jpg", "plain-name.jpg", "x_mp4-12_a.jpg"):
        assert tfr.extract_video_id(name) == jfr.extract_video_id(name)


def test_rename_frames_matches_jax(raw_tree, tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tfr.rename_frames(raw_tree, a) == jfr.rename_frames(raw_tree, b)
    _same_bytes(a, b)
    clip = os.path.join(a, "train", "video_clip_001")
    assert (tfr.load_frame_map(clip, "video_clip_001")
            == jfr.load_frame_map(clip, "video_clip_001"))


@pytest.mark.parametrize("val_name", ["valid", "val"])
def test_reorganize_to_flat_matches_jax(tmp_path, val_name):
    rng = np.random.default_rng(1)
    seq_root = tmp_path / "seqds"
    for split in ("train", val_name):
        for cls in ("cobra", "plank"):
            for s in range(2):
                d = seq_root / split / cls / f"sequence_{s:05d}" / "images"
                d.mkdir(parents=True)
                for i in range(2):
                    Image.fromarray(rng.integers(0, 255, (8, 8, 3),
                                                 np.uint8)).save(
                        d / f"f{i}.jpg")
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert (tro.reorganize_to_flat(str(seq_root), a)
            == jro.reorganize_to_flat(str(seq_root), b))
    _same_bytes(a, b)


def test_create_dataset_sequences_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    map_rows = []
    for split, clip, n in (("train", "clip_a", 13), ("valid", "clip_b", 11)):
        processed = tmp_path / "processed" / split
        renamed = tmp_path / "renamed" / split / clip
        img_dir = processed / f"{clip}_annotated_images"
        img_dir.mkdir(parents=True)
        renamed.mkdir(parents=True)
        feat_rows, rows = [], []
        for i in range(n):
            new = f"frame_{i + 1:05d}.jpg"
            orig = f"vid{clip}_mp4-{i:05d}_jpg.rf.h{i}.jpg"
            rows.append({"new_filename": new, "original_filename": orig,
                         "clip_name": clip, "split": split})
            feat_rows.append({"clip_id": clip, "frame_index": i,
                              "original_image_filename": new,
                              "f0": rng.normal(),
                              "f1": "" if i == 3 else rng.normal()})
            Image.fromarray(rng.integers(0, 255, (8, 8, 3),
                                         np.uint8)).save(
                img_dir / f"frame_{i + 1:05d}_annotated.jpg")
        for path, data in ((processed / f"{clip}_features.csv", feat_rows),
                           (renamed / f"{clip}_frame_map.csv", rows)):
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(data[0]))
                w.writeheader()
                w.writerows(data)
        map_rows += rows
    labels_csv = tmp_path / "labels.csv"
    with open(labels_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["filename", "label"])
        w.writeheader()
        for i, r in enumerate(map_rows):   # a label change mid-clip
            w.writerow({"filename": r["original_filename"],
                        "label": "cobra" if i % 13 < 8 else "plank"})
    args = (str(tmp_path / "processed"), str(tmp_path / "renamed"),
            [str(labels_csv)])
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert (tsc.create_dataset_sequences(*args, a, seq_len=4)
            == jsc.create_dataset_sequences(*args, b, seq_len=4))
    _same_bytes(a, b)


@pytest.mark.parametrize("seed", [42, 0, 7])
@pytest.mark.parametrize("n_videos", [1, 2, 3, 9])
def test_organize_by_video_matches_jax(seed, n_videos):
    clips = {f"c{i}": f"vid{i % n_videos}" for i in range(12)}
    assert (tsc.organize_by_video(clips, seed=seed)
            == jsc.organize_by_video(clips, seed=seed))


def _fixed_extractor(image_path):
    """Landmarks from a hash of the file name; some frames have no pose,
    some a narrow torso (NaN guards)."""
    name = os.path.basename(image_path)
    seed = int.from_bytes(name.encode()[-12:], "little") % (2 ** 32)
    rng = np.random.default_rng(seed)
    lm = rng.uniform(0.1, 0.9, (33, 4)).astype(np.float32)
    lm[:, 3] = rng.uniform(0.4, 1.0, 33)
    if seed % 5 == 0:
        return np.zeros((33, 4), np.float32), False
    if seed % 5 == 1:
        lm[[11, 12, 23, 24], :3] = 0.5
    return lm, True


def _labels(raw_tree, tmp_path):
    path = tmp_path / "labels.csv"
    names = sorted(n for d, _, ns in os.walk(raw_tree) for n in ns
                   if n.endswith(".jpg"))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["filename", "label"])
        w.writeheader()
        for i, n in enumerate(names):
            w.writerow({"filename": n,
                        "label": ("cobra", "plank", "nan")[i % 3]})
    return [str(path)]


@pytest.mark.parametrize("feature_set", ["47", "extended"])
def test_prepare_still_image_dataset_matches_jax(raw_tree, tmp_path,
                                                 feature_set):
    renamed = str(tmp_path / "renamed")
    jfr.rename_frames(raw_tree, renamed)
    labels = _labels(raw_tree, tmp_path)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    got = tsi.prepare_still_image_dataset(renamed, a, labels,
                                          extractor=_fixed_extractor,
                                          feature_set=feature_set,
                                          device="cpu")
    want = jsi.prepare_still_image_dataset(renamed, b, labels,
                                           extractor=_fixed_extractor,
                                           feature_set=feature_set)
    assert got == want and got["train"] > 0
    _same_outputs(a, b)


def test_process_image_sequences_matches_jax(raw_tree, tmp_path):
    renamed = str(tmp_path / "renamed")
    jfr.rename_frames(raw_tree, renamed)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    for size in (None, (640, 480)):
        got = tsf.process_image_sequences(renamed, a, _fixed_extractor,
                                          image_size=size, device="cpu")
        want = jsf.process_image_sequences(renamed, b, _fixed_extractor,
                                           image_size=size)
        assert got == want
        _same_outputs(a, b)


def _pt_tree(root):
    from surya_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD

    rng = np.random.default_rng(0)
    os.makedirs(root)
    with open(os.path.join(root, "class_to_idx.json"), "w") as f:
        json.dump({"pose_a": 0, "pose_b": 1}, f)
    for split in ("train", "valid"):
        for label, lid in (("pose_a", 0), ("pose_b ", 1)):
            d = os.path.join(root, split, label)
            os.makedirs(d)
            for i in range(2):
                x = rng.integers(0, 256, (3, 16, 16, 3)).astype(
                    np.float32) / 255.0
                x = (x - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
                    IMAGENET_STD, np.float32)
                feats = rng.normal(size=(3, 47)).astype(np.float32)
                feats[0, 5] = np.nan
                torch.save({"image_sequence": torch.from_numpy(
                               np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                            "numerical_sequence": torch.from_numpy(feats),
                            "label": lid, "video_clip": f"clip{lid}",
                            "view_id": "01"},
                           os.path.join(d, f"clip{lid}_view_01_seq_{i}.pt"))


def test_ingest_pt_windows_matches_jax(tmp_path, capsys):
    root = str(tmp_path / "pt")
    _pt_tree(root)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_main(["ingest", "pt-windows", root, a]) == 0
    got = json.loads(capsys.readouterr().out.strip())
    assert got == {"converted": jin.convert_pt_windows(root, b)}
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if not k.endswith(".npz"):
            continue
        with np.load(fa[k]) as x, np.load(fb[k]) as y:
            assert x.files == y.files
            for f in x.files:
                assert x[f].dtype == y[f].dtype
                np.testing.assert_array_equal(x[f], y[f])


def test_ingest_clip_csv_matches_jax(tmp_path, capsys):
    from surya_tpu.features.pose_extended import FEATURE_NAMES_EXTENDED

    rng = np.random.default_rng(1)
    split = tmp_path / "processed" / "train"
    split.mkdir(parents=True)
    cols = (["annotated_image_path", "clip_id", "frame_index",
             "original_image_filename", "LEGACY_COL"]
            + [c for c in FEATURE_NAMES_EXTENDED if c != "LM5_norm_z"])
    for clip, n in (("video_clip_001", 3), ("video_clip_002", 0)):
        with open(split / f"{clip}_features.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols)
            w.writeheader()
            for i in range(n):
                w.writerow({c: (rng.normal() if c not in cols[:5] else
                                f"{c}{i}") for c in cols}
                           | {"LEFT_ELBOW_ANGLE": ""})
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_main(["ingest", "clip-csv", str(tmp_path / "processed"),
                      a]) == 0
    got = json.loads(capsys.readouterr().out.strip())
    report = jin.convert_clip_features_csvs(str(tmp_path / "processed"), b)
    assert got == {"clips": {"train": len(report["train"])},
                   "dropped_columns": report["_dropped_columns"]}
    _same_bytes(a, b)
