"""The port's replay campaign (``surya_tpu_torch/bench/replay.py``)
against the JAX package's scripts: the data writer against
``scripts/make_replay_disk.py`` byte for byte, the job list against
``scripts/replay_batch.py::jobs_for``, and the table's bands against
``runs/reference_replay/table.json`` from its committed runs."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from surya_tpu_torch.bench import replay
from torch_port_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(amp_hi=0.45, amp_pow=0.5, feat_sep=1.55)


def _script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    files = _files(a)
    assert files == _files(b)
    for name in files:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    return files


def test_spatial_writer_is_make_replay_disks(tmp_path):
    jax = _script("make_replay_disk")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax.write_spatial(a, 2, 32, **KW)
    raw = replay.write_spatial(b, 2, 32, **KW)
    files = _same_tree(a, b)
    # 16 train and 8 per class in valid and test, a .jpg and a .npy each,
    # and the two class-stat JSONs
    assert len(files) == 2 * (16 + 64 + 64) + 2
    assert {s: len(r[2]) for s, r in raw.items()} == {
        "train": 16, "valid": 64, "test": 64}


def test_temporal_writer_is_make_replay_disks(tmp_path):
    jax = _script("make_replay_disk")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax.write_temporal(a, 2, 16, 2, **KW)
    counts = replay.write_temporal(b, 2, 16, 2, **KW)
    files = _same_tree(a, b)
    assert "class_to_idx.json" in files and len(files) == 1 + 16 + 64 + 64
    assert counts == {"train": 16, "valid": 64, "test": 64}


@pytest.mark.parametrize("group", ["controls", "temporal",
                                   "temporal-trainable", "spatial"])
def test_jobs_are_replay_batchs(group):
    jax = _script("replay_batch")
    want = list(jax.jobs_for(group, "/data/r", 3))
    got = list(replay.jobs_for(group, "/data/r", 3, out=jax.REPLAY))
    assert got == want and len(got) % 3 == 0


def test_unknown_group_is_refused():
    with pytest.raises(SystemExit):
        list(replay.jobs_for("nope", "/data/r", 1))


def test_native_resize_rule_in_numpy(tmp_path):
    from PIL import Image

    from surya_tpu_torch import native

    rng = np.random.default_rng(3)
    paths = []
    for i, hw in enumerate([(224, 224), (37, 61), (300, 200)]):
        p = str(tmp_path / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(
            p, quality=92)
        paths.append(p)
    got, ok = native.decode_batch(paths, 256)
    assert ok == len(paths)
    for g, p in zip(got, paths):
        with Image.open(p) as im:
            decoded = np.asarray(im.convert("RGB"))
        assert np.array_equal(g, replay.resize_bilinear_u8(decoded, 256))


def test_data_phase_packs_and_measures(tmp_path):
    gen = dict(replay.GEN_CONFIG, per_class=2, seq_per_class=2,
               image_size=32, seq_len=3)
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    rec = replay.data_phase(root, out, gen)
    assert rec["images"] == rec["windows"] == {"train": 16, "valid": 64,
                                               "test": 64}
    for pack in ("spatial_packed", "temporal_packed_t4",
                 "temporal_packed_t5"):
        assert os.path.exists(os.path.join(root, pack, "packed_meta.json"))
    err = rec["pixel_error"]
    assert err["images"] == 144
    # quality 92 moves pixels by a few levels, never by much
    assert 0 < err["jpeg_vs_raw"]["mean_abs"] < 8
    assert 0 < err["pack_vs_raw_resized"]["mean_abs"] < 8
    assert err["jpeg_vs_raw"]["psnr_db"] > 25
    assert rec["decoder"]["pack_used"] in ("native", "PIL")
    with open(os.path.join(out, "data.json")) as f:
        assert json.load(f)["pixel_error"] == json.loads(json.dumps(err))


def test_table_reproduces_jax_bands():
    with open(os.path.join(replay.JAX_REPLAY, "table.json")) as f:
        jax = json.load(f)
    table = replay.build_table(replay.JAX_REPLAY, "/data/r", 3)
    assert table["bands"] == jax["bands"]
    assert table["control_bands"] == jax["control_bands"]
    assert table["orderings"] == jax["orderings"]
    assert table["failures"] == jax["failures"] == []
    assert all(v["overlap"] for v in table["vs_jax"].values())
    assert table["vs_jax"]["quadtree-fusion"]["jax"]["accs"] == [
        0.91015625, 0.89453125, 0.92578125]


@pytest.mark.parametrize("port,jax,want", [
    ({"mean": 0.90, "std": 0.01}, {"mean": 0.91, "std": 0.013}, True),
    ({"mean": 0.85, "std": 0.02}, {"mean": 0.91, "std": 0.013}, False),
    ({"mean": 0.95, "std": 0.0}, {"mean": 0.91, "std": 0.04}, True),
])
def test_overlap_and_separation(port, jax, want):
    assert replay.overlap(port, jax) is want
    assert replay.overlap(jax, port) is want
    assert replay.separated(port, jax) is (not want and port["mean"]
                                           > jax["mean"])


def test_failed_run_is_an_error_row_and_listed(tmp_path):
    out, root = str(tmp_path / "out"), str(tmp_path / "missing")
    name, preset, run_dir, ov = next(replay.jobs_for("spatial", root, 1,
                                                     out))
    row = replay.run_job(name, preset, run_dir, ov, device="cpu")
    assert "test" not in row and row["attempts"] == 1 and row["error"]
    table = replay.build_table(out, root, 1)
    assert [f["run"] for f in table["failures"]] == [
        "spatial/quadtree-fusion_s0"]
    assert "spatial/quadtree-fusion_s0" in table["not_run"]
    assert len(table["not_run"]) == 2 + 6 + 4 + 7
    assert table["bands"] == {} and table["vs_jax"] == {}


def test_vs_jax_cpu_sets_the_cpu_bands_beside_the_tpu_band(tmp_path):
    """``diag/<side>`` runs (``tests/replay_diag.py``) become bands beside
    JAX's TPU band and the port's campaign band (a row cut short has
    neither, and a run without a test result is left out), and each side
    is paired seed by seed with JAX's CPU runs and its TPU runs: the
    accuracy gaps of whole rows and the loss gaps of the epochs both
    reached, each mean with its standard error."""
    from replay_diag import vs_jax_cpu

    def write(root, row, seed, acc, losses, **where):
        d = root / f"{row}_s{seed}"
        d.mkdir(parents=True)
        (d / "result.json").write_text(json.dumps(
            {"preset": row, "base_preset": row.split("-15ep")[0],
             "seed": seed, "test": {"accuracy": acc}, **where}))
        (d / "metrics.jsonl").write_text("".join(
            json.dumps({"epoch": e, "train_loss": t, "val_loss": v}) + "\n"
            for e, (t, v) in enumerate(losses)))

    diag, tpu_runs = tmp_path / "diag", tmp_path / "tpu"
    for seed, (j, p) in enumerate([(0.87, 0.86), (0.86, 0.88),
                                   (0.87, 0.88)]):
        write(diag / "jax_cpu", "experiment-fusion", seed, j,
              [(2.0, 1.9), (1.5, 1.4)], host="cpu x8")
        write(diag / "port_cpu", "experiment-fusion", seed, p,
              [(2.0 + seed / 10, 1.9), (1.6, 1.4)], host="cpu x8")
        write(diag / "port_card_jaxinit", "experiment-fusion", seed, 0.9,
              [(2.0, 1.9)], nvidia_smi="H100, 700 W")
        write(tpu_runs / "spatial", "experiment-fusion", seed, 0.9,
              [(1.9, 1.8), (1.4, 1.3), (1.0, 1.0)])
    write(diag / "jax_cpu", "ji-3dcnn-15ep", 0, 0.5, [(2.0, 1.9)],
          host="cpu x8")
    write(diag / "port_cpu", "ji-3dcnn-15ep", 0, 0.4, [(2.1, 2.0)],
          host="cpu x8")
    write(diag / "port_card_jaxdraws", "ji-3dcnn", 0, 0.7,
          [(2.05, 1.95), (1.5, 1.4)], nvidia_smi="H100, 700 W")
    write(diag / "port_card_jaxinit", "ji-3dcnn", 0, 0.75,
          [(2.0, 1.9), (1.5, 1.5)], nvidia_smi="H100, 700 W")
    write(tpu_runs / "temporal", "ji-3dcnn", 0, 0.8, [(1.8, 1.7)])
    (diag / "jax_cpu" / "broken_s0").mkdir()
    (diag / "jax_cpu" / "broken_s0" / "result.json").write_text(
        json.dumps({"preset": "broken", "seed": 0, "error": "exit 1"}))
    tpu = {"experiment-fusion": {"mean": 0.897, "std": 0.010,
                                 "accs": [0.9]}}
    card = {"experiment-fusion": {"mean": 0.863, "std": 0.013,
                                  "accs": [0.86]}}
    block = vs_jax_cpu(str(diag), tpu, card, str(tpu_runs))
    assert block["sources"] == ["H100, 700 W", "cpu x8"]
    assert sorted(block["bands"]) == ["experiment-fusion", "ji-3dcnn",
                                      "ji-3dcnn-15ep"]
    row = block["bands"]["experiment-fusion"]
    assert row["jax_cpu"]["accs"] == [0.87, 0.86, 0.87]
    assert row["port_cpu"]["accs"] == [0.86, 0.88, 0.88]
    assert row["jax_tpu"]["mean"] == 0.897
    assert row["port_campaign"]["mean"] == 0.863
    assert row["jax_cpu_overlaps_jax_tpu"] is False
    assert row["jax_cpu_overlaps_port_campaign"] is True
    assert row["port_cpu_overlaps_jax_tpu"] is False
    assert row["port_card_jaxinit_overlaps_jax_tpu"] is True
    short = block["bands"]["ji-3dcnn-15ep"]
    assert short["jax_tpu"] is None and short["port_campaign"] is None
    assert short["jax_cpu_overlaps_jax_tpu"] is None

    pairs = block["paired"]["experiment-fusion"]
    assert pairs.pop("base") == "experiment-fusion"
    assert sorted(pairs) == [
        "jax_cpu - jax_tpu", "port_card_jaxinit - jax_cpu",
        "port_card_jaxinit - jax_tpu", "port_cpu - jax_cpu",
        "port_cpu - jax_tpu"]
    port = pairs["port_cpu - jax_cpu"]
    assert port["seeds"] == [0, 1, 2]
    np.testing.assert_allclose(port["test_accuracy"]["gaps"],
                               [-0.01, 0.02, 0.01])
    np.testing.assert_allclose(port["test_accuracy"]["mean"], 0.02 / 3)
    np.testing.assert_allclose(port["test_accuracy"]["se"],
                               np.std([-0.01, 0.02, 0.01], ddof=1)
                               / np.sqrt(3))
    np.testing.assert_allclose(port["train_loss"]["mean_gap"], [0.1, 0.1])
    np.testing.assert_allclose(port["train_loss"]["se"], [0.05774, 0.0],
                               atol=1e-5)
    assert port["val_loss"]["mean_gap"] == [0.0, 0.0]
    # the epochs both reached; whole rows only for the accuracy
    assert len(pairs["port_card_jaxinit - jax_cpu"]["val_loss"][
        "mean_gap"]) == 1
    np.testing.assert_allclose(
        pairs["jax_cpu - jax_tpu"]["val_loss"]["mean_gap"], [0.1, 0.1])
    # a cut row pairs with whole rows over the epochs both reached; the
    # accuracy only with runs of the same cut
    cut = block["paired"]["ji-3dcnn"]
    assert "test_accuracy" not in cut["jax_cpu - jax_tpu"]
    whole = cut["port_card_jaxdraws - jax_cpu"]
    assert "test_accuracy" not in whole
    np.testing.assert_allclose(whole["val_loss"]["mean_gap"], [0.05])
    np.testing.assert_allclose(cut["port_card_jaxdraws - jax_tpu"][
        "test_accuracy"]["gaps"], [-0.1])
    draws = cut["port_card_jaxinit - port_card_jaxdraws"]
    np.testing.assert_allclose(draws["test_accuracy"]["gaps"], [0.05])
    np.testing.assert_allclose(draws["val_loss"]["mean_gap"], [-0.05, 0.1])
    np.testing.assert_allclose(cut["port_cpu - jax_cpu"]["test_accuracy"][
        "gaps"], [-0.1])
    assert cut["port_cpu - jax_cpu"]["test_accuracy"]["se"] is None
    np.testing.assert_allclose(cut["port_cpu - jax_tpu"]["val_loss"][
        "mean_gap"], [0.3])
    assert vs_jax_cpu(str(tmp_path / "none"), tpu, card, str(tpu_runs)) \
        == {"sources": [], "bands": {}, "paired": {}}


def test_layer4_relu_inputs_are_counted():
    from surya_tpu_torch.core.config import ModelConfig
    from surya_tpu_torch.interpret.gradcam import cam_model, cam_split
    from surya_tpu_torch.models import get_model

    cfg = ModelConfig(compute_dtype="float32")
    state = get_model(cfg, image_size=64, seed=0).state_dict()
    model = cam_model(cfg, state, 64, "cpu")
    images = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    fmap, _, _ = cam_split(cfg, model, images, "layer3")
    pre = replay.layer4_relu_inputs(model, fmap)
    # two blocks, two ReLUs each, on (2, 2, 2, 512) maps
    assert pre.shape == (4 * 2 * 2 * 2 * 512,)
    block = model.trunk.layer4_block0
    x = fmap.permute(0, 3, 1, 2)
    with torch.no_grad():
        first = block.bn1(block.conv1(x))
    assert torch.equal(pre[:first.numel()], first.reshape(-1))


def test_import_check_covers_the_bench_modules():
    """``test_torch_imports.py``'s JAX-free import check walks the
    campaign and the ``bench`` command."""
    from test_torch_imports import _port_modules

    assert {"surya_tpu_torch.bench.replay",
            "surya_tpu_torch.bench.throughput"} <= set(_port_modules())
