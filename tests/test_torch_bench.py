"""``python -m surya_tpu_torch bench`` (``bench/throughput.py``) against
the root ``bench.py``: its knobs, its metric names, its batch and its one
JSON line. The card test is marked ``cuda`` and skips without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_bench.py
"""

import json

import numpy as np
import pytest
import torch

from surya_tpu_torch.bench import throughput
from torch_port_fixtures import one_torch_thread  # noqa: F401

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "batch_size",
              "baseline_device", "caveat"}
KNOBS = ("BENCH_MODEL", "BENCH_STEPS", "BENCH_BATCH", "BENCH_SEQ_LEN",
         "BENCH_MODE", "BENCH_FREEZE", "BENCH_S2D")


def _run(monkeypatch, capsys, env, device="cpu"):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    assert throughput.main(["--device", device]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("env,metric,unit", [
    ({"BENCH_MODEL": "quadtree"},
     "quadtree_train_images_per_sec_per_chip", "images/sec"),
    ({"BENCH_MODEL": "quadtree", "BENCH_MODE": "infer"},
     "quadtree_infer_images_per_sec_per_chip", "images/sec"),
    ({"BENCH_MODEL": "cnn-lstm", "BENCH_SEQ_LEN": "2"},
     "cnn-lstm_train_clips_per_sec_per_chip", "clips/sec"),
])
def test_bench_cpu_prints_one_line(monkeypatch, capsys, env, metric, unit):
    line = _run(monkeypatch, capsys,
                {**env, "BENCH_BATCH": "2", "BENCH_STEPS": "1"})
    assert BENCH_KEYS | {"device", "kernel_launches"} == set(line)
    assert line["metric"] == metric and line["unit"] == unit
    assert line["value"] > 0 and line["batch_size"] == 2
    assert line["vs_baseline"] is None and line["baseline_device"] is None
    assert line["caveat"] is None and line["device"] == "cpu"
    # the plain versions run on the CPU: no kernel is launched
    assert line["kernel_launches"]["quadrant"] == {"training": 0,
                                                   "inference": 0}


# bench.py:209-225's rule: f"{model_name}_{phase}_{images|clips}_per_sec_
# per_chip", the model name as BENCH_MODEL gives it (a model or a preset)
@pytest.mark.parametrize("model,temporal,infer,name", [
    ("quadtree", False, False, "quadtree_train_images_per_sec_per_chip"),
    ("quadtree", False, True, "quadtree_infer_images_per_sec_per_chip"),
    ("cnn_lstm", True, False, "cnn_lstm_train_clips_per_sec_per_chip"),
    ("fact", True, True, "fact_infer_clips_per_sec_per_chip"),
    ("quadtree-fusion", False, False,
     "quadtree-fusion_train_images_per_sec_per_chip"),
    ("quadtree-3d", True, False, "quadtree-3d_train_clips_per_sec_per_chip"),
    ("fact-bs16", True, True, "fact-bs16_infer_clips_per_sec_per_chip"),
])
def test_metric_name_is_bench_pys(model, temporal, infer, name):
    assert throughput.metric_name(model, temporal, infer) == name


@pytest.mark.parametrize("batch_size,seq_len,temporal", [
    (3, 4, False), (2, 3, True)])
def test_batch_is_bench_pys_draw(batch_size, seq_len, temporal):
    # bench.py:123-134, verbatim
    rng = np.random.default_rng(0)
    if temporal:
        want = (rng.normal(size=(batch_size, seq_len, 224, 224,
                                 3)).astype(np.float32),
                rng.normal(size=(batch_size, seq_len, 47)).astype(
                    np.float32),
                rng.integers(0, 8, batch_size).astype(np.int32))
    else:
        want = (rng.normal(size=(batch_size, 224, 224, 3)).astype(
                    np.float32),
                rng.normal(size=(batch_size, 47)).astype(np.float32),
                rng.integers(0, 8, batch_size).astype(np.int32))
    got = throughput.draw_batch(batch_size, seq_len, temporal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("env,want", [
    ({}, {"name": "quadtree", "batch": 256, "seq_len": 4, "freeze": False,
          "lr": 1e-4}),
    ({"BENCH_MODEL": "cnn_lstm"},
     {"name": "cnn_lstm", "batch": 32, "seq_len": 4, "freeze": False}),
    ({"BENCH_MODEL": "fact-bs16"},
     {"name": "fact", "batch": 16, "seq_len": 4, "freeze": True}),
    ({"BENCH_MODEL": "fact-bs16", "BENCH_FREEZE": "0", "BENCH_BATCH": "4"},
     {"name": "fact", "batch": 4, "seq_len": 4, "freeze": False}),
    ({"BENCH_MODEL": "quadtree-3d", "BENCH_S2D": "1"},
     {"name": "quadtree_3d", "batch": 8, "seq_len": 5, "freeze": False,
      "lr": 5e-5, "s2d": True}),
])
def test_config_follows_bench_pys_knobs(env, want):
    cfg, _ = throughput.bench_config(env)
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.train.nan_guard is False
    got = {"name": cfg.model.name, "batch": cfg.data.batch_size,
           "seq_len": cfg.model.seq_len,
           "freeze": cfg.model.freeze_backbone, "lr": cfg.train.lr,
           "s2d": cfg.model.stem_space_to_depth}
    assert {k: got[k] for k in want} == want


@pytest.mark.cuda
def test_bench_on_card_launches_training_forms(monkeypatch, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    from surya_tpu_torch.ops.cuda import fusion_head, quadrant

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(quadrant, "quadrant_process_plain", no_plain)
    monkeypatch.setattr(fusion_head, "fusion_head_plain", no_plain)
    for m in (quadrant, fusion_head):
        m.launches = m.training_launches = 0
    steps = 2
    line = _run(monkeypatch, capsys, {"BENCH_BATCH": "16",
                                      "BENCH_STEPS": str(steps)},
                device="cuda")
    # an untimed pass and three timed windows, each of `steps` steps
    want = {"training": 4 * steps, "inference": 0}
    assert line["kernel_launches"]["quadrant"] == want
    assert line["kernel_launches"]["fusion_head"] == want
    assert line["value"] > 0 and line["device"] != "cpu"
