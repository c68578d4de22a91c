"""The port's loop, metrics and random streams
(``surya_tpu_torch/train/loop.py``, ``core/metrics.py``,
``core/prng.py``) against the JAX package on the CPU.

- ``EarlyStopping`` and ``Plateau``: the same decisions on the same metric
  sequences;
- the metrics: confusion matrix exact, P/R/F1 and R² to 1e-6;
- ``evaluate`` on the same weights with sentinel-padded eval batches:
  counts and confusion exact, loss and P/R/F1 to 1e-5 relative;
- ``train_and_evaluate``, 3 epochs on the same ``ArrayDataSource`` from
  JAX's initial weights at f32 with dropout 0: per-epoch losses to 4e-3
  relative (the bound of the 25-step trajectory in
  ``test_torch_train_steps.py``: float error grows over coupled Adam
  steps), and the same best epoch and learning rates;
- a JAX variable tree saved as ``.npz`` loads as a checkpoint.

Checkpoints and preemption are ``test_torch_preempt.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from surya_tpu.core import config as jcfg
from surya_tpu.core import metrics as jmetrics
from surya_tpu.core.metrics import MetricsLogger as JLogger
from surya_tpu.core.prng import PRNG as JPRNG
from surya_tpu.core.prng import _stable_hash as j_hash
from surya_tpu.data import ArrayDataSource as JArraySource
from surya_tpu.models import get_model as jax_get_model
from surya_tpu.train import loop as jloop
from surya_tpu.train import steps as jsteps
from surya_tpu_torch.core import metrics as tmetrics
from surya_tpu_torch.core.checkpoint import load_params
from surya_tpu_torch.core.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from surya_tpu_torch.core.metrics import MetricsLogger
from surya_tpu_torch.core.prng import PRNG, _stable_hash
from surya_tpu_torch.data import ArrayDataSource, make_synthetic_spatial
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.from_jax import from_jax_variables
from surya_tpu_torch.train import loop as tloop
from surya_tpu_torch.train import steps as tsteps
from torch_port_fixtures import one_torch_thread  # noqa: F401

IMG, CLASSES, BS = 64, 3, 8


def _splits(per_class=8, test=True):
    names = ("train", "valid", "test") if test else ("train", "valid")
    return {s: make_synthetic_spatial(num_classes=CLASSES,
                                      per_class=per_class if s == "train"
                                      else 4, image_size=IMG, seed=i)
            for i, s in enumerate(names)}


def _cfg(tmp_path=None, epochs=3, **model):
    model = {"name": "quadtree", "num_classes": CLASSES,
             "compute_dtype": "float32", "freeze_backbone": True, **model}
    train = {"epochs": epochs, "lr": 1e-3, "seed": 0,
             "early_stop_patience": 0,
             "checkpoint_dir": str(tmp_path / "ckpt") if tmp_path
             else "unused"}
    return Config(model=ModelConfig(**model), data=DataConfig(batch_size=BS),
                  train=TrainConfig(**train))


def _quiet():
    return MetricsLogger(echo=False)


# --- trackers, metrics, random streams -------------------------------------

SEQUENCES = [[1.0, 0.9, 0.95, 0.95, 0.8, 0.81, 0.82, 0.83],
             [0.5, 0.6, 0.6, 0.4, 0.7, 0.69, 0.71],
             [2.0, 2.0, 2.0, 2.0, 1.0]]


@pytest.mark.parametrize("metric", ["val_loss", "val_accuracy"])
@pytest.mark.parametrize("seq", SEQUENCES)
def test_early_stopping_decisions_match_jax(metric, seq):
    port = tloop.EarlyStopping(metric, patience=2, min_delta=0.01)
    ref = jloop.EarlyStopping(metric, patience=2, min_delta=0.01)
    for epoch, v in enumerate(seq):
        assert port.update(v, epoch) == ref.update(v, epoch)
        assert port.should_stop == ref.should_stop
        assert port.state_dict() == ref.state_dict()
    fresh = tloop.EarlyStopping(metric, patience=2)
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == port.state_dict()


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("seq", SEQUENCES)
def test_plateau_decisions_match_jax(mode, seq):
    port = tloop.Plateau(2, 0.5, 1e-3, mode)
    ref = jloop.Plateau(2, 0.5, 1e-3, mode)
    lr_p = lr_r = 1e-2
    for v in seq:
        new_p, new_r = port.update(v, lr_p), ref.update(v, lr_r)
        assert new_p == new_r
        lr_p, lr_r = new_p or lr_p, new_r or lr_r
        assert port.state_dict() == ref.state_dict()
    assert tloop.Plateau(0, 0.5, 0.0).update(1.0, 1.0) is None


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, 50)
    preds = np.where(rng.random(50) < 0.6, labels, rng.integers(0, 4, 50))
    labels[:3] = -1                         # sentinel rows are dropped
    cm = tmetrics.confusion_matrix(torch.from_numpy(labels),
                                   torch.from_numpy(preds), 4)
    want = jmetrics.confusion_matrix(jnp.asarray(labels), jnp.asarray(preds),
                                     4)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(want))
    for avg in ("weighted", "macro", "none"):
        for g, w in zip(tmetrics.precision_recall_f1(cm, avg),
                        jmetrics.precision_recall_f1(want, avg)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    with pytest.raises(ValueError):
        tmetrics.precision_recall_f1(cm, "micro")
    for lab, pr in ((labels[3:], preds[3:]), (np.ones(5), np.ones(5)),
                    (np.ones(5), np.arange(5))):
        np.testing.assert_allclose(
            float(tmetrics.r2_score(torch.from_numpy(lab),
                                    torch.from_numpy(pr))),
            float(jmetrics.r2_score(jnp.asarray(lab), jnp.asarray(pr))),
            atol=1e-6)
    a = torch.tensor([1, 2, 3])
    assert float(tmetrics.accuracy(a, torch.tensor([1, 0, 3]))) == float(
        jmetrics.accuracy(jnp.asarray([1, 2, 3]), jnp.asarray([1, 0, 3])))


def test_metrics_logger_writes_the_jax_records(tmp_path):
    rec = {"epoch": 1, "train_loss": np.float32(0.5),
           "confusion": np.eye(2, dtype=np.int32), "n": np.int64(3)}
    for cls, name in ((MetricsLogger, "port"), (JLogger, "ref")):
        log = cls(str(tmp_path / f"{name}.jsonl"), echo=False)
        log.log(rec)
        log.close()
    got, want = ((tmp_path / f"{n}.jsonl").read_text() for n in ("port",
                                                                 "ref"))
    got, want = json.loads(got), json.loads(want)
    assert got.pop("ts") and want.pop("ts")
    assert got == want
    log = MetricsLogger(str(tmp_path / "t.jsonl"), echo=False)
    log.log({"loss": torch.tensor(0.25), "cm": torch.eye(2)})
    log.close()
    assert json.loads((tmp_path / "t.jsonl").read_text())["cm"] == [
        [1.0, 0.0], [0.0, 1.0]]


def test_prng_streams_are_stateless_and_named():
    for name in ("augment", "dropout", "init", ""):
        assert _stable_hash(name) == j_hash(name)
    p = PRNG(42)
    assert p.seed_of(3, "augment") == PRNG(42).seed_of(3, "augment")
    seeds = {p.seed_of(s, n) for s in range(4) for n in ("augment",
                                                          "dropout")}
    assert len(seeds) == 8 and p.seed_of(0, "a") != PRNG(43).seed_of(0, "a")
    a = torch.rand(4, generator=p.named(7, "dropout"))
    b = torch.rand(4, generator=PRNG(42).named(7, "dropout"))
    assert torch.equal(a, b)
    assert p.named(7, "dropout").device.type == "cpu"


# --- evaluate and the loop against JAX ---------------------------------------

def _jax_cfg(cfg):
    ref = jcfg.Config(
        model=jcfg.ModelConfig(**vars(cfg.model)),
        data=jcfg.DataConfig(**vars(cfg.data)),
        train=jcfg.TrainConfig(**vars(cfg.train)))
    assert ref.to_dict() == cfg.to_dict()
    return ref


def _jax_init(jax_cfg, sample):
    """JAX's initial variables as its loop makes them."""
    jstate, _ = jsteps.create_train_state(
        jax_get_model(jax_cfg.model), jax_cfg,
        JPRNG(jax_cfg.train.seed).named(0, "init"), sample)
    return {"params": jax.tree.map(np.asarray, jstate.params),
            "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}


@pytest.fixture(scope="module")
def jax_variables():
    """JAX's initial variables for ``_cfg(dropout=0.0)`` and the first
    batch of ``_splits()``, shared by the tests that start from them."""
    return _jax_init(_jax_cfg(_cfg(dropout=0.0)), next(iter(
        JArraySource(_splits(), BS).train_batches(0))))


def _port_model_from(variables):
    def build(cfg, image_size=224, seed=0):
        model = get_model(cfg, image_size=image_size, seed=seed)
        model.load_state_dict(from_jax_variables(variables), strict=True)
        return model
    return build


def test_evaluate_matches_jax_with_sentinel_padding(mesh1, jax_variables):
    cfg = _cfg(dropout=0.0)
    ref_cfg = _jax_cfg(cfg)
    splits = _splits()
    splits["valid"] = make_synthetic_spatial(num_classes=CLASSES,
                                             per_class=5, image_size=IMG,
                                             seed=9)   # 15 rows: 8 + 7
    port_data = ArrayDataSource(splits, BS, pad_eval_to=4)
    ref_data = JArraySource(splits, BS, pad_eval_to=4)
    variables = jax_variables
    model = _port_model_from(variables)(cfg.model, IMG)
    got = tloop.evaluate(tsteps.make_eval_step(model, CLASSES),
                         port_data.eval_batches("valid"), "cpu")
    with mesh1:
        want = jloop.evaluate(
            jsteps.make_eval_step(jax_get_model(ref_cfg.model), CLASSES),
            variables["params"], variables["batch_stats"],
            ref_data.eval_batches("valid"), mesh1)
    assert got["count"] == want["count"] == 15
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    for k in ("loss", "accuracy", "precision", "recall", "f1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    empty = tloop.evaluate(None, iter(()), "cpu")
    assert empty["count"] == 0 and empty["confusion"] is None


def test_train_and_evaluate_matches_jax(mesh1, monkeypatch, jax_variables):
    """3 epochs of 3 steps from JAX's initial weights (frozen trunk, f32,
    dropout 0), then the test split on the best epoch's weights."""
    cfg = _cfg(dropout=0.0)
    ref_cfg = _jax_cfg(cfg)
    splits = _splits()
    ref_data = JArraySource(splits, BS)
    monkeypatch.setattr(tloop, "get_model", _port_model_from(jax_variables))
    got = tloop.train_and_evaluate(cfg, ArrayDataSource(splits, BS),
                                   logger=_quiet(), checkpoints=False,
                                   device="cpu")
    want = jloop.train_and_evaluate(ref_cfg, ref_data, mesh=mesh1,
                                    logger=JLogger(echo=False),
                                    checkpoints=False)
    assert len(got["history"]) == len(want["history"]) == 3
    for g, w in zip(got["history"], want["history"]):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=4e-3, err_msg=k)
        assert np.float32(g["lr"]) == np.float32(w["lr"])
        assert g["steps"] == 3
    for k in ("best_epoch", "checkpoint_best_epoch", "preempted"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["test"]["loss"], want["test"]["loss"],
                               rtol=4e-3)
    assert got["test"]["count"] == want["test"]["count"] == 12


def test_checkpoint_loads_a_jax_npz(tmp_path, jax_variables):
    variables = jax_variables
    flat = {}
    for col in ("params", "batch_stats"):
        for path, v in jax.tree_util.tree_flatten_with_path(
                variables[col])[0]:
            flat["/".join([col] + [p.key for p in path])] = np.asarray(v)
    np.savez(tmp_path / "v.npz", **flat)
    model = get_model(_cfg().model, image_size=IMG)
    model.load_state_dict(load_params(str(tmp_path / "v.npz")), strict=True)
