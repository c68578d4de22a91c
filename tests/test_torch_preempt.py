"""The port's checkpoints and preemption-safe resume
(``surya_tpu_torch/core/checkpoint.py``, ``train/loop.py``) on the CPU.

- a checkpoint round trip restores parameters, BN buffers, AdamW moments,
  the step and the dropout generator exactly;
- best-plus-latest retention (``max_to_keep=3``), atomic writes;
- SIGTERM → resume ends with weights bit-identical to an uninterrupted
  run on the CPU, as ``tests/test_preempt.py`` pins for JAX;
- the loop's own rules: NaN-skipped steps out of the epoch mean, data
  echoing, the profiler trace of the second epoch, one device only.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from surya_tpu_torch.core.checkpoint import (
    CheckpointManager,
    load_checkpoint_variables,
    load_params,
    load_snapshot,
    save_params,
    snapshot,
)
from surya_tpu_torch.core.config import (
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from surya_tpu_torch.core.metrics import MetricsLogger
from surya_tpu_torch.data import ArrayDataSource, make_synthetic_spatial
from surya_tpu_torch.models import get_model
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


# --- checkpoints ------------------------------------------------------------

def _state(cfg, seed=0):
    model = get_model(cfg.model, image_size=IMG, seed=seed)
    state, _ = tsteps.create_train_state(model, cfg, device="cpu")
    return state


def test_checkpoint_round_trip(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(cfg)
    step = tsteps.make_train_step(state.model, state.optimizer, cfg)
    batch = next(iter(ArrayDataSource(_splits(), BS).train_batches(0)))
    state, _ = step(state, batch)
    torch.rand(3, generator=state.generator)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(4, snapshot(state), metrics={"val_loss": 1.5})
    assert mgr.all_steps() == [4] and mgr.metrics(4) == {"val_loss": 1.5}
    assert not [n for n in os.listdir(mgr.directory) if n.endswith(".tmp")]

    fresh = _state(cfg, seed=1)
    load_snapshot(fresh, mgr.restore())
    assert fresh.step == state.step == 1
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    want = state.optimizer.state_dict()["state"]
    got = fresh.optimizer.state_dict()["state"]
    for i in want:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[i][k], want[i][k])
    assert torch.equal(torch.rand(5, generator=fresh.generator),
                       torch.rand(5, generator=state.generator))
    # weights alone: the .pt of a step, the directory, save_params
    sd = load_checkpoint_variables(mgr.directory)
    assert sd.keys() == state.model.state_dict().keys()
    assert load_params(os.path.join(mgr.directory, "4.pt")).keys() == sd.keys()
    save_params(str(tmp_path / "w.pt"), state.model.state_dict())
    assert torch.equal(load_params(str(tmp_path / "w.pt"))["classifier.fc1"
                                                          ".weight"],
                       sd["classifier.fc1.weight"])
    with pytest.raises(ValueError, match="checkpoint must be"):
        load_params(str(tmp_path / "w.bin"))


def test_retention_keeps_the_best_and_every_snapshot(tmp_path):
    """Best-by-metric retention (max_to_keep=3): metric-less preemption
    snapshots are kept and cannot evict the best; without best_fn the
    latest three are kept."""
    snap = {"model": {"w": torch.zeros(2)}, "step": 0}
    mgr = CheckpointManager(str(tmp_path / "a"),
                            best_fn=lambda m: m["val_loss"], best_mode="min")
    for step, loss in enumerate([0.9, 0.5, 0.7, 0.8, 0.6, 1.0]):
        mgr.save(step, snap, metrics={"val_loss": loss})
    mgr.save(10, snap, force=True)
    mgr.save(11, snap)
    assert mgr.all_steps() == [1, 2, 4, 10, 11]
    assert mgr.latest_step() == 11
    mgr.save(1, snap)                       # a snapshot replaces a step
    assert mgr.metrics(1) is None and 1 in mgr.all_steps()
    mgr.delete(11)
    mgr.delete(11)
    assert mgr.all_steps() == [1, 2, 4, 10]

    latest = CheckpointManager(str(tmp_path / "b"))
    for step in range(5):
        latest.save(step, snap)
    assert latest.all_steps() == [2, 3, 4]
    with open(os.path.join(latest.directory, "9.pt.123.tmp"), "w") as f:
        f.write("half a save")
    assert CheckpointManager(latest.directory).all_steps() == [2, 3, 4]
    assert not os.path.exists(os.path.join(latest.directory, "9.pt.123.tmp"))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "c")).restore()


# --- preemption ---------------------------------------------------------------

class SigtermAfter:
    """Data source wrapper that SIGTERMs this process after yielding
    ``after_batches`` train batches of its ``kill_epoch``-th served epoch
    (0-indexed), once. The loop's first ``train_batches`` call fetches its
    shape sample, so served epochs start at -1."""

    def __init__(self, inner, kill_epoch=0, after_batches=2):
        self.inner = inner
        self.kill_epoch = kill_epoch
        self.after_batches = after_batches
        self.served = -1
        self.fired = False

    @property
    def num_classes(self):
        return self.inner.num_classes

    def train_batches(self, epoch_seed):
        epoch = self.served
        self.served += 1

        def gen():
            for i, b in enumerate(self.inner.train_batches(epoch_seed)):
                yield b
                if (not self.fired and epoch == self.kill_epoch
                        and i + 1 == self.after_batches):
                    self.fired = True
                    os.kill(os.getpid(), signal.SIGTERM)

        return gen()

    def eval_batches(self, split):
        return self.inner.eval_batches(split)


def _data():
    return ArrayDataSource(_splits(test=False), BS)


def test_midepoch_resume_is_bit_exact(tmp_path):
    """Killed in epoch 1 (3 batches an epoch) after its second batch:
    the final weights equal an uninterrupted run's bit for bit (dropout
    0.5 draws from the step-named generators)."""
    ref = tloop.train_and_evaluate(_cfg(tmp_path / "a"), _data(),
                                   logger=_quiet(), checkpoints=False,
                                   device="cpu")
    cfg = _cfg(tmp_path / "b")
    before = signal.getsignal(signal.SIGTERM)
    s1 = tloop.train_and_evaluate(cfg, SigtermAfter(_data(), 1, 1),
                                  logger=_quiet(), device="cpu")
    assert s1["preempted"] is True
    assert signal.getsignal(signal.SIGTERM) == before
    assert [h["epoch"] for h in s1["history"]] == [0]
    with open(os.path.join(cfg.train.checkpoint_dir, "loop_state.json")) as f:
        ls = json.load(f)
    # the signal comes while batch 1 is fetched; that batch still trains
    assert ls["preempt"] and ls["epoch"] == 1 and ls["batch_idx"] == 2
    assert ls["echo_idx"] == 0 and ls["step_count"] == 5

    s2 = tloop.train_and_evaluate(_cfg(tmp_path / "b"), _data(),
                                  logger=_quiet(), resume=True, device="cpu")
    assert s2["preempted"] is False
    assert [h["epoch"] for h in s2["history"]] == [1, 2]
    assert s2["history"][0]["steps"] == 1
    assert s2["checkpoint_best_epoch"] == ref["checkpoint_best_epoch"]
    for (k, a), b in zip(ref["state"].model.state_dict().items(),
                         s2["state"].model.state_dict().values()):
        assert torch.equal(a, b), k


def test_preempt_save_off_leaves_sigterm_alone(tmp_path):
    cfg = _cfg(tmp_path, epochs=1)
    cfg = cfg.override({"train.preempt_save": "false"})
    before = signal.getsignal(signal.SIGTERM)
    s = tloop.train_and_evaluate(cfg, _data(), logger=_quiet(),
                                 device="cpu")
    assert signal.getsignal(signal.SIGTERM) == before
    assert s["preempted"] is False and s["history"]


# --- the loop's own rules -------------------------------------------------------

def test_nan_steps_are_left_out_of_the_epoch_mean(tmp_path):
    splits = _splits(test=False)
    imgs, feats, labels = splits["train"]
    feats = feats.copy()
    order = np.random.default_rng((0, 1)).permutation(len(labels))
    feats[order[:BS]] = np.nan              # the first batch of epoch 0
    splits["train"] = (imgs, feats, labels)
    cfg = _cfg(tmp_path, epochs=1, mode="numerical_only")
    s = tloop.train_and_evaluate(cfg, ArrayDataSource(splits, BS),
                                 logger=_quiet(), checkpoints=False,
                                 device="cpu")
    h = s["history"][0]
    assert h["steps"] == 3 and np.isfinite(h["train_loss"])


def test_data_echo_and_profile(tmp_path):
    """data_echo=2 doubles the steps; profile_dir writes a Chrome trace
    of the second epoch."""
    cfg = _cfg(tmp_path, epochs=2).override({"data.data_echo": "2"})
    s = tloop.train_and_evaluate(cfg, _data(), logger=_quiet(),
                                 checkpoints=False, device="cpu",
                                 profile_dir=str(tmp_path / "prof"))
    assert [h["steps"] for h in s["history"]] == [6, 6]
    assert os.listdir(tmp_path / "prof") == ["trace_epoch1.json"]
    assert s["history"][1]["input_wait_s"] >= 0


def test_mesh_of_more_than_one_device_waits_for_a11(tmp_path):
    """data=-1 is every rank: one without torchrun; a mesh of four devices
    in one process names torchrun (tests/test_torch_parallel.py runs the
    loop's step on two ranks)."""
    assert tloop.as_mesh(MeshConfig(), "cpu").shape["data"] == 1
    with pytest.raises(RuntimeError, match="torchrun"):
        tloop.train_and_evaluate(_cfg(tmp_path), _data(),
                                 mesh=MeshConfig(data=4), device="cpu")
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tloop.train_and_evaluate(_cfg(tmp_path), _data())
