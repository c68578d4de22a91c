"""The training loop, mirroring ``surya_tpu/train/loop.py``: epochs of
train steps and a validation pass, early stopping, ReduceLROnPlateau,
best-metric checkpoints, NaN-skipped steps left out of the epoch means,
preemption-safe resume, per-epoch JSONL records and a final test
evaluation with confusion matrix and weighted P/R/F1.

It runs on the card unless ``device="cpu"``, on one device or, under
``torchrun``, on a mesh of ranks (``core/mesh.py``): every rank reads the
same global batches and keeps its rows, the step is the single-device step
on the global batch, eval sums are all-reduced, rank 0 alone writes
checkpoints, ``loop_state.json`` and records, and a SIGTERM on any rank
stops every rank after the same step. Host batches go to the device once
per batch (asynchronously where the source pinned them);
``device_transform`` and the step run there. Per-step metrics stay
on the device and are read once per epoch (and at ``log_every``); the
step itself reads the loss once for its NaN guard. Augmentation and
dropout take fresh generators named by the global step count
(``core/prng.py``), so a resumed run draws what an uninterrupted one
would.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Iterable

import numpy as np
import torch
from torch.profiler import record_function

from surya_tpu_torch.core.checkpoint import (
    CheckpointManager,
    load_snapshot,
    snapshot,
    write_json,
)
from surya_tpu_torch.core.config import Config
from surya_tpu_torch.core.mesh import (
    DATA_AXIS,
    Mesh,
    MeshSpec,
    all_reduce_,
    batch_rows,
    create_mesh,
    shard_batch,
)
from surya_tpu_torch.core.metrics import MetricsLogger, precision_recall_f1
from surya_tpu_torch.core.prng import PRNG
from surya_tpu_torch.models import get_model
from surya_tpu_torch.ops import resolve_device
from surya_tpu_torch.train.steps import (
    create_train_state,
    get_learning_rate,
    make_eval_step,
    make_train_step,
    set_learning_rate,
    to_device,
)


class EarlyStopping:
    """Best-metric tracker with patience and min_delta."""

    def __init__(self, metric: str, patience: int, min_delta: float = 0.0):
        self.metric = metric
        self.mode = "min" if "loss" in metric else "max"
        self.patience = patience
        self.min_delta = min_delta
        self.best = math.inf if self.mode == "min" else -math.inf
        self.bad_epochs = 0
        self.best_epoch = -1

    def state_dict(self) -> dict:
        return {"best": float(self.best), "bad_epochs": self.bad_epochs,
                "best_epoch": self.best_epoch}

    def load_state_dict(self, d: dict) -> None:
        self.best = float(d["best"])
        self.bad_epochs = int(d["bad_epochs"])
        self.best_epoch = int(d["best_epoch"])

    def update(self, value: float, epoch: int) -> bool:
        """Returns True if this value is a new best."""
        improved = (value < self.best - self.min_delta
                    if self.mode == "min"
                    else value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.bad_epochs = 0
            self.best_epoch = epoch
            return True
        self.bad_epochs += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.patience > 0 and self.bad_epochs >= self.patience


class Plateau:
    """ReduceLROnPlateau: scale LR by factor after patience bad epochs."""

    def __init__(self, patience: int, factor: float, min_lr: float,
                 mode: str = "min"):
        self.enabled = patience > 0
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.bad_epochs = 0

    def state_dict(self) -> dict:
        return {"best": float(self.best), "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = float(d["best"])
        self.bad_epochs = int(d["bad_epochs"])

    def update(self, value: float, current_lr: float) -> float | None:
        """Returns a new LR if it should change, else None."""
        if not self.enabled:
            return None
        improved = (value < self.best if self.mode == "min"
                    else value > self.best)
        if improved:
            self.best = value
            self.bad_epochs = 0
            return None
        self.bad_epochs += 1
        if self.bad_epochs >= self.patience:
            self.bad_epochs = 0
            new_lr = max(current_lr * self.factor, self.min_lr)
            if new_lr < current_lr:
                return new_lr
        return None


def evaluate(eval_step, batches: Iterable, device, transform=None,
             mesh: Mesh | None = None) -> dict:
    """Run ``eval_step`` over host batches on ``device`` → loss, accuracy,
    weighted P/R/F1, confusion matrix and count. The sums stay on the
    device and are read once, after the last batch. On a ``mesh`` each
    rank evaluates its rows of every batch (padded to the data-axis size
    with label −1 rows by the source) and the sums are all-reduced."""
    sharded = mesh is not None and mesh.distributed
    totals = None
    for batch in batches:
        if sharded:
            batch = shard_batch(mesh, batch)
        batch = to_device(batch, device)
        if transform is not None:
            batch = transform(batch)
        out = eval_step(batch)
        totals = (out if totals is None
                  else {k: totals[k] + v for k, v in out.items()})
    if sharded and totals is not None:
        keys = sorted(totals)
        flat = all_reduce_(torch.cat([totals[k].reshape(-1).double()
                                      for k in keys]), mesh.group(DATA_AXIS))
        totals = {k: v.view_as(totals[k]).to(totals[k].dtype)
                  for k, v in zip(keys, flat.split(
                      [totals[k].numel() for k in keys]))}
    if totals is None:
        # empty split: zeroed metrics with every key callers index
        return {"loss": float("nan"), "accuracy": 0.0, "precision": 0.0,
                "recall": 0.0, "f1": 0.0, "confusion": None, "count": 0}
    totals = {k: v.cpu() for k, v in totals.items()}
    count = max(int(totals["count"]), 1)
    cm = totals["confusion"]
    p, r, f1 = (float(x) for x in precision_recall_f1(cm))
    return {"loss": float(totals["loss_sum"]) / count,
            "accuracy": float(totals["correct"]) / count,
            "precision": p, "recall": r, "f1": f1,
            "confusion": cm.numpy(), "count": count}


def as_mesh(mesh, device) -> Mesh:
    """A :class:`core.mesh.Mesh` from a mesh, a ``MeshSpec`` or a
    ``MeshConfig`` (``cfg.mesh``); None is every rank on the data axis."""
    if isinstance(mesh, Mesh):
        return mesh
    spec = MeshSpec() if mesh is None else MeshSpec(mesh.data, mesh.model,
                                                    mesh.seq)
    return create_mesh(spec, device)


def any_rank(flag: bool, mesh: Mesh, device) -> bool:
    """True on every rank when ``flag`` is True on one (a SIGTERM)."""
    if not mesh.distributed:
        return flag
    t = torch.tensor([float(flag)], device=device)
    return bool(all_reduce_(t, torch.distributed.group.WORLD,
                            torch.distributed.ReduceOp.MAX).item())


def _timed(iterable, box: list):
    """Yield from ``iterable``, adding the seconds spent waiting for each
    item to ``box[0]``."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            with record_function("host_batch"):
                item = next(it)
        except StopIteration:
            return
        finally:
            box[0] += time.perf_counter() - t0
        yield item


def train_and_evaluate(cfg: Config, data, *, mesh=None,
                       logger: MetricsLogger | None = None,
                       checkpoints: bool = True, resume: bool = False,
                       profile_dir: str | None = None,
                       device=None) -> dict:
    """Installs the SIGTERM preemption handler (when checkpointing with
    ``train.preempt_save``) around :func:`_train_and_evaluate` and puts
    the previous handler back, even when training raises. See the inner
    function for the contract."""
    preempt = {"flag": False}
    prev_handler = None
    if checkpoints and cfg.train.preempt_save:
        import signal

        def _on_sigterm(signum, frame):
            preempt["flag"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not the main thread
            prev_handler = None
    try:
        return _train_and_evaluate(cfg, data, mesh=mesh, logger=logger,
                                   checkpoints=checkpoints, resume=resume,
                                   profile_dir=profile_dir, device=device,
                                   preempt=preempt)
    finally:
        if prev_handler is not None:
            import signal

            signal.signal(signal.SIGTERM, prev_handler)


def _train_and_evaluate(cfg: Config, data, *, mesh=None,
                        logger: MetricsLogger | None = None,
                        checkpoints: bool = True, resume: bool = False,
                        profile_dir: str | None = None, device=None,
                        preempt: dict | None = None) -> dict:
    """Train per config on a data source; returns a summary with the
    history, the best metric, the test metrics and the final state (the
    best epoch's weights where there was one).

    ``data`` provides ``num_classes``, ``train_batches(epoch_seed)``,
    ``eval_batches(split)`` ('valid', and 'test' if it has one) of
    (images, features, labels) host batches, and optionally
    ``device_transform(split, generator, batch)``. For a temporal model
    the batches are (clips (B,T,H,W,3), features (B,T,F), labels) and the
    logged ``images_per_sec`` counts clips.

    ``resume=True`` restores the latest checkpoint in
    ``cfg.train.checkpoint_dir`` with its optimizer state and loop
    trackers. ``profile_dir`` traces the second epoch with
    ``torch.profiler`` (the first is warm-up) into a Chrome trace there;
    the host's time is cut into ``host_batch``, ``to_device``,
    ``device_transform``, ``train_step`` and ``evaluate`` spans.

    On SIGTERM (``train.preempt_save``) the loop finishes the step in
    flight, checkpoints the state with its exact position in the epoch
    (completed batches and data-echo steps) and returns with
    ``summary["preempted"]=True``; a ``resume=True`` rerun re-enters that
    epoch, replays and discards the consumed batches of the epoch-seeded
    stream and goes on, so the final weights equal an uninterrupted run's
    where the device computes deterministically (the CPU does; cuDNN's
    default backward does not). The best-so-far weights are re-read from
    the best epoch's own checkpoint, and the resumed epoch's logged train
    loss covers only its post-resume steps.
    """
    device = resolve_device(device)
    mesh = as_mesh(mesh, device)
    main = mesh.is_main
    sharded = mesh.distributed
    accum = max(cfg.train.grad_accum, 1)
    logger = (logger or MetricsLogger()) if main else MetricsLogger(
        echo=False)
    prng = PRNG(cfg.train.seed)
    transform = getattr(data, "device_transform", None)

    sample = to_device(next(iter(data.train_batches(0))), device)
    if transform is not None:
        sample = transform("train", prng.named(0, "augment", device), sample)
    # (B,H,W,3) images or (B,T,H,W,3) clips: the width is the size
    model = get_model(cfg.model, image_size=sample[0].shape[-2],
                      seed=prng.seed_of(0, "init"))
    state, tx = create_train_state(model, cfg, device=device, mesh=mesh)
    stopper = EarlyStopping(cfg.train.early_stop_metric,
                            cfg.train.early_stop_patience,
                            cfg.train.early_stop_min_delta)
    # a separate best-tracker for SAVING: checkpoint_metric may differ
    # from the early-stop metric
    saver = EarlyStopping(cfg.train.checkpoint_metric, patience=0)
    plateau = Plateau(cfg.train.plateau_patience, cfg.train.plateau_factor,
                      cfg.train.plateau_min_lr,
                      mode="min" if "loss" in cfg.train.early_stop_metric
                      else "max")

    loop_state_path = os.path.join(cfg.train.checkpoint_dir,
                                   "loop_state.json")
    start_epoch = 0
    step_count = 0
    resume_skip_batches = 0  # fast-forward count for a mid-epoch resume
    resume_skip_echoes = 0
    best_state = None
    if resume and checkpoints:
        mgr = CheckpointManager(cfg.train.checkpoint_dir)
        latest = mgr.latest_step()
        if latest is not None:
            load_snapshot(state, mgr.restore(latest))
            start_epoch = latest + 1
            best_state = snapshot(state)   # the restored one is the best
            # loop trackers and the global step, so the first resumed
            # epoch is no fresh best and the generators go on
            if os.path.exists(loop_state_path):
                with open(loop_state_path) as f:
                    ls = json.load(f)
                if ls.get("epoch") == latest:
                    stopper.load_state_dict(ls["stopper"])
                    saver.load_state_dict(ls["saver"])
                    plateau.load_state_dict(ls["plateau"])
                    step_count = int(ls["step_count"])
                    if ls.get("preempt"):
                        # the latest checkpoint is a preemption snapshot,
                        # not the best: re-read the best epoch's own
                        best_ep = int(ls["saver"]["best_epoch"])
                        if best_ep == latest or best_ep < 0:
                            best_state = None
                        elif best_ep in mgr.all_steps():
                            best_state = mgr.restore(best_ep)
                        else:
                            best_state = None
                        if ls.get("batch_idx") is not None:
                            # mid-epoch snapshot: re-enter the SAME epoch
                            # past the batches consumed before it
                            start_epoch = latest
                            resume_skip_batches = int(ls["batch_idx"])
                            resume_skip_echoes = int(ls.get("echo_idx", 0))
            logger.log({"event": "resume", "from_epoch": latest,
                        "step_count": step_count})
    train_step = make_train_step(model, tx, cfg, mesh=mesh)
    eval_step = make_eval_step(model, cfg.model.num_classes,
                               cfg.train.label_smoothing)

    ckpt = None
    if checkpoints and main:
        # keep the best k by the checkpoint metric, so forced preemption
        # snapshots cannot evict the best epoch's weights
        mkey = ("val_loss" if "loss" in cfg.train.checkpoint_metric
                else "val_accuracy")
        ckpt = CheckpointManager(
            cfg.train.checkpoint_dir, best_fn=lambda m: m[mkey],
            best_mode="min" if mkey == "val_loss" else "max")
    if preempt is None:
        preempt = {"flag": False}

    def trackers(epoch: int) -> dict:
        return {"epoch": epoch, "step_count": step_count,
                "stopper": stopper.state_dict(),
                "saver": saver.state_dict(),
                "plateau": plateau.state_dict()}

    def preempt_checkpoint(epoch: int, batch_idx: int | None = None,
                           echo_idx: int = 0) -> None:
        """Snapshot the state and loop trackers. With ``batch_idx``
        (mid-epoch) a resume re-enters this epoch at that position;
        without it (the epoch finished) resume goes on at epoch + 1."""
        snap = snapshot(state) if checkpoints else None   # every rank
        if ckpt is not None:
            # remove the previous cycle's snapshot (saves without metrics
            # are never pruned) unless it IS the best epoch
            if os.path.exists(loop_state_path):
                with open(loop_state_path) as f:
                    prev = json.load(f)
                pe = prev.get("epoch")
                if (prev.get("preempt") and pe is not None and pe != epoch
                        and pe != saver.best_epoch):
                    ckpt.delete(pe)
            ckpt.save(epoch, snap, force=True)
            ls = {**trackers(epoch), "preempt": True}
            if batch_idx is not None:
                ls["batch_idx"] = batch_idx
                ls["echo_idx"] = echo_idx
            write_json(loop_state_path, ls)
        logger.log({"event": "preempt_save", "epoch": epoch,
                    "step_count": step_count})

    history = []
    prof = None
    for epoch in range(start_epoch, cfg.train.epochs):
        if profile_dir and epoch == start_epoch + 1 and prof is None:
            # trace the second epoch (the first is warm-up)
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        losses, accs, seen = [], [], 0
        waited = [0.0]   # seconds spent waiting for host batches
        echo = max(cfg.data.data_echo, 1)
        skip = resume_skip_batches if epoch == start_epoch else 0
        first_echo = resume_skip_echoes if epoch == start_epoch else 0
        pos_batch, pos_echo = skip, first_echo  # completed so far
        for bi, host_batch in enumerate(
                _timed(data.train_batches(epoch + 1), waited)):
            if bi < skip:
                continue  # consumed before preemption; replay-discard
            rows = None
            if sharded:   # this rank's rows of the global batch
                rows = mesh.row_shard(len(host_batch[2]), accum)
                host_batch = tuple(rows.take(x) for x in host_batch)
            with record_function("to_device"):
                batch = to_device(host_batch, device)
            # data echoing: each host batch drives `echo` steps, each with
            # a fresh augmentation and dropout stream
            echo_start = first_echo if bi == skip else 0
            for pos_echo in range(echo_start + 1, echo + 1):
                step_batch = batch
                if transform is not None:
                    with (record_function("device_transform"),
                          batch_rows(rows)):
                        step_batch = transform(
                            "train",
                            prng.named(step_count, "augment", device), batch)
                with record_function("train_step"):
                    state, m = train_step(
                        state, step_batch,
                        prng.named(step_count, "dropout", device))
                step_count += 1
                seen += int(step_batch[2].shape[0]) * mesh.shape[DATA_AXIS]
                preempt["flag"] = any_rank(preempt["flag"], mesh, device)
                losses.append(m["loss"])
                accs.append(m["accuracy"])
                if (cfg.train.log_every > 0
                        and step_count % cfg.train.log_every == 0):
                    logger.log({"step": step_count, "epoch": epoch,
                                "loss": float(m["loss"]),
                                "accuracy": float(m["accuracy"])})
                if preempt["flag"]:
                    break
            pos_batch = bi
            if preempt["flag"]:
                break
        if preempt["flag"]:
            # stop before validation: snapshot the state and the exact
            # position in the epoch, then exit
            if prof is not None:
                prof.stop()
                prof = None
                profile_dir = None
            if pos_echo >= echo:  # the interrupted batch finished
                pos_batch, pos_echo = pos_batch + 1, 0
            preempt_checkpoint(epoch, batch_idx=pos_batch,
                               echo_idx=pos_echo)
            break
        # leave NaN-guard-skipped steps out of the epoch means: one bad
        # step must not turn train_loss into NaN
        lv = (torch.stack(losses).double().cpu().numpy() if losses
              else np.zeros(0))
        av = (torch.stack(accs).double().cpu().numpy() if accs
              else np.zeros(0))
        ok = np.isfinite(lv)
        train_loss = float(lv[ok].mean()) if ok.any() else float("nan")
        train_acc = float(av[ok].mean()) if ok.any() else 0.0
        train_time = time.perf_counter() - t0

        with record_function("evaluate"):
            val = evaluate(eval_step, data.eval_batches("valid"), device,
                           transform=(None if transform is None else
                                      (lambda b: transform("valid", None,
                                                           b))), mesh=mesh)
        preempt["flag"] = any_rank(preempt["flag"], mesh, device)
        epoch_time = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(profile_dir, f"trace_epoch{epoch}.json"))
            prof = None
            profile_dir = None  # one traced epoch only

        current_lr = get_learning_rate(tx)
        record = {"epoch": epoch, "train_loss": train_loss,
                  "train_accuracy": train_acc, "val_loss": val["loss"],
                  "val_accuracy": val["accuracy"], "val_f1": val["f1"],
                  "lr": current_lr, "epoch_time_s": epoch_time,
                  "images_per_sec": seen / max(epoch_time, 1e-9),
                  "train_time_s": train_time,
                  "input_wait_s": waited[0], "steps": len(losses)}
        history.append(record)
        logger.log(record)

        monitored = (val["loss"] if "loss" in cfg.train.early_stop_metric
                     else val["accuracy"])
        stopper.update(monitored, epoch)
        ckpt_value = (val["loss"] if "loss" in cfg.train.checkpoint_metric
                      else val["accuracy"])
        saved_this_epoch = saver.update(ckpt_value, epoch)
        if saved_this_epoch:
            best_state = snapshot(state)
            if ckpt:
                ckpt.save(epoch, best_state,
                          metrics={"val_loss": val["loss"],
                                   "val_accuracy": val["accuracy"]})
        new_lr = plateau.update(monitored, current_lr)
        if new_lr is not None:
            logger.log({"event": "plateau_lr", "epoch": epoch,
                        "lr": new_lr})
            set_learning_rate(tx, new_lr)
        if ckpt and saved_this_epoch:
            # the trackers keyed to the saved checkpoint, written after the
            # plateau update so this epoch's LR decision is kept
            write_json(loop_state_path, trackers(epoch))
        if preempt["flag"]:
            # the signal came during validation: the epoch completed, and
            # a best-save at this step already holds state and trackers
            if not saved_this_epoch:
                preempt_checkpoint(epoch)
            else:
                logger.log({"event": "preempt_save", "epoch": epoch,
                            "step_count": step_count})
            break
        if stopper.should_stop:
            logger.log({"event": "early_stop", "epoch": epoch,
                        "best_epoch": stopper.best_epoch})
            break

    if best_state is not None:
        load_snapshot(state, best_state)
    summary = {"history": history, "best_epoch": stopper.best_epoch,
               "best_metric": float(stopper.best),
               "checkpoint_best": float(saver.best),
               "checkpoint_best_epoch": saver.best_epoch,
               "preempted": preempt["flag"], "state": state}

    try:
        test_batches = data.eval_batches("test")
    except (KeyError, ValueError):
        test_batches = None
    if test_batches is not None:
        test = evaluate(eval_step, test_batches, device,
                        transform=(None if transform is None else
                                   (lambda b: transform("test", None, b))),
                        mesh=mesh)
        logger.log({"event": "test", "test_loss": test["loss"],
                    "test_accuracy": test["accuracy"],
                    "test_precision": test["precision"],
                    "test_recall": test["recall"], "test_f1": test["f1"]})
        summary["test"] = test
    return summary
