"""Checkpoints of the full training state, with best-metric retention and
resume, mirroring ``surya_tpu/core/checkpoint.py`` (orbax there).

A checkpoint is one ``torch.save`` file per step, ``<dir>/<step>.pt``,
holding :func:`snapshot` of a ``TrainState``: the model's and the
optimizer's ``state_dict`` (moments and learning rate included), the
step count and the dropout generator's state, all on the CPU. Metrics go
beside it in ``<step>.metrics.json``. Both are written to a temporary
file and moved into place with ``os.replace``, the metrics first, so a
process killed during a save leaves the last complete step.

``save_params`` / ``load_params`` / ``load_checkpoint_variables`` move a
model's weights alone: the port's ``.pt`` state_dict, or a JAX variable
tree saved as a ``/``-keyed ``.npz`` (converted by ``models/from_jax.py``).
"""

from __future__ import annotations

import json
import os
import re

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def atomic_write(path: str, write) -> None:
    """``write(tmp)`` then ``os.replace(tmp, path)``: a reader sees the old
    file or the whole new one, never a part."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_json(path: str, obj: dict) -> None:
    """``obj`` as JSON at ``path``, written atomically."""
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f)

    atomic_write(path, write)


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree


def snapshot(state) -> dict:
    """A checkpoint-ready CPU copy of a ``TrainState``. A sharded state
    (``state.sharded``, on a mesh of several ranks) gives the same
    single-device form; every rank must call it (it gathers)."""
    if getattr(state, "sharded", False):
        from surya_tpu_torch.parallel.zero import full_snapshot

        return full_snapshot(state)
    return {"model": _cpu(state.model.state_dict()),
            "optimizer": _cpu(state.optimizer.state_dict()),
            "step": int(state.step),
            "generator": state.generator.get_state()}


def load_snapshot(state, snap: dict) -> None:
    """Put a :func:`snapshot` back into a ``TrainState``, in place (each
    rank its part of a sharded state)."""
    if getattr(state, "sharded", False):
        from surya_tpu_torch.parallel.zero import load_full_snapshot

        load_full_snapshot(state, snap)
        return
    state.model.load_state_dict(snap["model"], strict=True)
    state.optimizer.load_state_dict(snap["optimizer"])
    state.step = int(snap["step"])
    state.generator.set_state(snap["generator"])


class CheckpointManager:
    """Step-numbered checkpoints with 'best' + 'latest' retention."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 best_fn=None, best_mode: str = "max"):
        """With ``best_fn`` (metrics → float), retention keeps the best
        ``max_to_keep`` checkpoints BY METRIC, and every checkpoint saved
        without metrics (preemption snapshots), so a snapshot can never
        evict the best one. Without it, the latest ``max_to_keep``."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_fn = best_fn
        self.best_mode = best_mode
        for name in os.listdir(self.directory):   # an interrupted save
            if name.endswith(".tmp"):
                os.remove(os.path.join(self.directory, name))

    def _path(self, step: int, suffix: str = ".pt") -> str:
        return os.path.join(self.directory, f"{int(step)}{suffix}")

    def save(self, step: int, state: dict, metrics: dict | None = None,
             force: bool = False) -> None:
        """Write ``state`` (a :func:`snapshot`) as ``step``, replacing a
        checkpoint of the same step. ``force`` is accepted for orbax's
        signature: every save is written."""
        del force
        meta = self._path(step, ".metrics.json")
        if metrics is not None:
            write_json(meta, {k: float(v) for k, v in metrics.items()})
        elif os.path.exists(meta):
            os.remove(meta)
        atomic_write(self._path(step), lambda p: torch.save(state, p))
        self._prune()

    def metrics(self, step: int) -> dict | None:
        meta = self._path(step, ".metrics.json")
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            return json.load(f)

    def _prune(self) -> None:
        steps = self.all_steps()
        if self.best_fn is None:
            drop = steps[:-self.max_to_keep] if self.max_to_keep else []
        else:
            scored = [(self.best_fn(m), s) for s in steps
                      if (m := self.metrics(s)) is not None]
            scored.sort(reverse=self.best_mode == "max")
            drop = [s for _, s in scored[self.max_to_keep:]]
        for s in drop:
            self.delete(s)

    def restore(self, step: int | None = None) -> dict:
        """The snapshot saved at ``step`` (default: the latest), on the
        CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def delete(self, step: int) -> None:
        """Drop one step (used to remove stale preemption snapshots)."""
        for suffix in (".pt", ".metrics.json"):
            try:
                os.remove(self._path(step, suffix))
            except FileNotFoundError:
                pass

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _STEP_FILE.match(name)))

    def wait(self) -> None:
        """Saves are synchronous; kept for the orbax manager's API."""

    def close(self) -> None:
        """Nothing is held open; kept for the orbax manager's API."""


def save_params(path: str, state_dict: dict) -> None:
    """A weights-only ``.pt`` (the reference's state_dict artifact)."""
    atomic_write(os.path.abspath(path),
                  lambda p: torch.save(_cpu(dict(state_dict)), p))


def load_params(path: str) -> dict:
    """The port's state_dict from a ``.pt`` (``save_params``, any
    ``model.state_dict()``, or a ``CheckpointManager`` step file) or from
    a JAX variable tree saved as ``.npz`` with ``/``-joined keys."""
    if path.endswith(".npz"):
        from surya_tpu_torch.models.from_jax import (
            from_jax_variables,
            load_npz_variables,
        )

        return from_jax_variables(load_npz_variables(path))
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        # a CheckpointManager step file holds a whole snapshot
        return sd["model"] if "optimizer" in sd else sd
    raise ValueError(f"checkpoint must be a .npz (JAX variables), a .pt "
                     f"(port state_dict) or a checkpoint directory, got "
                     f"{path!r}")


def load_checkpoint_variables(path: str) -> dict:
    """The model state_dict from a ``CheckpointManager`` directory (its
    latest step), a ``.pt`` or a JAX ``.npz``."""
    if os.path.isdir(path):
        return CheckpointManager(path).restore()["model"]
    return load_params(path)
