"""Multi-process runs for the port's parallel tests (gloo on the CPU).

:func:`run` spawns ``world`` processes, each with one torch thread and a
process group initialised through a ``FileStore`` in the test's own
directory (no TCP port, so parallel test workers cannot collide), calls
one of this module's functions in each and returns every rank's result.
This module imports nothing of JAX, so the children start quickly; a
test compares the results with the one-process run of the same function
(``torch.distributed`` not initialised: the single-device step).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(jobs, world: int, tmp) -> list:
    """``jobs``, a list of (function of this module, spec), one after the
    other in the same ``world`` gloo ranks → per job, the ranks' results."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    names = [(fn.__name__, spec) for fn, spec in jobs]
    mp.spawn(_entry, args=(world, tmp, names), nprocs=world, join=True)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False) for r in range(world)]
    return [[r[j] for r in ranks] for j in range(len(jobs))]


def _entry(rank, world, tmp, jobs):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        out = [globals()[name](spec) for name, spec in jobs]
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def overrides(spec: dict) -> dict:
    """The dotted overrides of :func:`tiny_config` (JAX's config takes the
    same ones)."""
    return {"model.num_classes": "4", "model.compute_dtype": "float32",
            "model.dropout": str(spec.get("dropout", 0.5)),
            "train.lr": "1e-3", "train.weight_decay": "1e-4",
            "train.grad_clip": str(spec.get("clip", 1.0)),
            "train.zero1": str(spec.get("zero1", False)).lower(),
            "train.fsdp": str(spec.get("fsdp", False)).lower(),
            "train.grad_accum": str(spec.get("accum", 1)),
            "train.remat": str(spec.get("remat", False)).lower(),
            **spec.get("overrides", {})}


def tiny_config(spec: dict):
    """A small quadtree (or FACT) config from ``spec``: f32, 4 classes."""
    from surya_tpu_torch.core.config import get_preset

    return get_preset(spec.get("preset", "quadtree-fusion")).override(
        overrides(spec))


def batch_of(spec: dict):
    """The global batch: spatial (B, S, S, 3) images or (B, T, S, S, 3)
    clips, features and labels, from ``spec["seed"]`` with numpy."""
    rng = np.random.default_rng(spec.get("seed", 0))
    n, s = spec["batch"], spec["size"]
    lead = (n, spec["seq_len"]) if spec.get("seq_len") else (n,)
    return (rng.normal(size=lead + (s, s, 3), scale=0.5).astype(np.float32),
            rng.normal(size=lead + (47,)).astype(np.float32),
            rng.integers(0, 4, size=(n,)).astype(np.int64))


def train_steps(spec: dict) -> dict:
    """``spec["steps"]`` train steps of a tiny model from seed 0 on the
    global batch (this rank's rows of it on a mesh) → the losses, the
    accuracies and the single-device snapshot of the final state."""
    from surya_tpu_torch.core.checkpoint import snapshot
    from surya_tpu_torch.core.mesh import MeshSpec, create_mesh, shard_batch
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.train.steps import (
        create_train_state,
        make_train_step,
    )

    cfg = tiny_config(spec)
    mesh = create_mesh(MeshSpec(**spec.get("mesh", {})), device="cpu")
    model = get_model(cfg.model, image_size=spec["size"], seed=0)
    if spec.get("weights"):   # e.g. JAX's initial state, converted
        model.load_state_dict(torch.load(spec["weights"]), strict=True)
    if spec.get("apply_zero1"):   # a one-device state, then ZeRO-1
        from surya_tpu_torch.parallel import apply_zero1

        state, _ = create_train_state(model, cfg, rng=7, device="cpu")
        state, _ = apply_zero1(state, mesh)
        tx = state.optimizer
    else:
        state, tx = create_train_state(model, cfg, rng=7, device="cpu",
                                       mesh=mesh)
    step = make_train_step(model, tx, cfg, mesh=mesh)
    batch = batch_of(spec)
    if mesh.distributed:
        batch = shard_batch(mesh, batch, max(cfg.train.grad_accum, 1))
    losses, accs = [], []
    for _ in range(spec.get("steps", 1)):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return {"losses": losses, "accuracy": accs, "snap": snapshot(state),
            "mesh": dict(mesh.shape)}


def moe_forward(spec: dict) -> dict:
    """A tiny ``MoEFFN`` (seed 0) on this rank's rows of a (B, T, d) batch
    in train mode → its rows' output, the aux term and the router's
    gradient of ``out.sum() + aux``, taken as the train step takes it: each
    rank's objective counts its rows once per rank and the aux term once,
    and the gradients are averaged over the data axis."""
    from surya_tpu_torch.core.mesh import (
        DATA_AXIS,
        MeshSpec,
        all_reduce_,
        batch_rows,
        create_mesh,
    )
    from surya_tpu_torch.models.common import seeded
    from surya_tpu_torch.parallel.moe import MoEFFN

    mesh = create_mesh(MeshSpec(**spec.get("mesh", {})), device="cpu")
    moe = seeded(lambda: MoEFFN(spec["dim"], spec["experts"], spec["ff"],
                                spec["top_k"], spec["capacity_factor"],
                                dtype=torch.float32), 0, "cpu").train()
    rng = np.random.default_rng(spec.get("seed", 0))
    x = torch.from_numpy(rng.normal(size=(spec["batch"], spec["tokens"],
                                          spec["dim"])).astype(np.float32))
    rows = mesh.row_shard(spec["batch"]) if mesh.distributed else None
    ranks = 1 if rows is None else rows.ranks
    with batch_rows(rows):
        xs = x if rows is None else rows.take(x)
        out = moe(xs)
        (out.sum() * ranks + moe.aux_loss).backward()
    grad = moe.router.grad
    if rows is not None:
        all_reduce_(grad, mesh.group(DATA_AXIS)).div_(ranks)
    return {"out": out.detach(), "aux": float(moe.aux_loss.detach()),
            "router_grad": grad}


def predict(spec: dict) -> dict:
    """``Predictor(mesh=)`` of a tiny quadtree (seed 0) on the global batch:
    every rank's preds and probs."""
    from surya_tpu_torch.core.mesh import MeshSpec, create_mesh
    from surya_tpu_torch.infer.serve import Predictor
    from surya_tpu_torch.models import get_model

    cfg = tiny_config(spec)
    mesh = create_mesh(MeshSpec(**spec.get("mesh", {})), device="cpu")
    model = get_model(cfg.model, image_size=spec["size"], seed=0)
    pred = Predictor(cfg.model, model.state_dict(), batch_size=spec["chunk"],
                     image_size=spec["size"], mesh=mesh, device="cpu")
    images, feats, _ = batch_of(spec)
    preds, probs = pred.predict(images, feats)
    return {"preds": preds, "probs": probs}
