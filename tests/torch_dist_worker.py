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


# ---------------------------------------------------------------------------
# FACT's parallel variants: ring attention, the pipeline, expert parallelism
# ---------------------------------------------------------------------------

def qkv_of(spec: dict, dtype=np.float32):
    """(q, k, v) of shape ``spec["qkv"]`` (B, T, H, D), from
    ``spec["seed"]``."""
    rng = np.random.default_rng(spec.get("seed", 0))
    return tuple(rng.normal(size=spec["qkv"]).astype(dtype)
                 for _ in range(3))


def ring_cases(spec: dict) -> dict:
    """``ring_attention`` over a 'seq' axis of every rank, each case of
    ``spec["cases"]`` (name → keyword arguments: ``causal``, ``pad_keys``
    (the last keys masked), ``bias``, ``bf16``, ``dropout``, ``grad``) →
    the output, the q/k/v gradients of ``sum(out²)`` with ``grad``, and
    the bytes shifted around the ring."""
    from surya_tpu_torch.core import mesh as cmesh
    from surya_tpu_torch.parallel.ring_attention import ring_attention

    mesh = cmesh.create_mesh({"seq": spec.get("world", 1)}, device="cpu")
    out = {}
    for name, case in spec["cases"].items():
        q, k, v = (torch.from_numpy(a) for a in qkv_of(
            {**spec, **case.get("shape", {})}))
        t = q.shape[1]
        if case.get("bf16"):
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        if case.get("grad"):
            q, k, v = (x.requires_grad_() for x in (q, k, v))
        kw = {}
        if case.get("causal"):
            kw["mask"] = torch.tril(torch.ones(t, t, dtype=torch.bool))
        if case.get("pad_keys"):
            keep = torch.arange(t) < t - case["pad_keys"]
            kw["mask"] = keep[None, None, None, :]
        if case.get("bias"):
            rng = np.random.default_rng(7)
            kw["bias"] = torch.from_numpy(
                rng.normal(size=(1, q.shape[2], t, t)).astype(np.float32))
        if case.get("dropout"):
            kw.update(dropout_rate=case["dropout"],
                      generator=torch.Generator().manual_seed(case["seed"]),
                      broadcast_dropout=case.get("broadcast", True))
        before = cmesh.collective_bytes["ppermute"]
        o = ring_attention(q, k, v, mesh, **kw)
        row = {"out": o.detach().float(),
               "ppermute_bytes": cmesh.collective_bytes["ppermute"] - before}
        if case.get("grad"):
            (o.float() ** 2).sum().backward()
            row["grads"] = [x.grad for x in (q, k, v)]
        out[name] = row
    return out


def fact_inputs(spec: dict):
    """FACT's global batch: (B, T, S, S, 3) clips, (B, T, 47) features and
    labels from ``spec["seed"]``."""
    rng = np.random.default_rng(spec.get("seed", 0))
    b, t, s = spec["batch"], spec["seq_len"], spec["size"]
    return (rng.normal(size=(b, t, s, s, 3)).astype(np.float32),
            rng.normal(size=(b, t, 47)).astype(np.float32),
            rng.integers(0, spec["classes"], b).astype(np.int64))


def fact_form(spec: dict) -> dict:
    """A small FACT (``spec["model"]``, weights from ``spec["weights"]``) in
    one of its parallel forms on the mesh ``spec["mesh"]`` (the plain model
    without one) → its logits and the cross-entropy's gradients of every
    parameter in the single-device form (split leaves gathered, every
    pipeline stage's layers), with the aux term for FACT-MoE.

    ``form``: "plain"; "sp" (``cp_mesh``); "pp" (``fact_apply_pipelined``,
    ``spec["microbatches"]``, each stage holding only its layers, the batch
    over 'data' when the mesh has one; ``spec["tp"]`` splits the weights
    over 'model' at 1024 elements and ``spec["zero1"]`` takes one ZeRO-1
    AdamW step); "ep" (``moe_mesh``). ``spec["train"]`` runs train mode on
    ``torch.Generator().manual_seed(spec["train"])``."""
    from surya_tpu_torch.core import mesh as cmesh
    from surya_tpu_torch.models.losses import cross_entropy
    from surya_tpu_torch.models.temporal.fact import (
        FactModel,
        fact_apply_pipelined,
    )
    from surya_tpu_torch.parallel import moe as tmoe
    from surya_tpu_torch.parallel import pipeline, zero

    form = spec["form"]
    mesh = cmesh.create_mesh(spec.get("mesh", {}), device="cpu")
    kw = dict(spec["model"], dtype=torch.float32)
    if form == "sp":
        kw["cp_mesh"] = mesh
    if form == "ep":
        kw["moe_mesh"] = mesh
    model = FactModel(**kw)
    full = torch.load(spec["weights"])
    if form == "pp":
        pipeline.keep_stage_layers(model, "fusion", model.num_layers, mesh)
        full = {k: v for k, v in full.items() if k in model.state_dict()}
    zero.load_full_model_state(model, full, mesh)
    if spec.get("tp"):
        from surya_tpu_torch.parallel.sharding import partition_params

        partition_params(model, mesh, min_elements=1024)
    model.train(bool(spec.get("train")))
    gen = (torch.Generator().manual_seed(spec["train"])
           if spec.get("train") else None)
    images, feats, labels = (torch.from_numpy(a) for a in fact_inputs(spec))
    before = dict(cmesh.collective_bytes)
    rows = None
    if form == "pp":
        logits = fact_apply_pipelined(
            model, images, feats, mesh, num_microbatches=spec["microbatches"],
            batch_spec="data" if mesh.shape["data"] > 1 else None,
            generator=gen)
        if mesh.shape["data"] > 1:
            rows = mesh.row_shard(spec["batch"], spec["microbatches"])
            labels = rows.take(labels)
    else:
        logits = model(images, feats, gen)
    aux = sum((m.aux_loss for m in model.modules()
               if isinstance(m, tmoe.MoEFFN) and m.aux_loss is not None),
              torch.zeros(()))
    loss = cross_entropy(logits.float(), labels) + aux
    loss.backward()
    moved = {k: cmesh.collective_bytes[k] - before[k] for k in before}
    if rows is not None:   # the data-parallel step's average
        for p in model.parameters():
            if p.grad is not None:
                cmesh.all_reduce_(p.grad, mesh.group("data")).div_(
                    rows.ranks)
        loss = cmesh.all_reduce_(loss.detach().clone(),
                                 mesh.group("data")) / rows.ranks
    grads = zero.full_gradients(model)
    expert_bytes = sum(p.numel() * p.element_size() for n, p in
                       model.named_parameters()
                       if n.rpartition(".")[2] in tmoe.EXPERT_LEAVES)
    out = {"logits": logits.detach(), "loss": float(loss.detach()),
           "aux": float(aux.detach()),
           "rows": None if rows is None else rows.spans,
           "bytes": moved, "expert_bytes": expert_bytes,
           "expert_leaves": sum(bool(s) for s in tmoe.expert_shardings(
               model, mesh).values())}
    if form == "pp":
        grads = pipeline.gather_stages(grads, "fusion", model.num_layers,
                                       mesh)
        out["state"] = pipeline.gather_stages(
            zero.full_model_state(model, mesh), "fusion", model.num_layers,
            mesh)
    else:
        out["state"] = zero.full_model_state(model, mesh)
    out["grads"] = grads
    if spec.get("zero1"):
        from torch.distributed.optim import ZeroRedundancyOptimizer

        opt = ZeroRedundancyOptimizer(
            [p for p in model.parameters() if p.grad is not None],
            optimizer_class=torch.optim.AdamW,
            process_group=mesh.group("data"), lr=1e-3, weight_decay=1e-4)
        opt.step()
        out["moment_leaves"] = sum(len(st) > 0 for st in
                                   opt.optim.state.values())
        out["stepped"] = pipeline.gather_stages(
            zero.full_model_state(model, mesh), "fusion", model.num_layers,
            mesh)
    return out


def mesh_rules(spec: dict) -> dict:
    """``ppermute`` and the two gradient rules of ``core/mesh.py`` over every
    rank, on rank-dependent values: each result and its input's gradient
    of ``sum(result · c)`` (``c`` the rank's own weights for the ranked
    forms, the same on every rank for the replicated ones)."""
    from surya_tpu_torch.core import mesh as cmesh

    group = dist.group.WORLD
    me, n = dist.get_rank(), dist.get_world_size()
    own = torch.arange(6.0) + 10 * me                 # differs per rank
    same = torch.arange(6.0 * n).reshape(n * 2, 3)    # replicated
    out = {}
    for name, (fn, x, c) in {
            "ppermute": (lambda t: cmesh.ppermute(t, group, 1), own,
                         own + 1),
            "ppermute_back": (lambda t: cmesh.ppermute(t, group, -1), own,
                              own * 2),
            "split": (lambda t: cmesh.split(t, group, 0), same,
                      own[:6].reshape(2, 3)),
            "split_whole": (lambda t: cmesh.split(t, group), same,
                            same * (me + 1)),
            "gather": (lambda t: cmesh.gather(t, group, 0),
                       own.reshape(2, 3), same),
            "combine_sum": (lambda t: cmesh.combine_sum(t, group), own,
                            torch.ones(6) * 3)}.items():
        x = x.clone().requires_grad_()
        y = fn(x)
        (y * c).sum().backward()
        out[name] = {"y": y.detach(), "grad": x.grad, "x": x.detach(),
                     "c": c}
    return out


def fact_moe_step(spec: dict) -> dict:
    """One ``fact`` train step (f32, dropout 0, clip ``spec["clip"]``) of the
    FACT-MoE ``spec["model"]`` from ``spec["weights"]``, expert-parallel
    over the mesh's 'expert' axis when it has one → the loss and the
    single-device snapshot (expert leaves and their moments gathered)."""
    from surya_tpu_torch.core.checkpoint import snapshot
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.core.mesh import create_mesh
    from surya_tpu_torch.models.temporal.fact import FactModel
    from surya_tpu_torch.parallel.zero import load_full_model_state
    from surya_tpu_torch.train.steps import (
        create_train_state,
        make_train_step,
    )

    cfg = get_preset("fact").override({
        "model.compute_dtype": "float32", "model.dropout": "0.0",
        "train.grad_clip": str(spec["clip"]), "train.lr": "1e-3"})
    mesh = create_mesh(spec.get("mesh", {}), device="cpu")
    model = FactModel(dtype=torch.float32, moe_mesh=mesh, **spec["model"])
    load_full_model_state(model, torch.load(spec["weights"]), mesh)
    state, tx = create_train_state(model, cfg, device="cpu", mesh=mesh)
    state, metrics = make_train_step(model, tx, cfg, mesh=mesh)(
        state, fact_inputs(spec))
    return {"loss": float(metrics["loss"]), "snap": snapshot(state)}
