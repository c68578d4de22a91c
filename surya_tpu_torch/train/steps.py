"""The train and eval steps, mirroring ``surya_tpu/train/steps.py``.

One train step is forward (compute dtype over f32 parameters), f32 loss,
backward, global-norm clip, AdamW update and the BN running-stat update.
PyTorch runs it eagerly; the state is updated **in place** (parameters,
optimizer moments, BN buffers, the step count) and handed back, where JAX
returns a new state.

Rules carried over from JAX:

- **Optimizer.** optax ``adamw`` decays every trainable leaf, BN scales and
  biases included, so ``torch.optim.AdamW`` gets one group, ``eps=1e-8``
  and ``weight_decay`` set explicitly.
- **Clipping** runs before the update over the trainable gradients only,
  as optax ``clip_by_global_norm``: ``g · clip / max(norm, clip)``.
- **Freezing.** Frozen parameters get ``requires_grad=False`` and stay out
  of the optimizer, so no backward is built for a frozen trunk. A frozen
  *spatial* trunk keeps its BN in train mode (running statistics go on
  moving), as the reference's ``model.train()`` does; a frozen *temporal*
  trunk keeps its BN in inference mode, as JAX's temporal families do
  (``CnnLstm.train`` keeps its trunk in eval mode).
- **Batches** are (images NHWC, features, labels) for the spatial
  families and (clips (B,T,H,W,3), features (B,T,F), labels) for the
  temporal ones; the step is the same.
- **NaN guard.** A non-finite loss leaves parameters, optimizer state and
  BN running statistics as they were; the step count still advances. BN
  buffers change during the forward, so the step keeps a copy of them and
  puts it back. Reading the loss on the host costs one synchronisation per
  step (JAX selects on the device instead).
- **grad_accum.** Microbatches in order, BN statistics updated one after
  the other, a fresh dropout draw each, gradients and loss averaged, one
  optimizer update.
- **remat.** ``torch.utils.checkpoint`` around the model call; the dropout
  generator is set back for the recomputation so it draws the same masks,
  and the BN buffers are put back so they move once, not twice.

Dropout draws come from the state's ``torch.Generator`` (the counterpart
of JAX's per-step ``rng``), never from the global one.

**On a mesh** (``core/mesh.py``, one process per device under
``torchrun``) the step is the single-device step on the global batch, as
JAX's one jitted program over a sharded batch is. Each rank takes its
rows (``shard_batch``, per microbatch under ``grad_accum``) and runs them
under :func:`core.mesh.batch_rows`, so BatchNorm merges its statistics
over the data axis and dropout and the head's Philox bits are the global
batch's rows. After the backward one bucketed ``all_reduce`` averages the
trainable gradients over 'data' (FSDP2 reduce-scatters its own). The clip
reads the global norm; the loss and accuracy are global means, so every
rank's NaN guard takes the same branch. ``create_train_state(mesh=)``
shards the state (``parallel/zero.py``: the TP rule, ZeRO-1 or FSDP2).

**Auxiliary losses.** A module may leave a scalar in ``aux_loss`` during a
train-mode forward (the MoE FFN's load-balancing term,
``parallel/moe.py``); the step adds every one to the objective, as JAX's
adds every sown ``losses`` entry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from surya_tpu_torch.core.config import Config
from surya_tpu_torch.core.mesh import (
    DATA_AXIS,
    all_reduce_,
    batch_rows,
)
from surya_tpu_torch.models.backbones import trunk_channels_last
from surya_tpu_torch.models.losses import cross_entropy_per_sample
from surya_tpu_torch.ops import resolve_device


@dataclasses.dataclass
class TrainState:
    """What a run carries from step to step. ``generator`` is the dropout
    stream, on the model's device."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    # a sharded state: its mesh, and the optimizer's parameters by their
    # single-device names in order (a checkpoint's layout)
    mesh: object = None
    param_names: tuple = ()

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.mesh.distributed


# ---------------------------------------------------------------------------
# Freezing rules
# ---------------------------------------------------------------------------

# Models whose backbone is frozen EXCEPT layer4 (the reference unfreezes
# r3d_18.layer4 for fine-tuning).
_PARTIAL_UNFREEZE = {"resnet3d_video", "hybrid_quadtree_3d"}
_BACKBONE_KEYS = ("trunk", "vit_backbone")


def trainable_mask(model: torch.nn.Module, model_name: str,
                   freeze_backbone: bool) -> dict[str, bool]:
    """Parameter name → True if trainable. Mirrors the JAX freeze rules."""
    out = {}
    for name, _ in model.named_parameters():
        path = name.split(".")
        trainable = True
        if freeze_backbone and path[0] in _BACKBONE_KEYS:
            trainable = False
            if model_name in _PARTIAL_UNFREEZE and any(
                    "layer4" in p for p in path):
                trainable = True
        out[name] = trainable
    return out


def freeze(cfg: Config, model: torch.nn.Module) -> list[str]:
    """Set ``requires_grad`` from :func:`trainable_mask` → the trainable
    parameters' names, in order."""
    mask = trainable_mask(model, cfg.model.name, cfg.model.freeze_backbone)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return [name for name in mask if mask[name]]


def make_optimizer(cfg: Config, model: torch.nn.Module):
    """AdamW over the trainable parameters. Sets ``requires_grad`` from
    :func:`trainable_mask`, so frozen parameters get no gradient, no update
    and no weight decay."""
    names = set(freeze(cfg, model))
    params = [p for name, p in model.named_parameters() if name in names]
    return torch.optim.AdamW(params, lr=cfg.train.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.train.weight_decay)


def set_learning_rate(optimizer, lr: float) -> None:
    """Plateau-LR support: rewrite the learning rate in place."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: ``g · c / max(‖g‖, c)``,
    computed on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))


# ---------------------------------------------------------------------------
# State creation + steps
# ---------------------------------------------------------------------------

def create_train_state(model: torch.nn.Module, cfg: Config, rng=None,
                       device=None, mesh=None):
    """Move ``model`` (already initialised, e.g. by ``get_model``) to the
    device — the card unless ``device="cpu"`` — and build its optimizer and
    dropout stream → ``(state, tx)``. ``rng`` seeds the dropout generator
    (default ``cfg.train.seed``). With a ``mesh`` of several ranks the
    state is sharded (``parallel.zero.parallelize``); every rank must
    start from the same weights."""
    device = resolve_device(device)
    model = model.to(device)
    trunk_channels_last(model)   # cuDNN convs without a re-layout
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.train.seed if rng is None else int(rng))
    if mesh is None or not mesh.distributed:
        tx = make_optimizer(cfg, model)
        return TrainState(model, tx, 0, generator), tx
    from surya_tpu_torch.parallel.zero import parallelize

    names = freeze(cfg, model)
    tx = parallelize(model, cfg, mesh, names)
    return TrainState(model, tx, 0, generator, mesh, tuple(names)), tx


def to_device(batch, device):
    """(images, feats, labels) as numpy arrays or tensors → tensors on
    ``device``, labels int64 (an asynchronous copy from pinned memory)."""
    images, feats, labels = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in batch)
    return (images.to(device, non_blocking=True),
            feats.to(device, non_blocking=True),
            labels.to(device, non_blocking=True).long())


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _aux_modules(model: torch.nn.Module) -> list:
    return [m for m in model.modules() if hasattr(m, "aux_loss")]


def take_aux_loss(modules) -> torch.Tensor | float:
    """The sum of the auxiliary losses the last forward left (each taken
    once), 0 without any."""
    total = 0.0
    for m in modules:
        if m.aux_loss is not None:
            total = total + m.aux_loss
            m.aux_loss = None
    return total


def all_reduce_grads_(params, group, parts: int) -> None:
    """Average the gradients over the data axis: one bucketed ``all_reduce``
    per dtype of the flattened gradients."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat, group).div_(parts)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])


def make_train_step(model: torch.nn.Module, tx, cfg: Config, mesh=None,
                    state_shardings=None) -> Callable:
    """Build the train step: ``(state, batch, generator=None) → (state,
    metrics)``. ``batch`` is ``(images NHWC, feats, labels)`` as numpy
    arrays or tensors (tensors already on the device are not copied);
    ``generator`` overrides the state's dropout stream for this step.
    ``metrics`` holds ``loss`` and ``accuracy`` as 0-d tensors.

    With a ``mesh`` of several ranks the batch is this rank's rows of the
    global batch (``core.mesh.shard_batch(mesh, batch, grad_accum)``) and
    the step is the single-device step on the global batch (module
    docstring); the state must come from ``create_train_state(mesh=)``.
    ``state_shardings`` is accepted for JAX's signature: the state's own
    layout is the one kept."""
    del state_shardings
    smoothing = cfg.train.label_smoothing
    nan_guard = cfg.train.nan_guard
    clip = cfg.train.grad_clip
    remat = cfg.train.remat
    accum = max(cfg.train.grad_accum, 1)
    buffers = list(model.buffers())   # the BN running statistics
    aux_modules = _aux_modules(model)
    sharded = mesh is not None and mesh.distributed
    params = [p for group in tx.param_groups for p in group["params"]]
    if sharded:
        from surya_tpu_torch.parallel.zero import (
            global_grad_sq_norm,
            sharded_param_groups,
        )

        split_groups = sharded_param_groups(model)
        data_group, fsdp = mesh.group(DATA_AXIS), cfg.train.fsdp
    parts = mesh.shape[DATA_AXIS] if sharded else 1

    def forward(images, feats, generator, rows):
        if not remat:
            return model(images, feats, generator)
        rng_state = generator.get_state()

        def run(im, ft):   # the recomputation starts from the same state
            generator.set_state(rng_state)
            with batch_rows(rows):
                return model(im, ft, generator)

        return checkpoint(run, images, feats, use_reentrant=False,
                          preserve_rng_state=False)

    def clip_grads():
        grads = [p.grad for p in params if p.grad is not None]
        if not sharded:
            clip_by_global_norm_(grads, clip)
            return
        norm = global_grad_sq_norm(params, split_groups, mesh).sqrt()
        local = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
        torch._foreach_mul_(local, clip / torch.clamp(norm, min=clip))

    def step(state: TrainState, batch, generator=None):
        generator = state.generator if generator is None else generator
        images, feats, labels = to_device(batch, _model_device(model))
        n = labels.shape[0]
        if n % accum:
            raise ValueError(
                f"batch size {n} not divisible by grad_accum={accum}")
        micro = n // accum
        # the rows of each global microbatch this rank holds
        rows = mesh.row_shard(micro * parts) if sharded else None
        total = n * parts
        model.train()
        saved = [b.clone() for b in buffers] if nan_guard else None
        tx.zero_grad(set_to_none=True)
        ce_sum = correct = aux_sum = 0.0
        for i in range(accum):
            part = slice(i * micro, (i + 1) * micro)
            with batch_rows(rows):
                logits = forward(images[part], feats[part], generator, rows)
            aux = take_aux_loss(aux_modules)
            ce = cross_entropy_per_sample(logits.float(), labels[part],
                                          smoothing)
            moved = [b.clone() for b in buffers] if remat else None
            ((ce.mean() + aux) / accum).backward()
            take_aux_loss(aux_modules)   # the recomputation's, if any
            if remat and buffers:   # the recomputation moved them again
                torch._foreach_copy_(buffers, moved)
            ce_sum = ce_sum + ce.detach().sum()
            aux_sum = aux_sum + (aux.detach() if torch.is_tensor(aux)
                                 else aux)
            correct = correct + (logits.argmax(-1) == labels[part]).sum()
        sums = torch.stack([torch.as_tensor(ce_sum, dtype=torch.float32),
                            torch.as_tensor(correct, dtype=torch.float32)
                            .to(labels.device)])
        if sharded:
            if not fsdp:
                all_reduce_grads_(params, data_group, parts)
            all_reduce_(sums, data_group)
        loss = sums[0] / total + aux_sum / accum

        if nan_guard and not bool(torch.isfinite(loss)):   # host sync
            if buffers:
                torch._foreach_copy_(buffers, saved)
        else:
            if clip > 0:
                clip_grads()
            tx.step()
        tx.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss, "accuracy": sums[1] / total}

    return step


def make_eval_step(model: torch.nn.Module, num_classes: int,
                   label_smoothing: float = 0.0) -> Callable:
    """``batch → dict`` of tensors: ``loss_sum``, ``correct``, ``count``
    and the ``confusion`` matrix (true class × predicted class).

    Rows with label < 0 are padding and are masked out of every statistic,
    so eval metrics are exact on any split size."""

    @torch.no_grad()
    def step(batch):
        images, feats, labels = to_device(batch, _model_device(model))
        model.eval()
        logits = model(images, feats).float()
        valid = labels >= 0
        safe = labels.clamp(min=0)
        per = cross_entropy_per_sample(logits, safe, label_smoothing)
        preds = logits.argmax(-1)
        cm = torch.zeros(num_classes * num_classes, dtype=torch.int64,
                         device=logits.device)
        cm.index_add_(0, safe * num_classes + preds, valid.long())
        return {"loss_sum": (per * valid.float()).sum(),
                "correct": ((preds == safe) & valid).sum().int(),
                "count": valid.sum().int(),
                "confusion": cm.reshape(num_classes, num_classes).int()}

    return step
