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
of JAX's per-step ``rng``), never from the global one. The sharded variants
(``zero1``, ``fsdp``, a mesh) are ROADMAP A11.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from surya_tpu_torch.core.config import Config
from surya_tpu_torch.models.backbones import trunk_channels_last
from surya_tpu_torch.models.losses import (
    cross_entropy,
    cross_entropy_per_sample,
)
from surya_tpu_torch.ops import resolve_device


@dataclasses.dataclass
class TrainState:
    """What a run carries from step to step. ``generator`` is the dropout
    stream, on the model's device."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


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


def make_optimizer(cfg: Config, model: torch.nn.Module):
    """AdamW over the trainable parameters. Sets ``requires_grad`` from
    :func:`trainable_mask`, so frozen parameters get no gradient, no update
    and no weight decay."""
    mask = trainable_mask(model, cfg.model.name, cfg.model.freeze_backbone)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
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
                       device=None):
    """Move ``model`` (already initialised, e.g. by ``get_model``) to the
    device — the card unless ``device="cpu"`` — and build its optimizer and
    dropout stream → ``(state, tx)``. ``rng`` seeds the dropout generator
    (default ``cfg.train.seed``)."""
    device = resolve_device(device)
    model = model.to(device)
    trunk_channels_last(model)   # cuDNN convs without a re-layout
    tx = make_optimizer(cfg, model)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.train.seed if rng is None else int(rng))
    return TrainState(model, tx, 0, generator), tx


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


def make_train_step(model: torch.nn.Module, tx, cfg: Config, mesh=None,
                    state_shardings=None) -> Callable:
    """Build the train step: ``(state, batch, generator=None) → (state,
    metrics)``. ``batch`` is ``(images NHWC, feats, labels)`` as numpy
    arrays or tensors (tensors already on the device are not copied);
    ``generator`` overrides the state's dropout stream for this step.
    ``metrics`` holds ``loss`` and ``accuracy`` as 0-d tensors."""
    if (mesh is not None or state_shardings is not None or cfg.train.zero1
            or cfg.train.fsdp):
        raise NotImplementedError(
            "sharded training (mesh, zero1, fsdp) is not ported yet: "
            "ROADMAP A11 (parallelism)")
    smoothing = cfg.train.label_smoothing
    nan_guard = cfg.train.nan_guard
    clip = cfg.train.grad_clip
    remat = cfg.train.remat
    accum = max(cfg.train.grad_accum, 1)
    buffers = list(model.buffers())   # the BN running statistics

    def forward(images, feats, generator):
        if not remat:
            return model(images, feats, generator)
        rng_state = generator.get_state()

        def run(im, ft):   # the recomputation starts from the same state
            generator.set_state(rng_state)
            return model(im, ft, generator)

        return checkpoint(run, images, feats, use_reentrant=False,
                          preserve_rng_state=False)

    def step(state: TrainState, batch, generator=None):
        generator = state.generator if generator is None else generator
        images, feats, labels = to_device(batch, _model_device(model))
        n = labels.shape[0]
        if n % accum:
            raise ValueError(
                f"batch size {n} not divisible by grad_accum={accum}")
        model.train()
        saved = [b.clone() for b in buffers] if nan_guard else None
        tx.zero_grad(set_to_none=True)
        micro = n // accum
        loss_sum = correct = 0.0
        for i in range(accum):
            rows = slice(i * micro, (i + 1) * micro)
            logits = forward(images[rows], feats[rows], generator)
            loss = cross_entropy(logits.float(), labels[rows], smoothing)
            moved = [b.clone() for b in buffers] if remat else None
            (loss / accum).backward()
            if remat and buffers:   # the recomputation moved them again
                torch._foreach_copy_(buffers, moved)
            loss_sum = loss_sum + loss.detach()
            correct = correct + (logits.argmax(-1) == labels[rows]).sum()
        loss = loss_sum / accum

        if nan_guard and not bool(torch.isfinite(loss)):   # host sync
            if buffers:
                torch._foreach_copy_(buffers, saved)
        else:
            if clip > 0:
                clip_by_global_norm_(
                    [p.grad for group in tx.param_groups
                     for p in group["params"] if p.grad is not None], clip)
            tx.step()
        tx.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss, "accuracy": correct.float() / n}

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
