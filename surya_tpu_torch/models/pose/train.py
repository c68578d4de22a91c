"""Pose-landmark training on the synthetic generator, ported from
``surya_tpu/models/pose/train.py``: each step draws and renders its batch
on the device (``data/synthetic_pose.py``), then runs the forward, the
backward and an Adam update. Reachable as ``python -m surya_tpu_torch
pose-train``.

The optimiser is optax's ``adam(warmup_cosine_decay_schedule(0, peak,
warmup=min(50, steps // 2), decay_steps=steps))`` written for torch:
``torch.optim.Adam`` (eps 1e-8) with the learning rate set before each
update to the schedule at the update count, which starts at 0 (so the
first update has rate 0, as in optax). The checkpoint is the JAX package's
msgpack artifact (``save_pose_params``).
"""

from __future__ import annotations

import json
import math
import os
import time

import torch

from surya_tpu_torch.data.synthetic_pose import make_pose_batch
from surya_tpu_torch.models.pose.landmark_net import (
    PoseLandmarkNet,
    landmark_loss,
    pck,
    save_pose_params,
)
from surya_tpu_torch.ops import resolve_device

HOLDOUT_SEED, HOLDOUT_SIZE = 99, 128


def warmup_cosine_schedule(peak: float, warmup_steps: int, decay_steps: int):
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)`` (end value 0): count → learning rate, linear from 0 to
    ``peak`` over the warmup, then a cosine to 0 at ``decay_steps``."""
    cosine_steps = decay_steps - warmup_steps

    def lr(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        c = min(count - warmup_steps, cosine_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))

    return lr


def make_optimizer(model: torch.nn.Module, peak_lr: float, steps: int):
    """→ (Adam, schedule) with the JAX trainer's settings."""
    opt = torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                           eps=1e-8)
    return opt, warmup_cosine_schedule(peak_lr, min(50, steps // 2), steps)


def set_scheduled_lr(opt, schedule) -> None:
    """Set the rate of the next update to the schedule at the number of
    updates so far, as optax evaluates it."""
    first = opt.param_groups[0]["params"][0]
    count = int(opt.state[first].get("step", 0))
    for group in opt.param_groups:
        group["lr"] = schedule(count)


def train_step(model, opt, schedule, imgs, xy, z, vis):
    """One update on a batch → (loss, parts), both still on the device."""
    set_scheduled_lr(opt, schedule)
    opt.zero_grad(set_to_none=True)
    loss, parts = landmark_loss(model(imgs), xy, z, vis)
    loss.backward()
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in parts.items()}


@torch.no_grad()
def eval_metrics(model, imgs, xy, z, vis) -> dict:
    """Holdout metrics: PCK@0.05/0.10, mean error in pixels, z MAE and
    visibility accuracy (as tensors on the device)."""
    lm = model(imgs)["landmarks"]
    mask = (vis > 0.5).float()
    denom = mask.sum().clamp(min=1.0)
    err = (mask * torch.linalg.vector_norm(lm[..., :2] - xy, dim=-1)).sum()
    return {"pck05": pck(lm[..., :2], xy, vis, 0.05),
            "pck10": pck(lm[..., :2], xy, vis, 0.10),
            "mean_err_px": err / denom * imgs.shape[1],
            "z_mae": (mask * (lm[..., 2] - z).abs()).sum() / denom,
            "vis_acc": ((lm[..., 3] > 0.5) == (vis > 0.5)).float().mean()}


# the port's own run directory: the tracked runs/pose_landmark* hold the
# JAX package's checkpoints and summaries
POSE_OUT = "runs/pose_landmark_torch"


def train_pose_landmark(steps: int = 600, batch: int = 64,
                        image_size: int = 256, width: int = 32,
                        out_dir: str = POSE_OUT,
                        peak_lr: float = 1e-3, eval_every: int = 50,
                        seed: int = 0, echo: bool = True,
                        occlude_p: float = 0.0, mirror_p: float = 0.0,
                        device=None) -> dict:
    """Train (bf16 compute, f32 parameters), log JSONL metrics, save the
    msgpack checkpoint → the summary (also ``out_dir/summary.json``):
    holdout PCK@0.05/0.10, mean pixel error, z MAE, visibility accuracy,
    parameter count, wall time, the median step time, checkpoint path.

    ``occlude_p`` / ``mirror_p`` turn on the generator's occlusion and
    mirror augmentation in each step; the holdout (generator seed 99, 128
    images) is never augmented."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    init = torch.Generator().manual_seed(seed + 1)
    model = PoseLandmarkNet(width=width, generator=init)
    model = model.to(device).train()
    n_params = sum(p.numel() for p in model.parameters())
    opt, schedule = make_optimizer(model, peak_lr, steps)
    gen = torch.Generator(device).manual_seed(seed)
    holdout = make_pose_batch(torch.Generator(device).manual_seed(HOLDOUT_SEED),
                              HOLDOUT_SIZE, image_size)

    def evaluate() -> dict:
        model.eval()
        m = {k: float(v) for k, v in eval_metrics(model, *holdout).items()}
        model.train()
        return m

    log_path = os.path.join(out_dir, "train.jsonl")
    step_s = []
    t0 = time.time()
    with open(log_path, "w") as log:
        for step in range(1, steps + 1):
            ts = time.perf_counter()
            imgs, xy, z, vis = make_pose_batch(gen, batch, image_size,
                                               occlude_p=occlude_p,
                                               mirror_p=mirror_p)
            loss, parts = train_step(model, opt, schedule, imgs, xy, z, vis)
            if step % eval_every == 0 or step == 1:
                rec = {"step": step, "loss": float(loss),
                       **{k: float(v) for k, v in parts.items()},
                       **evaluate(), "wall_s": round(time.time() - t0, 1)}
                log.write(json.dumps(rec) + "\n")
                log.flush()
                if echo:
                    print(rec, flush=True)
            else:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_s.append(time.perf_counter() - ts)

    final = evaluate()
    ckpt = os.path.join(out_dir, "pose_landmark.msgpack")
    save_pose_params(ckpt, model, image_size=image_size)
    step_s.sort()
    summary = {"steps": steps, "batch": batch, "image_size": image_size,
               "width": width, "params": n_params,
               "occlude_p": occlude_p, "mirror_p": mirror_p,
               "backend": device.type,
               "wall_s": round(time.time() - t0, 1),
               "step_ms_median": (1e3 * step_s[len(step_s) // 2]
                                  if step_s else None),
               "checkpoint": ckpt,
               "eval_distribution": "clean in-dist holdout (generator "
                                    f"seed {HOLDOUT_SEED})",
               **final}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if echo:
        print(json.dumps(summary), flush=True)
    return summary
