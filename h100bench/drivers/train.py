"""Training as the CLI trains: a pack of uint8 frames made from the seed,
served by the port's ``PackedDataSource`` (pinned batches from its
producer thread) → ``to_device`` → ``device_transform`` (augment and
per-class imputation) → the step of ``make_train_step`` with its NaN
guard, epoch after epoch, with a fresh augment and dropout generator a
step, as ``train/loop.py`` draws them.

Set-up makes the pack and the weights from the seed, builds the one train
state, and drives it through its first steps (the ones the reference
follows) and a warm-up; the window then runs the same state for
``--seconds``. The traffic file gives the batch and the pack.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path

import numpy as np

import counts
import harness as H
from reference import augment as RA
from reference import model as RM
from reference import train as RT

PREFIX = "h100bench."


def _cfg(run, pack_dir: str, image_size: int):
    from surya_tpu_torch.core.config import get_preset

    c, t = run.cell.config, run.cell.traffic
    over = dict(c.get("overrides", {}))
    over.update({"data.batch_size": run.size("batch", t["batch"]),
                 "data.image_size": image_size,
                 "data.packed_dir": pack_dir})
    return get_preset(c["preset"]).override(over)



def make_pack(run, out: Path, device=None) -> dict:
    """Frames, features (some NaN) and labels from the seed, made on
    ``device`` (the run's by default), written with the port's
    ``pack_arrays`` → the host arrays the reference reads (features and
    labels)."""
    import torch
    from surya_tpu_torch.data.packed import pack_arrays

    t = run.cell.traffic
    n = run.size("frames", t["frames"])
    s = run.size("staging", t["staging"])
    classes = run.cell.config["model"]["classes"]
    dev = run.device if device is None else device
    g = H.generator(dev, run.seed, "pack")
    images = torch.randint(0, 256, (n, s, s, 3), generator=g, device=dev,
                           dtype=torch.uint8).cpu().numpy()
    feats = torch.randn(n, 47, generator=g, device=dev)
    nan = torch.rand(n, 47, generator=g, device=dev) < t["feature_nan_share"]
    feats = torch.where(nan, float("nan"), feats).cpu().numpy()
    labels = torch.randint(0, classes, (n,), generator=g, device=dev,
                           dtype=torch.int32).cpu().numpy()
    pack_arrays(str(out), {"train": (images, feats, labels)},
                [f"class{i}" for i in range(classes)])
    return {"features": feats, "labels": labels}


class Program:
    """The train state, its feed and its step, and the calls of a step."""

    def __init__(self, run, weights: dict, pack_dir: Path, image_size: int):
        import torch
        from surya_tpu_torch.data.packed import PackedDataSource
        from surya_tpu_torch.models import get_model
        from surya_tpu_torch.train.steps import (
            create_train_state,
            make_train_step,
            to_device,
        )

        self.run, self.dev = run, run.device
        self.cfg = cfg = _cfg(run, str(pack_dir), image_size)
        with torch.device("meta"):
            model = get_model(cfg.model, image_size=image_size)
        model.to_empty(device=self.dev)
        model.load_state_dict(weights)
        self.state, self.tx = create_train_state(
            model, cfg, rng=H.stream_seed(run.seed, "state"), device=self.dev)
        self.model = model
        self.step_fn = make_train_step(model, self.tx, cfg)
        self.to_device = to_device
        self.data = PackedDataSource(
            cfg.data, packed_dir=str(pack_dir),
            seed=H.stream_seed(run.seed, "order") % 2 ** 31,
            pin_memory=self.dev != "cpu")
        self.feed = self._epochs()
        self.k = 0          # steps taken
        self.losses = []

    def _epochs(self):
        epoch = 0
        while True:
            epoch += 1
            yield from self.data.train_batches(epoch)

    def seeds(self, k: int) -> tuple:
        return (H.stream_seed(self.run.seed, "augment", k),
                H.stream_seed(self.run.seed, "dropout", k))

    def step(self, keep: bool = False):
        """One step of the loop → (the host batch, the transformed batch)
        when ``keep``."""
        from torch.profiler import record_function

        self.k += 1
        s_aug, s_drop = self.seeds(self.k)
        with record_function("h100bench.step"):
            with record_function(PREFIX + "next_batch"):
                host = next(self.feed)
            with record_function(PREFIX + "to_device"):
                batch = self.to_device(host, self.dev)
            with record_function(PREFIX + "device_transform"):
                batch = self.data.device_transform(
                    "train", H.generator(self.dev, s_aug), batch)
            with record_function(PREFIX + "train_step"):
                self.state, m = self.step_fn(
                    self.state, batch, H.generator(self.dev, s_drop))
        self.losses.append(m["loss"])
        return (host, batch) if keep else None

    def named_params(self):
        return dict(self.model.named_parameters())

    def close(self):
        self.feed.close()


def check_steps(prog: Program, weights_host: dict, n: int) -> dict:
    """Drive the state through its first ``n`` steps and read what the
    comparison needs (``reference.train``'s readings)."""
    import torch

    out = {"loss": [], "batches": [], "seeds": []}
    named = prog.named_params()
    for k in range(1, n + 1):
        host, batch = prog.step(keep=True)
        out["batches"].append(tuple(np.array(np.asarray(a)) for a in host))
        out["seeds"].append(prog.seeds(k))
        out["loss"].append(float(prog.losses[-1]))
        if k == 1:
            out["images"] = batch[0].detach().float().cpu()
            out["features"] = batch[1].detach().float().cpu()
            beta1 = prog.tx.param_groups[0]["betas"][0]
            # no optimizer state for a leaf: it got no gradient
            out["grad_norm"] = {
                name: float(torch.linalg.vector_norm(
                    prog.tx.state[p]["exp_avg"])) / (1 - beta1)
                if "exp_avg" in prog.tx.state.get(p, {}) else 0.0
                for name, p in named.items()}
    state = prog.model.state_dict()
    out["change_norm"] = {
        name: float(torch.linalg.vector_norm(
            state[name].float() - weights_host[name].to(prog.dev)))
        for name in weights_host}
    return out


def reference_readings(run, prog_out: dict, weights_host: dict,
                       means: np.ndarray, image_size: int,
                       precision: str = "f32", aug_dtype=None,
                       rows: int | None = None) -> dict:
    import torch

    c = run.cell.config
    a = c["augment"]
    aug = {"scale_min": a["scale_min"], "hflip_prob": a["hflip_prob"],
           "jitter": a["jitter"], "rotation_deg": a["rotation_deg"],
           "blur_sigma": a["blur_sigma"]}
    return RT.follow(counts.sized(run.cell.config["model"], image_size), c["train"], aug,
                     weights_host, prog_out["batches"], prog_out["seeds"],
                     means, image_size, run.device, precision,
                     aug_dtype or torch.float32, rows)


def setup(run):
    """Pack, weights, program, the checked steps and the warm-up →
    (program, checked readings, host weights, imputation means)."""
    import torch

    t = run.cell.traffic
    image_size = run.size("image_size", run.cell.config["model"]["image_size"])
    if run.device != "cpu":
        from surya_tpu_torch.ops.cuda import _build

        _build.build_all(["quadrant", "fusion_head"])
    run.mark("imports and kernels")
    pack_dir = run.tmp / f"h100bench-pack-{run.cell.name}-{run.seed}"
    host_arrays = make_pack(run, pack_dir)
    run.mark("pack")
    model = counts.sized(run.cell.config["model"], image_size)
    weights = H.make_weights(RM.leaf_shapes(model), run.seed, run.device,
                             RM.fan_in)
    prog = Program(run, weights, pack_dir, image_size)
    weights_host = {k: v.cpu() for k, v in weights.items()}
    del weights
    run.mark("weights and train state")
    checked = check_steps(prog, weights_host, t["check_steps"])
    run.mark("checked steps")
    for _ in range(t["warmup_steps"]):
        prog.step()
    if run.device != "cpu":
        torch.cuda.synchronize()
    run.mark("warm-up")
    means = RA.class_means(host_arrays["features"], host_arrays["labels"],
                           run.cell.config["model"]["classes"])
    return prog, checked, weights_host, means, pack_dir, image_size


def measure(run, prog: Program) -> dict:
    import torch

    def sync():
        if run.device != "cpu":
            torch.cuda.synchronize()

    sync()
    first = prog.k
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        prog.step()
    sync()
    seconds = time.perf_counter() - t0
    steps = prog.k - first
    losses = torch.stack([torch.as_tensor(x) for x in prog.losses[first:]])
    failed = int((~torch.isfinite(losses)).sum())
    batch = run.size("batch", run.cell.traffic["batch"])
    return {"steps": steps, "images": steps * batch, "seconds": seconds,
            "failed": failed, "batch": batch}


def trace_slice(run, prog: Program):
    import tracing as T

    n = run.cell.traffic["trace_steps"]

    def body():
        for _ in range(n):
            prog.step()

    return T.profiled(body, run.tmp, run.device)


def execute(run) -> dict:
    """A whole run → the pieces of the result line."""
    import shutil

    import torch

    prog, checked, weights_host, means, pack_dir, image_size = setup(run)
    try:
        setup_s = time.perf_counter() - run.started
        window = measure(run, prog)
        tr = trace_slice(run, prog) if run.trace else None
        peak = (torch.cuda.max_memory_allocated(run.device)
                if run.device != "cpu" else 0)
    finally:
        prog.close()
        shutil.rmtree(pack_dir, ignore_errors=True)
    del prog
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()
    ref = reference_readings(run, checked, weights_host, means, image_size)
    run.judge(RT.compare(checked, ref))
    model = counts.sized(run.cell.config["model"], image_size)
    return {"rate": window["images"] / window["seconds"],
            "setup_s": setup_s, "attempted": window["steps"],
            "failed": window["failed"], "peak": peak, "trace": tr,
            "window": window, "image_size": image_size,
            "flops_per_image": counts.train_flops(model, image_size),
            "model": model, "training": True,
            "call_batch": window["batch"]}


