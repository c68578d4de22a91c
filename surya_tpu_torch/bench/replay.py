"""The reference-replay accuracy campaign on the card: the JAX package's
replay table (``runs/reference_replay/table.json``) retrained through the
port, one phase at a time.

    python -m surya_tpu_torch.bench.replay --phase data|spatial|temporal|pose|cam|table \\
        [--root build/replay224] [--seeds 3] [--out runs/torch_replay] \\
        [--rows quadtree-fusion,...] [--device cpu]

- ``data`` writes the replay set as ``scripts/make_replay_disk.py`` wrote
  the JAX campaign's (``runs/reference_replay/dataset_regen.json``): the
  spatial images as quality-92 JPEGs (PIL) beside their ``.npy`` features
  and the class-stat JSONs, the temporal set as ``.npz`` windows; then the
  port's CLI packs them (``pack --staging 256``, ``pack --sequences`` at
  T 4 and 5). It records which decoder the pack used and the pixel error
  that the JPEG and the decode leave against the raw arrays
  (``OUT/data.json``). Without PIL it raises: raw arrays would be another
  data set.
- ``spatial`` and ``temporal`` run ``scripts/replay_batch.py``'s rows
  (``jobs_for``; spatial + controls, temporal + temporal-trainable),
  seed-major, each as ``python -m surya_tpu_torch train`` in a child
  process (the preset, JAX's overrides, the CLI's early stop and best
  reload) into ``OUT/<group>/<row>_s<seed>/`` (``config.json``,
  ``metrics.jsonl``, ``result.json`` in JAX's layout with the card named,
  ``ckpt/``). A row with a test result is skipped, so a campaign spans
  calls; a failed run writes an error row (retried on a later call, up
  to three attempts), never dropped. ``--rows`` keeps only the named rows.
- ``pose`` runs ``pose-train --seed s`` at its published defaults into
  ``OUT/pose/s<seed>/`` against ``runs/pose_landmark/summary.json``.
- ``cam`` holds Grad-CAM card vs CPU end to end on the trained
  ``quadtree-fusion`` seed-0 weights, with the count of layer4's ReLU
  inputs within 1e-4 of 0 (``OUT/cam.json``).
- ``table`` writes ``OUT/table.json`` in ``scripts/reference_replay.py``'s
  shape (``meta``, ``bands``, ``control_bands``, ``failures``,
  ``orderings``) with a ``vs_jax`` block per row, the rows not run, the
  pose rows, ``data.json`` and ``cam.json``.

Each finished run prints its ``result.json`` as one JSON line. On a
remote machine that hands back only an output directory, a run ends by
copying ``OUT`` there without the checkpoints (README, "`bench` and the
replay accuracy campaign").
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = "runs/torch_replay"
JAX_REPLAY = os.path.join(REPO, "runs", "reference_replay")
JAX_POSE = os.path.join(REPO, "runs", "pose_landmark", "summary.json")
MAX_ATTEMPTS = 3
CAM_TOL = 2e-4          # chip_smoke.py's CAM_TOL
NEAR_ZERO = 1e-4

# runs/reference_replay/dataset_regen.json's gen_config
GEN_CONFIG = {"per_class": 96, "seq_per_class": 64, "image_size": 224,
              "seq_len": 5, "amp_hi": 0.45, "amp_pow": 0.5,
              "feat_sep": 1.55}
SPLIT_SEEDS = {"train": 0, "valid": 1, "test": 2}
CLASS_NAMES = [f"pose_{i}" for i in range(8)]

# scripts/replay_batch.py's rows
SPATIAL_PRESETS = [
    "quadtree-fusion", "experiment-fusion", "experiment-image-only",
    "experiment-numerical-only", "comparative-resnet18",
    "comparative-vgg16", "comparative-mobilenet-v2",
]
TEMPORAL_PRESETS = ["cnn-lstm", "fact", "quadtree-3d",
                    "resnet3d-video", "ji-3dcnn", "hybrid-quadtree-3d"]
T4 = ("cnn-lstm", "fact")   # presets whose seq_len=4 truncates windows
PHASE_GROUPS = {"spatial": ("spatial", "controls"),
                "temporal": ("temporal", "temporal-trainable")}
GROUPS = ("controls", "temporal", "temporal-trainable", "spatial")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _split_count(per_class: int, split: str) -> int:
    return per_class if split == "train" else max(per_class // 3, 8)


def write_spatial(root, per_class, image_size, **kw):
    """``make_replay_disk.py::write_spatial``: ``<split>/pose_<c>/
    <i>.jpg`` (PIL, quality 92) + ``.npy`` and the train split's per-class
    feature means and stds (+ 1e-8) → {split: (images, feats, labels)},
    the raw arrays."""
    from PIL import Image

    from surya_tpu_torch.data.replay import make_replay_spatial
    from surya_tpu_torch.features import FEATURE_NAMES_47

    raw = {}
    for split, seed_off in SPLIT_SEEDS.items():
        imgs, feats, labels = make_replay_spatial(
            per_class=_split_count(per_class, split),
            image_size=image_size, seed=1000 + seed_off, **kw)
        for i, (img, f, y) in enumerate(zip(imgs, feats, labels)):
            cdir = os.path.join(root, split, f"pose_{y}")
            os.makedirs(cdir, exist_ok=True)
            Image.fromarray(img).save(
                os.path.join(cdir, f"{i:05d}.jpg"), quality=92)
            np.save(os.path.join(cdir, f"{i:05d}.npy"), f)
        raw[split] = (imgs, feats, labels)

    train_feats, train_labels = raw["train"][1:]
    means, stds = {}, {}
    for c in np.unique(train_labels):
        sel = train_feats[train_labels == c]
        means[f"pose_{c}"] = dict(zip(FEATURE_NAMES_47,
                                      sel.mean(axis=0).tolist()))
        stds[f"pose_{c}"] = dict(zip(FEATURE_NAMES_47,
                                     (sel.std(axis=0) + 1e-8).tolist()))
    with open(os.path.join(root, "class_feature_means.json"), "w") as f:
        json.dump(means, f)
    with open(os.path.join(root, "class_feature_stds.json"), "w") as f:
        json.dump(stds, f)
    return raw


def write_temporal(root, per_class, image_size, seq_len, **kw):
    """``make_replay_disk.py::write_temporal``: ``class_to_idx.json`` and
    ``<split>/pose_<c>/window_<i>.npz`` → {split: window count}."""
    from surya_tpu_torch.data.replay import make_replay_temporal
    from surya_tpu_torch.data.sequences import write_windows

    counts = {}
    write_windows(root, {}, CLASS_NAMES)       # class_to_idx.json
    for split, seed_off in SPLIT_SEEDS.items():
        arrays = make_replay_temporal(
            per_class=_split_count(per_class, split), image_size=image_size,
            seq_len=seq_len, seed=2000 + seed_off, **kw)
        write_windows(root, {split: arrays}, CLASS_NAMES)
        counts[split] = len(arrays[2])
    return counts


def resize_bilinear_u8(src: np.ndarray, out_size: int) -> np.ndarray:
    """``native/decode.cpp::resize_bilinear`` in numpy f32: (H, W, 3)
    uint8 → (S, S, 3), half-pixel centres clamped at 0, rounded."""
    h, w = src.shape[:2]

    def axis(n):
        o = np.arange(out_size, dtype=np.float32)
        f = np.maximum((o + np.float32(0.5)) * (np.float32(n)
                       / np.float32(out_size)) - np.float32(0.5),
                       np.float32(0))
        i0 = f.astype(np.int64)
        return i0, np.minimum(i0 + 1, n - 1), (f - i0).astype(np.float32)

    y0, y1, wy = axis(h)
    x0, x1, wx = axis(w)
    s = src.astype(np.float32)
    wx, wy = wx[None, :, None], wy[:, None, None]
    one = np.float32(1)
    top = s[y0][:, x0] * (one - wx) + s[y0][:, x1] * wx
    bot = s[y1][:, x0] * (one - wx) + s[y1][:, x1] * wx
    return (top * (one - wy) + bot * wy + np.float32(0.5)).astype(np.uint8)


class _PixelError:
    """Running mean, maximum and RMSE of |got - want| over uint8 images."""

    def __init__(self):
        self.abs = self.sq = 0.0
        self.n = self.max = 0

    def add(self, got: np.ndarray, want: np.ndarray) -> None:
        d = got.astype(np.float64) - want.astype(np.float64)
        self.abs += float(np.abs(d).sum())
        self.sq += float((d * d).sum())
        self.max = max(self.max, int(np.abs(d).max()))
        self.n += d.size

    def record(self) -> dict:
        mse = self.sq / self.n
        return {"mean_abs": self.abs / self.n, "max_abs": self.max,
                "rmse": mse ** 0.5,
                "psnr_db": (10 * np.log10(255.0 ** 2 / mse) if mse > 0
                            else None)}


def _libjpeg_path() -> str | None:
    """The libjpeg the native decoder loaded, from this process's maps."""
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                if "libjpeg" in line:
                    return line.split()[-1]
    except OSError:
        pass
    return None


def pixel_error(root: str, pack_dir: str, raw: dict, staging: int,
                native_used: bool) -> dict:
    """The JPEG round trip at the written size (PIL's decode against the
    raw array) and the pack against the raw array resized by the pack's
    own rule (native's bilinear, or PIL's), over every spatial split."""
    from PIL import Image

    from surya_tpu_torch.data.packed import split_paths

    jpeg, packed, n = _PixelError(), _PixelError(), 0
    for split, (imgs, _, labels) in raw.items():
        pack = np.load(split_paths(pack_dir, split)["images"],
                       mmap_mode="r")
        # a pack orders a split by class dir, then by file name
        order = sorted(range(len(labels)), key=lambda i: (int(labels[i]), i))
        for j, i in enumerate(order):
            path = os.path.join(root, split, f"pose_{labels[i]}",
                                f"{i:05d}.jpg")
            with Image.open(path) as im:
                jpeg.add(np.asarray(im.convert("RGB")), imgs[i])
            want = (resize_bilinear_u8(imgs[i], staging) if native_used
                    else np.asarray(Image.fromarray(imgs[i]).resize(
                        (staging, staging), Image.BILINEAR)))
            packed.add(np.asarray(pack[j]), want)
            n += 1
    return {"images": n,
            "jpeg_vs_raw": {"size": int(imgs.shape[1]), **jpeg.record()},
            "pack_vs_raw_resized": {
                "size": staging,
                "resize": "native bilinear" if native_used
                else "PIL BILINEAR", **packed.record()}}


def data_phase(root: str, out: str, gen=GEN_CONFIG) -> dict:
    import importlib.util

    if importlib.util.find_spec("PIL") is None:
        raise RuntimeError(
            "the replay set's spatial images are quality-92 JPEGs and PIL "
            "writes them; without PIL this would be another data set")
    import PIL

    from surya_tpu_torch import native
    from surya_tpu_torch.__main__ import main as cli

    t0 = time.perf_counter()
    kw = dict(amp_hi=gen["amp_hi"], amp_pow=gen["amp_pow"],
              feat_sep=gen["feat_sep"])
    raw = write_spatial(os.path.join(root, "spatial"), gen["per_class"],
                        gen["image_size"], **kw)
    windows = write_temporal(os.path.join(root, "temporal"),
                             gen["seq_per_class"], gen["image_size"],
                             gen["seq_len"], **kw)
    with open(os.path.join(root, "gen_config.json"), "w") as f:
        json.dump({"root": root, "kind": "both", **gen}, f, indent=2)
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    spatial_pack = os.path.join(root, "spatial_packed")
    steps = [["pack", "--root", os.path.join(root, "spatial"), "--out",
              spatial_pack, "--staging", "256"]]
    steps += [["pack", "--sequences", "--root", os.path.join(root, "temporal"),
               "--out", os.path.join(root, f"temporal_packed_t{t}"),
               "--seq-len", str(t)] for t in (4, 5)]
    for args in steps:
        if cli(args) != 0:
            raise RuntimeError(f"{args} failed")
    pack_s = time.perf_counter() - t0
    native_used = native.available()
    record = {
        "gen_config": gen, "split_seeds": {"spatial": 1000, "temporal": 2000},
        "images": {s: len(r[2]) for s, r in raw.items()},
        "windows": windows,
        "decoder": {"native": native_used,
                    "libjpeg": _libjpeg_path() if native_used else None,
                    "PIL": PIL.__version__,
                    "pack_used": "native" if native_used else "PIL"},
        "pixel_error": pixel_error(os.path.join(root, "spatial"),
                                   spatial_pack, raw, 256, native_used),
        "write_s": write_s, "pack_s": pack_s, **card_record()}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "data.json"), "w") as f:
        json.dump(record, f, indent=2)
    return record


# ---------------------------------------------------------------------------
# training runs
# ---------------------------------------------------------------------------

def jobs_for(group: str, root: str, seeds: int, out: str = OUT):
    """``scripts/replay_batch.py::jobs_for`` under ``out``: (name,
    base_preset, out_dir, overrides) of a group, seed-major."""
    spatial = {"data.data_root": f"{root}/spatial",
               "data.packed_dir": f"{root}/spatial_packed"}

    def temporal(preset):
        pdir = (f"{root}/temporal_packed_t4" if preset in T4
                else f"{root}/temporal_packed_t5")
        return {"data.seq_root": f"{root}/temporal",
                "data.packed_dir": pdir}

    if group == "controls":
        rows = [("quadtree-fusion-20ep", "quadtree-fusion",
                 {**spatial, "train.epochs": "20"}),
                ("comparative-resnet18-frozen", "comparative-resnet18",
                 {**spatial, "model.freeze_backbone": "true"})]
    elif group == "temporal":
        rows = [(p, p, temporal(p)) for p in TEMPORAL_PRESETS]
    elif group == "temporal-trainable":
        rows = [(f"{p}-trainable", p,
                 {**temporal(p), "model.freeze_backbone": "false"})
                for p in T4 + ("resnet3d-video", "hybrid-quadtree-3d")]
    elif group == "spatial":
        rows = [(p, p, dict(spatial)) for p in SPATIAL_PRESETS]
    else:
        raise SystemExit(f"unknown group {group!r}")
    sub = "temporal" if group.startswith("temporal") else group
    for seed in range(seeds):
        for name, preset, ov in rows:
            yield name, preset, os.path.join(out, sub, f"{name}_s{seed}"), \
                {**ov, "train.seed": str(seed)}


def card_record() -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    import torch

    from surya_tpu_torch.bench.throughput import card_line

    if not torch.cuda.is_available():
        return {"card": None, "nvidia_smi": None}
    return {"card": torch.cuda.get_device_name(0),
            "nvidia_smi": card_line(torch.device("cuda"))}


def load_result(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _last_json(text: str) -> dict:
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise ValueError("no JSON line")


def run_job(name, preset, out_dir, overrides, device=None,
            card=None, nproc=1) -> dict:
    """One row: ``python -m surya_tpu_torch train`` in a child → the
    ``result.json`` written (JAX's keys, the card, the launches), or an
    error row. ``nproc`` > 1 trains data-parallel over that many cards,
    one process each, as ``torchrun --nproc-per-node=N ... --mesh.data=N``
    (the global batch stays the preset's)."""
    res_path = os.path.join(out_dir, "result.json")
    prev = load_result(res_path) or {}
    attempts = int(prev.get("attempts", 0))
    os.makedirs(out_dir, exist_ok=True)
    seed = int(overrides["train.seed"])
    launcher = ([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", f"--nproc-per-node={nproc}"]
                if nproc > 1 else [sys.executable])
    args = [*launcher, "-m", "surya_tpu_torch", "train", "--preset",
            preset, "--out", out_dir,
            *[f"--{k}={v}" for k, v in overrides.items()]]
    if nproc > 1:
        args.append(f"--mesh.data={nproc}")
    if device is not None:
        args += ["--device", device]
    t0 = time.time()
    proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True)
    wall = time.time() - t0
    card = card or card_record()
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"exit {proc.returncode}")
        summary = _last_json(proc.stdout)
        if summary.get("preempted"):
            raise RuntimeError("preempted before the end")
    except (RuntimeError, ValueError) as e:
        result = {"preset": name, "base_preset": preset, "seed": seed,
                  "attempts": attempts + 1,
                  "error": f"{e}: {proc.stderr[-1500:]}", **card}
    else:
        result = {"best_epoch": summary["best_epoch"],
                  "best_metric": summary["best_metric"],
                  "test": summary["test"], "preset": name,
                  "base_preset": preset,
                  "overrides": {k: v for k, v in overrides.items()
                                if not k.startswith("data.")},
                  "seed": seed, "wall_seconds": round(wall, 1),
                  "runner": "surya_tpu_torch.bench.replay: python -m "
                            "surya_tpu_torch train in a child per run",
                  "kernel_launches": summary.get("kernel_launches"),
                  **({"ranks": nproc, "kernel_launches_by_rank":
                      summary.get("kernel_launches_by_rank")}
                     if nproc > 1 else {}),
                  **card}
        with open(os.path.join(out_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(card) + "\n")
    with open(res_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"run": os.path.relpath(out_dir, os.path.dirname(
        os.path.dirname(out_dir))), **result}), flush=True)
    return result


def training_phase(groups, root: str, seeds: int, out: str, rows=None,
                   device=None, nproc=1) -> list:
    """Every row of ``groups`` not yet done, seed-major within a group,
    each over ``nproc`` cards (:func:`run_job`)."""
    card, done = card_record(), []
    for group in groups:
        for name, preset, out_dir, ov in jobs_for(group, root, seeds, out):
            if rows and name not in rows:
                continue
            prev = load_result(os.path.join(out_dir, "result.json"))
            if prev is not None and ("test" in prev or int(
                    prev.get("attempts", 1)) >= MAX_ATTEMPTS):
                continue
            done.append(run_job(name, preset, out_dir, ov, device, card,
                                nproc))
    return done


def pose_phase(seeds: int, out: str, device=None) -> list:
    """``pose-train --seed s`` at its published defaults, against JAX's
    ``runs/pose_landmark/summary.json``."""
    with open(JAX_POSE) as f:
        jax = json.load(f)
    card, rows = card_record(), []
    for seed in range(seeds):
        out_dir = os.path.join(out, "pose", f"s{seed}")
        res_path = os.path.join(out_dir, "result.json")
        if load_result(res_path) is not None:
            continue
        args = [sys.executable, "-m", "surya_tpu_torch", "pose-train",
                "--seed", str(seed), "--out", out_dir]
        if device is not None:
            args += ["--device", device]
        proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True)
        summary = load_result(os.path.join(out_dir, "summary.json"))
        if proc.returncode != 0 or summary is None:
            row = {"seed": seed, "error": proc.stderr[-1500:], **card}
        else:
            row = {"seed": seed,
                   **{k: summary[k] for k in (
                       "pck10", "pck05", "mean_err_px", "z_mae", "vis_acc",
                       "steps", "batch", "image_size", "width", "wall_s",
                       "step_ms_median")},
                   "jax": {k: jax[k] for k in ("pck10", "mean_err_px",
                                               "backend")},
                   **card}
        os.makedirs(out_dir, exist_ok=True)
        with open(res_path, "w") as f:
            json.dump(row, f, indent=2)
        print(json.dumps({"run": f"pose/s{seed}", **row}), flush=True)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Grad-CAM on trained weights
# ---------------------------------------------------------------------------

def layer4_relu_inputs(model, fmap):
    """The input of every ReLU that layer4 of a quadtree's trunk applies
    to the layer3 map ``fmap`` (B, h, w, C), flattened and concatenated."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    seen = []

    class Capture(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is F.relu or func is torch.relu:
                seen.append(args[0].detach().reshape(-1))
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Capture():
        model.trunk(fmap, start="layer4")
    return torch.cat(seen)


def cam_errors(model_cfg, state_dict, images, feats,
               targets=("layer3", "layer4"), chunk: int = 32) -> dict:
    """Grad-CAM of every target on the card against the CPU end to end at
    f32 (TF32 off), on the same images (B, H, W, 3) f32 and features,
    in chunks: the largest heatmap difference, whether every prediction
    agrees, the logits' relative difference; and how many of layer4's
    ReLU inputs (on the CPU) lie within 1e-4 of 0."""
    import torch

    from surya_tpu_torch.interpret.gradcam import (
        cam_model,
        cam_split,
        grad_cam_of,
    )

    size = images.shape[1]
    models = {dev: cam_model(model_cfg, state_dict, size, dev)
              for dev in ("cuda", "cpu")}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for target in targets:
            err, logit_err, agree = 0.0, 0.0, True
            for s in range(0, len(images), chunk):
                im, ft = images[s:s + chunk], feats[s:s + chunk]
                cam_g, pred_g, logit_g = grad_cam_of(
                    model_cfg, models["cuda"], im, ft, target)
                cam_c, pred_c, logit_c = grad_cam_of(
                    model_cfg, models["cpu"], im, ft, target)
                err = max(err, (cam_g.cpu() - cam_c).abs().max().item())
                agree &= bool(torch.equal(pred_g.cpu(), pred_c))
                logit_err = max(logit_err, ((logit_g.cpu() - logit_c).abs()
                                            .max() / logit_c.abs().max())
                                .item())
            out[target] = {"max_abs_err": err, "tol": CAM_TOL,
                           "within_tol": err <= CAM_TOL,
                           "preds_equal": agree,
                           "logits_max_rel_err": logit_err}
        near = total = 0
        for s in range(0, len(images), chunk):
            fmap, _, _ = cam_split(model_cfg, models["cpu"], torch.as_tensor(
                images[s:s + chunk], dtype=torch.float32), "layer3")
            pre = layer4_relu_inputs(models["cpu"], fmap)
            near += int((pre.abs() < NEAR_ZERO).sum())
            total += pre.numel()
        out["layer4_relu_inputs_near_zero"] = {"count": near, "of": total,
                                               "within": NEAR_ZERO}
        return out
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def test_split_inputs(cfg, limit: int | None = None):
    """The test split of ``cfg``'s pack through its eval transform on the
    CPU → (images f32 (N, 224, 224, 3), features f32)."""
    import torch

    from surya_tpu_torch.__main__ import _build_data
    from surya_tpu_torch.train.steps import to_device

    data = _build_data(cfg, torch.device("cpu"))
    ims, fts = [], []
    for batch in data.eval_batches("test"):
        keep = np.asarray(batch[2]) >= 0
        b = data.device_transform("test", None, to_device(batch, "cpu"))
        ims.append(b[0][torch.from_numpy(keep)].numpy())
        fts.append(b[1][torch.from_numpy(keep)].numpy())
    images, feats = np.concatenate(ims), np.concatenate(fts)
    return (images, feats) if limit is None else (images[:limit],
                                                  feats[:limit])


def best_checkpoint(run_dir: str) -> str:
    res = load_result(os.path.join(run_dir, "result.json"))
    if res is None or "best_epoch" not in res:
        raise FileNotFoundError(f"no finished run in {run_dir}")
    return os.path.join(run_dir, "ckpt", f"{res['best_epoch']}.pt")


def cam_phase(root: str, out: str) -> dict:
    """Grad-CAM card vs CPU on ``quadtree-fusion_s0``'s best checkpoint:
    on the replay test split and on ``chip_smoke.py``'s random-normal
    batch of 4 (``default_rng(2)``)."""
    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
    from surya_tpu_torch.core.config import get_preset

    name, preset, run_dir, ov = next(jobs_for("spatial", root, 1, out))
    cfg = get_preset(preset).override(ov)
    ckpt = best_checkpoint(run_dir)
    state = load_checkpoint_variables(ckpt)
    images, feats = test_split_inputs(cfg)
    rng = np.random.default_rng(2)
    normal = (rng.normal(size=(4, 224, 224, 3)).astype(np.float32),
              rng.normal(size=(4, 47)).astype(np.float32))
    record = {"checkpoint": os.path.relpath(ckpt, out),
              "test_split": {"images": len(images),
                             **cam_errors(cfg.model, state, images, feats)},
              "normal_b4": cam_errors(cfg.model, state, *normal),
              **card_record()}
    with open(os.path.join(out, "cam.json"), "w") as f:
        json.dump(record, f, indent=2)
    return record


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

def bands(results):
    """``scripts/reference_replay.py::bands``."""
    out = {}
    for preset in {r["preset"] for r in results}:
        rs = [r for r in results if r["preset"] == preset]
        accs = [r["test"]["accuracy"] for r in rs]
        out[preset] = {
            "mean": float(np.mean(accs)), "std": float(np.std(accs)),
            "accs": accs,
            "precision": float(np.mean(
                [r["test"].get("precision", 0) for r in rs])),
            "recall": float(np.mean(
                [r["test"].get("recall", 0) for r in rs])),
            "f1": float(np.mean([r["test"].get("f1", 0) for r in rs])),
        }
    return out


def separated(hi, lo):
    """Non-overlapping seed bands: mean-std of hi above mean+std of lo."""
    return bool(hi["mean"] - hi["std"] > lo["mean"] + lo["std"])


def overlap(a, b) -> bool:
    """Whether the mean ± std intervals of two bands overlap."""
    return bool(a["mean"] - a["std"] <= b["mean"] + b["std"]
                and b["mean"] - b["std"] <= a["mean"] + a["std"])


def vs_jax(port: dict, jax: dict) -> dict:
    """Per row of ``port``'s bands: JAX's band, the port's, and whether
    the two mean ± std intervals overlap."""
    def band(b):
        return {"mean": b["mean"], "std": b["std"], "accs": b["accs"],
                "interval": [b["mean"] - b["std"], b["mean"] + b["std"]]}

    return {name: {"jax": band(jax[name]) if name in jax else None,
                   "port": band(b),
                   "overlap": overlap(b, jax[name]) if name in jax
                   else None}
            for name, b in sorted(port.items())}


def orderings_of(b: dict, cb: dict) -> dict:
    """``scripts/reference_replay.py``'s ordering checks."""
    orderings = {}
    if "quadtree-fusion" in b:
        for other in ("comparative-resnet18", "comparative-resnet50",
                      "comparative-vgg16", "comparative-mobilenet-v2",
                      "comparative-densenet121", "experiment-image-only",
                      "experiment-numerical-only"):
            if other in b:
                orderings[f"quadtree-fusion_gt_{other}"] = separated(
                    b["quadtree-fusion"], b[other])
        qf = b["quadtree-fusion"]
        orderings["flagship_unsaturated"] = bool(qf["mean"] < 0.99)
        orderings["flagship_band"] = [round(qf["mean"] - qf["std"], 4),
                                      round(qf["mean"] + qf["std"], 4)]
    if "experiment-fusion" in b and "experiment-image-only" in b:
        orderings["fusion_gt_image_only"] = separated(
            b["experiment-fusion"], b["experiment-image-only"])
    if "experiment-image-only" in b and "experiment-numerical-only" in b:
        orderings["image_only_gt_numerical_only"] = separated(
            b["experiment-image-only"], b["experiment-numerical-only"])
    temporal_all = TEMPORAL_PRESETS + [f"{p}-trainable"
                                       for p in TEMPORAL_PRESETS]
    for base in ("cnn-lstm", "cnn-lstm-trainable"):
        if base not in b:
            continue
        for other in temporal_all:
            if other != base and other in b:
                orderings[f"{other}_gt_{base}"] = separated(b[other], b[base])
    if "quadtree-fusion-20ep" in cb and "comparative-resnet18" in b:
        c = cb["quadtree-fusion-20ep"]
        orderings["ctrl_quadtree-20ep_gt_resnet18"] = separated(
            c, b["comparative-resnet18"])
        orderings["ctrl_quadtree-20ep_band"] = [
            round(c["mean"] - c["std"], 4), round(c["mean"] + c["std"], 4)]
    if "comparative-resnet18-frozen" in cb and "experiment-fusion" in b:
        orderings["ctrl_frozen-quadtree_gt_frozen-resnet18"] = separated(
            b["experiment-fusion"], cb["comparative-resnet18-frozen"])
    return orderings


def collect(out: str, seeds: int):
    """The results of seeds 0 .. seeds-1 under ``out`` → (results, control
    results, failures), as ``reference_replay.py --phase table`` reads
    them."""
    results, control_results, failures = [], [], []
    for sub in ("spatial", "temporal", "controls"):
        d = os.path.join(out, sub)
        if not os.path.isdir(d):
            continue
        for run in sorted(os.listdir(d)):
            if int(run.rsplit("_s", 1)[1]) >= seeds:
                continue
            r = load_result(os.path.join(d, run, "result.json"))
            if r is None:
                failures.append({"run": f"{sub}/{run}",
                                 "error": "no result.json "
                                          "(run never completed)"})
            elif "test" not in r:
                failures.append({"run": f"{sub}/{run}",
                                 "error": r.get("error", "?"),
                                 "attempts": r.get("attempts")})
            else:
                (control_results if sub == "controls"
                 else results).append(r)
    return results, control_results, failures


def build_table(out: str, root: str, seeds: int,
                jax_table: str = os.path.join(JAX_REPLAY, "table.json")
                ) -> dict:
    results, control_results, failures = collect(out, seeds)
    b, cb = bands(results), bands(control_results)
    with open(jax_table) as f:
        jax = json.load(f)
    not_run = [os.path.relpath(d, out)
               for g in GROUPS for _, _, d, _ in jobs_for(g, root, seeds, out)
               if "test" not in (load_result(os.path.join(d, "result.json"))
                                 or {})]
    pose = [load_result(p) for p in sorted(glob.glob(
        os.path.join(out, "pose", "s*", "result.json")))]
    pose_ok = [p for p in pose if "pck10" in p]
    with open(JAX_POSE) as f:
        jax_pose = json.load(f)
    cards = sorted({r.get("nvidia_smi") for r in results + control_results
                    if r.get("nvidia_smi")})
    return {
        "meta": {
            "dataset": root, "seeds": seeds,
            "reference_table": "README.md:140-143 (spatial), "
                               ":149 (temporal)",
            "hypers": "preset-encoded (surya_tpu_torch/core/config.py)",
            "pipeline": "python -m surya_tpu_torch train (packed spatial "
                        "cache; packed sequence windows)",
            "jax_table": os.path.relpath(jax_table, REPO),
            "cards": cards},
        "bands": dict(sorted(b.items())),
        "control_bands": dict(sorted(cb.items())),
        "failures": failures,
        "orderings": orderings_of(b, cb),
        "vs_jax": vs_jax(b, jax["bands"]),
        "control_vs_jax": vs_jax(cb, jax.get("control_bands", {})),
        "not_run": not_run,
        "pose": {"runs": pose,
                 "pck10_mean": (float(np.mean([p["pck10"] for p in pose_ok]))
                                if pose_ok else None),
                 "mean_err_px_mean": (float(np.mean(
                     [p["mean_err_px"] for p in pose_ok])) if pose_ok
                     else None),
                 "jax": {k: jax_pose[k] for k in ("pck10", "mean_err_px",
                                                  "backend")}},
        "data": load_result(os.path.join(out, "data.json")),
        "cam": load_result(os.path.join(out, "cam.json")),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="surya_tpu_torch.bench.replay")
    ap.add_argument("--phase", required=True,
                    choices=("data", "spatial", "temporal", "pose", "cam",
                             "table"))
    ap.add_argument("--root", default=os.path.join(REPO, "build",
                                                   "replay224"))
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--rows", default="",
                    help="comma-separated row names (default: every row)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--nproc", type=int, default=1,
                    help="train each row data-parallel over this many "
                         "cards under torchrun (--mesh.data=N)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.makedirs(args.out, exist_ok=True)
    if args.phase == "data":
        record = data_phase(root, args.out)
        print(json.dumps(record), flush=True)
    elif args.phase in PHASE_GROUPS:
        rows = [r for r in args.rows.split(",") if r]
        done = training_phase(PHASE_GROUPS[args.phase], root, args.seeds,
                              args.out, rows, args.device, args.nproc)
        return 1 if any("test" not in r for r in done) else 0
    elif args.phase == "pose":
        rows = pose_phase(args.seeds, args.out, args.device)
        return 1 if any("error" in r for r in rows) else 0
    elif args.phase == "cam":
        print(json.dumps(cam_phase(root, args.out)), flush=True)
    else:
        table = build_table(args.out, root, args.seeds)
        with open(os.path.join(args.out, "table.json"), "w") as f:
            json.dump(table, f, indent=2)
        print(json.dumps({"bands": {k: round(v["mean"], 4)
                                    for k, v in table["bands"].items()},
                          "overlap": {k: v["overlap"] for k, v in
                                      table["vs_jax"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
