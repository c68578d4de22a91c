"""CLI of the PyTorch port, with the commands and flags of
``python -m surya_tpu``:

  python -m surya_tpu_torch list-presets
  python -m surya_tpu_torch train --preset quadtree-fusion \\
      [--synthetic] [--out DIR] [--plot] [--resume] [--profile-dir DIR] \\
      [--device cpu] [--train.lr=3e-4 ...]
  python -m surya_tpu_torch eval CKPT [--preset P] [--split test] [--synthetic]
  python -m surya_tpu_torch compare NAME=CKPT:PRESET ... [--split valid] [--out DIR]
  python -m surya_tpu_torch pack --root DATA --out DIR [--staging 256]
  python -m surya_tpu_torch pack --sequences --root SEQ --out DIR [--seq-len 5]
  python -m surya_tpu_torch serve CKPT [--preset P] [--port 8577] [--classes names.json]
  python -m surya_tpu_torch cam CKPT [--preset P] [--target layer4] [--out DIR] [--limit N]
  python -m surya_tpu_torch pose-train [--steps 600] [--batch 64] [--image-size 256] \
      [--width 32] [--lr 1e-3] [--out DIR] [--seed 0] [--occlude-p 0] [--mirror-p 0]
  python -m surya_tpu_torch video CKPT VIDEO.mp4 --classes names.json \
      [--out annotated.mp4] [--pose-ckpt pose.msgpack] [--display]
  python -m surya_tpu_torch ingest pt-windows PT_ROOT OUT_ROOT
  python -m surya_tpu_torch ingest clip-csv PROCESSED_ROOT OUT_ROOT

CKPT is a checkpoint directory written by ``train`` (its latest step), one
of its ``<step>.pt`` files, a ``.pt`` of the port's ``state_dict`` or a
``.npz`` of a JAX variable tree (``/``-joined keys). ``pose-train`` writes
the pose net's msgpack artifact (the JAX package's format), which
``video --pose-ckpt`` reads. Everything runs on the card; ``--device cpu``
runs the plain PyTorch path instead (for tests); ``ingest`` is host file
conversion.
Dotted ``--section.field=value`` flags override the preset.
"""

from __future__ import annotations

import json
import os
import sys


def _build_data(cfg, device):
    """Pick the data source: synthetic, sequence (temporal models: packed
    or the ``.npz`` windows) or disk/packed (spatial models). Batches bound
    for a card are pinned by the source."""
    from surya_tpu_torch.models.registry import TEMPORAL_MODELS

    temporal = cfg.model.name in TEMPORAL_MODELS
    pin = device.type == "cuda"
    if cfg.data.synthetic:
        from surya_tpu_torch.data import (
            ArrayDataSource,
            make_synthetic_spatial,
            make_synthetic_temporal,
        )

        gen = make_synthetic_temporal if temporal else make_synthetic_spatial
        kw = dict(num_classes=cfg.model.num_classes,
                  image_size=cfg.data.image_size)
        if temporal:
            kw["seq_len"] = cfg.data.seq_len
        splits = {s: gen(per_class=max(cfg.data.synthetic_size
                                       // cfg.model.num_classes, 2),
                         seed=i, **kw)
                  for i, s in enumerate(("train", "valid", "test"))}
        return ArrayDataSource(splits, cfg.data.batch_size)
    if temporal:
        if cfg.data.seq_len != cfg.model.seq_len:
            raise ValueError(
                f"data.seq_len={cfg.data.seq_len} != "
                f"model.seq_len={cfg.model.seq_len}; override both "
                "together (the model's temporal embedding is sized to "
                "its seq_len)")
        if cfg.data.packed_dir:
            from surya_tpu_torch.data.packed import PackedSequenceSource

            return PackedSequenceSource(cfg.data, seed=cfg.train.seed,
                                        pin_memory=pin)
        from surya_tpu_torch.data.sequences import SequenceDataSource

        return SequenceDataSource(cfg.data, seed=cfg.train.seed,
                                  pin_memory=pin)
    if cfg.data.packed_dir:
        from surya_tpu_torch.data.packed import PackedDataSource

        return PackedDataSource(cfg.data, seed=cfg.train.seed,
                                pin_memory=pin)
    from surya_tpu_torch.data.dataset import DiskDataSource

    return DiskDataSource(cfg.data, seed=cfg.train.seed, pin_memory=pin)


def _config(args, rest):
    from surya_tpu_torch.core.config import get_preset, parse_cli_overrides

    cfg = get_preset(args.preset)
    if getattr(args, "synthetic", False):
        cfg = cfg.override({"data.synthetic": "true"})
    overrides = parse_cli_overrides(rest) if rest else {}
    return (cfg.override(overrides) if overrides else cfg), overrides


def kernel_launches() -> dict:
    """The kernel wrappers' launch counters of this process: training and
    inference form of the quadrant and fusion-head kernels, and each
    stem-BN kernel's count."""
    from surya_tpu_torch.ops.cuda import fusion_head, quadrant, stem_bn

    counts = {name: {"training": m.training_launches,
                     "inference": m.launches - m.training_launches}
              for name, m in (("quadrant", quadrant),
                              ("fusion_head", fusion_head))}
    return {**counts, **stem_bn.launches}


def cmd_train(argv: list[str]) -> int:
    import argparse

    from surya_tpu_torch.core.metrics import MetricsLogger
    from surya_tpu_torch.ops import resolve_device
    from surya_tpu_torch.train import train_and_evaluate

    ap = argparse.ArgumentParser(prog="surya_tpu_torch train")
    ap.add_argument("--preset", default="quadtree-fusion")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out", default="runs/torch_latest")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint (incl. optimizer "
                         "state) and continue")
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler Chrome trace of the second epoch")
    ap.add_argument("--tensorboard", action="store_true",
                    help="mirror metrics as TensorBoard scalars under "
                         "OUT/tb")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection, and no NaN guard, "
                         "so the first NaN raises where it starts")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args, rest = ap.parse_known_args(argv)
    device = resolve_device(args.device)

    cfg, overrides = _config(args, rest)
    if args.debug_nans:
        import torch

        torch.autograd.set_detect_anomaly(True)
        cfg = cfg.override({"train.nan_guard": "false"})
    os.makedirs(args.out, exist_ok=True)
    if "train.checkpoint_dir" not in overrides:
        cfg = cfg.override(
            {"train.checkpoint_dir": os.path.join(args.out, "ckpt")})
    with open(os.path.join(args.out, "config.json"), "w") as f:
        f.write(cfg.to_json())

    data = _build_data(cfg, device)
    logger = MetricsLogger(
        os.path.join(args.out, "metrics.jsonl"),
        tensorboard_dir=(os.path.join(args.out, "tb")
                         if args.tensorboard else None))
    try:
        summary = train_and_evaluate(cfg, data, mesh=cfg.mesh, logger=logger,
                                     resume=args.resume,
                                     profile_dir=args.profile_dir,
                                     device=device)
    finally:
        logger.close()

    if args.plot:
        from surya_tpu_torch.utils.plotting import (
            plot_confusion_matrix,
            plot_history,
        )

        plot_history(summary["history"],
                     os.path.join(args.out, "history.png"),
                     summary["best_epoch"])
        if "test" in summary:
            names = getattr(data, "class_names",
                            [str(i) for i in range(cfg.model.num_classes)])
            plot_confusion_matrix(summary["test"]["confusion"], names,
                                  os.path.join(args.out, "confusion.png"))
    result = {k: v for k, v in summary.get("test", {}).items()
              if k != "confusion"}
    line = {"best_epoch": summary["best_epoch"],
            "best_metric": summary["best_metric"], "test": result,
            "preempted": summary["preempted"]}
    if device.type == "cuda":
        line["kernel_launches"] = kernel_launches()
    print(json.dumps(line), flush=True)
    return 0


def cmd_eval(argv: list[str]) -> int:
    """Evaluate a checkpoint on a split."""
    import argparse

    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
    from surya_tpu_torch.ops import resolve_device
    from surya_tpu_torch.train.compare import evaluate_checkpoint

    ap = argparse.ArgumentParser(prog="surya_tpu_torch eval")
    ap.add_argument("checkpoint")
    ap.add_argument("--preset", default="quadtree-fusion")
    ap.add_argument("--split", default="test")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default=None)
    args, rest = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    cfg, _ = _config(args, rest)
    data = _build_data(cfg, device)
    out = evaluate_checkpoint(cfg, load_checkpoint_variables(args.checkpoint),
                              data, split=args.split, device=device)
    line = {k: (v.tolist() if hasattr(v, "tolist") else float(v))
            for k, v in out.items() if k != "confusion"}
    if device.type == "cuda":
        line["kernel_launches"] = kernel_launches()
    print(json.dumps(line), flush=True)
    return 0


def cmd_cam(argv: list[str]) -> int:
    """Grad-CAM overlays of a checkpoint on a split (``interpret/
    gradcam.py``): the model classifies the transformed batch, the overlay
    is drawn on the raw one; one JPEG per image, in a directory per true
    class."""
    import argparse

    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
    from surya_tpu_torch.interpret.gradcam import save_batch_grad_cam
    from surya_tpu_torch.ops import resolve_device
    from surya_tpu_torch.train.steps import to_device

    ap = argparse.ArgumentParser(prog="surya_tpu_torch cam")
    ap.add_argument("checkpoint")
    ap.add_argument("--preset", default="quadtree-fusion")
    ap.add_argument("--split", default="test")
    ap.add_argument("--out", default="runs/cams")
    ap.add_argument("--target", default="layer4",
                    help="layer3|layer4 (quadtree), "
                         "layer2|level1|level2 (hierarchical families)")
    ap.add_argument("--alpha", type=float, default=0.4)
    ap.add_argument("--limit", type=int, default=0,
                    help="max batches (0 = all)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default=None)
    args, rest = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    cfg, _ = _config(args, rest)
    data = _build_data(cfg, device)
    state_dict = load_checkpoint_variables(args.checkpoint)
    names = getattr(data, "class_names",
                    [str(i) for i in range(cfg.model.num_classes)])
    transform = getattr(data, "device_transform", None)

    def batches():
        for i, b in enumerate(data.eval_batches(args.split)):
            if args.limit and i >= args.limit:
                break
            if transform is None:
                yield b
            else:   # classify the normalised images, overlay on the raw
                mb = transform(args.split, None, to_device(b, device))
                yield mb[0], mb[1], b[2], b[0]

    n = save_batch_grad_cam(cfg.model, state_dict, batches(), names,
                            args.out, target_layer=args.target,
                            alpha=args.alpha, device=device)
    print(f"wrote {n} CAM overlays to {args.out}")
    return 0


def cmd_pack(argv: list[str]) -> int:
    """Build the packed pre-decoded dataset cache (``data/packed.py``):
    one offline decode pass, then decode-free epochs through
    ``--data.packed_dir``; with ``--sequences``, the sequence pack of a
    windowed ``.npz`` dataset at ``--seq-len``."""
    import argparse

    from surya_tpu_torch.data.packed import pack_dataset, pack_sequences

    ap = argparse.ArgumentParser(prog="surya_tpu_torch pack")
    ap.add_argument("--root", default="data/flat_image_dataset_final")
    ap.add_argument("--out", required=True, help="pack output dir")
    ap.add_argument("--staging", type=int, default=256,
                    help="decoded side length (DiskDataSource staging)")
    ap.add_argument("--sequences", action="store_true",
                    help="pack a windowed .npz sequence dataset "
                         "(--root = seq_root) instead of the flat "
                         "image layout")
    ap.add_argument("--seq-len", type=int, default=4)
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)
    if args.sequences:
        meta = pack_sequences(args.root, args.out, seq_len=args.seq_len,
                              overwrite=args.overwrite)
    else:
        meta = pack_dataset(args.root, args.out, staging=args.staging,
                            overwrite=args.overwrite)
    print(json.dumps({"out": os.path.abspath(args.out),
                      "kind": meta["kind"], "splits": meta["splits"]}))
    return 0


def cmd_pose_train(argv: list[str]) -> int:
    """Train the pose-landmark net (the MediaPipe stand-in) on the
    synthetic generator; the artifact feeds ``video --pose-ckpt``. Exits 1
    when the holdout PCK@0.10 is 0."""
    import argparse

    from surya_tpu_torch.models.pose import train_pose_landmark
    from surya_tpu_torch.models.pose.train import POSE_OUT

    ap = argparse.ArgumentParser(prog="surya_tpu_torch pose-train")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=256,
                    help="training resolution (divisible by 16); "
                         "stored in the checkpoint")
    ap.add_argument("--width", type=int, default=32,
                    help="base channel width (divisible by 8)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=POSE_OUT,
                    help="run directory (default %(default)s; the tracked "
                         "runs/pose_landmark* are the JAX package's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--occlude-p", type=float, default=0.0,
                    help="per-sample random-patch occlusion probability "
                         "(on-device augmentation)")
    ap.add_argument("--mirror-p", type=float, default=0.0,
                    help="per-sample horizontal-mirror probability "
                         "(chirality augmentation)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    summary = train_pose_landmark(
        steps=args.steps, batch=args.batch, image_size=args.image_size,
        width=args.width, out_dir=args.out, peak_lr=args.lr,
        seed=args.seed, occlude_p=args.occlude_p, mirror_p=args.mirror_p,
        device=args.device)
    return 0 if summary["pck10"] > 0 else 1


def cmd_compare(argv: list[str]) -> int:
    """Evaluate N checkpoints on one split: accuracy, weighted P/R/F1 and
    R² per model, plus confusion matrices and a bar chart with --out.

      python -m surya_tpu_torch compare quadtree=runs/a/ckpt:quadtree-fusion \\
          other=runs/b/ckpt:quadtree-fusion [--split valid] [--out DIR]
    """
    import argparse

    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
    from surya_tpu_torch.core.config import get_preset, parse_cli_overrides
    from surya_tpu_torch.ops import resolve_device
    from surya_tpu_torch.train.compare import compare_models

    ap = argparse.ArgumentParser(prog="surya_tpu_torch compare")
    ap.add_argument("entries", nargs="+",
                    help="NAME=CKPT_PATH:PRESET triples")
    ap.add_argument("--split", default="valid")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args, rest = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    overrides = parse_cli_overrides(rest) if rest else {}

    entries = []
    for spec in args.entries:
        if "=" not in spec or ":" not in spec.split("=", 1)[1]:
            raise SystemExit(f"bad entry {spec!r}; "
                             "expected NAME=CKPT_PATH:PRESET")
        name, rhs = spec.split("=", 1)
        path, preset = rhs.rsplit(":", 1)
        cfg = get_preset(preset)
        if overrides:
            cfg = cfg.override(overrides)
        load_checkpoint_variables(path)  # fail fast on a bad path
        entries.append({"name": name, "cfg": cfg, "params_path": path})

    cfg0 = entries[0]["cfg"]
    # every entry is evaluated on entry 0's data pipeline, so the
    # data-relevant config must agree
    for e in entries[1:]:
        for field in ("image_size", "num_classes", "num_features",
                      "data_root", "seq_root", "synthetic"):
            v0, v = (getattr(cfg0.data, field, None),
                     getattr(e["cfg"].data, field, None))
            if v0 != v:
                raise SystemExit(
                    f"compare: entry {e['name']!r} data.{field}={v!r} "
                    f"differs from entry 0's {v0!r}; all entries share "
                    "one data pipeline — pass matching --data.* "
                    "overrides")
    summary = compare_models(entries, _build_data(cfg0, device),
                             split=args.split, out_dir=args.out,
                             device=device)
    if args.out:
        with open(os.path.join(args.out, "comparison.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


def cmd_list_presets() -> int:
    from surya_tpu_torch.core.config import get_preset, list_presets

    for name in list_presets():
        cfg = get_preset(name)
        print(f"{name:28s} model={cfg.model.name:20s} "
              f"bs={cfg.data.batch_size:<3d} lr={cfg.train.lr:g} "
              f"epochs={cfg.train.epochs}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "list-presets":
        return cmd_list_presets()
    commands = {"train": cmd_train, "eval": cmd_eval, "pack": cmd_pack,
                "compare": cmd_compare, "cam": cmd_cam,
                "pose-train": cmd_pose_train}
    if cmd in commands:
        return commands[cmd](rest)
    if cmd == "serve":
        from surya_tpu_torch.infer.http_server import main as serve_main

        return serve_main(rest)
    if cmd == "video":
        from surya_tpu_torch.infer.video import main as video_main

        return video_main(rest)
    if cmd == "ingest":
        from surya_tpu_torch.data.prep.ingest import main as ingest_main

        return ingest_main(rest)
    print(f"unknown command {cmd!r}\n{__doc__}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
