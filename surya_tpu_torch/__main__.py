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
  python -m surya_tpu_torch export CKPT OUT.pt2 [--preset P] [--batch-size 32] \
      [--param-dtype bfloat16|float16|float32] \
      [--input-dtype float32|bfloat16|uint8]
  python -m surya_tpu_torch export-torch CKPT OUT.pth [--preset P]
  python -m surya_tpu_torch check [--device cpu]

``train``, ``eval`` and ``compare`` run on a mesh of ranks under
``torchrun`` (one process per device; ``--mesh.data``/``--mesh.model``
split it, and ``--train.zero1=true`` / ``--train.fsdp=true`` shard the
state):

  torchrun --nproc-per-node=N -m surya_tpu_torch train --mesh.data=N ...

CKPT is a checkpoint directory written by ``train`` (its latest step), one
of its ``<step>.pt`` files, a ``.pt`` of the port's ``state_dict`` or a
``.npz`` of a JAX variable tree (``/``-joined keys). ``pose-train`` writes
the pose net's msgpack artifact (the JAX package's format), which
``video --pose-ckpt`` reads. ``export`` writes a ``torch.export``
serving artifact (``infer.serve.load_exported`` runs it; it needs this
package where it runs, for the two kernels' operators); ``export-torch``
writes the reference's own state_dict (``.pth``); ``check`` reports the
environment and builds every kernel. Everything runs on the card;
``--device cpu`` runs the plain PyTorch path instead (for tests);
``ingest`` and ``export-torch`` are host file conversion.
Dotted ``--section.field=value`` flags override the preset.
"""

from __future__ import annotations

import json
import os
import sys


def _build_data(cfg, device, pad_eval_to: int = 1):
    """Pick the data source: synthetic, sequence (temporal models: packed
    or the ``.npz`` windows) or disk/packed (spatial models). Batches bound
    for a card are pinned by the source; eval batches are padded to a
    multiple of ``pad_eval_to`` (the mesh's data axis) with label −1 rows."""
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
        return ArrayDataSource(splits, cfg.data.batch_size,
                               pad_eval_to=pad_eval_to)
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
                                        pad_eval_to=pad_eval_to,
                                        pin_memory=pin)
        from surya_tpu_torch.data.sequences import SequenceDataSource

        return SequenceDataSource(cfg.data, seed=cfg.train.seed,
                                  pad_eval_to=pad_eval_to, pin_memory=pin)
    if cfg.data.packed_dir:
        from surya_tpu_torch.data.packed import PackedDataSource

        return PackedDataSource(cfg.data, seed=cfg.train.seed,
                                pad_eval_to=pad_eval_to, pin_memory=pin)
    from surya_tpu_torch.data.dataset import DiskDataSource

    return DiskDataSource(cfg.data, seed=cfg.train.seed,
                          pad_eval_to=pad_eval_to, pin_memory=pin)


def _build_mesh(cfg, device):
    """``init_process_group`` under ``torchrun`` (a no-op without it), the
    mesh of the ``--mesh.*`` config over its ranks, and on the card one
    build of the kernels (rank 0's) before the other ranks load them."""
    import torch.distributed as dist

    from surya_tpu_torch.core.mesh import (
        MeshSpec,
        create_mesh,
        maybe_initialize_distributed,
    )

    maybe_initialize_distributed(device)
    mesh = create_mesh(MeshSpec(data=cfg.mesh.data, model=cfg.mesh.model,
                                seq=cfg.mesh.seq), device)
    if mesh.distributed and device.type == "cuda":
        from surya_tpu_torch.ops.cuda import KERNELS, _build

        if mesh.is_main:
            _build.build_all(KERNELS)
        dist.barrier()
    return mesh


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
    if "train.checkpoint_dir" not in overrides:
        cfg = cfg.override(
            {"train.checkpoint_dir": os.path.join(args.out, "ckpt")})
    mesh = _build_mesh(cfg, device)
    if mesh.is_main:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "config.json"), "w") as f:
            f.write(cfg.to_json())

    data = _build_data(cfg, device, pad_eval_to=mesh.shape["data"])
    logger = (MetricsLogger(
        os.path.join(args.out, "metrics.jsonl"),
        tensorboard_dir=(os.path.join(args.out, "tb")
                         if args.tensorboard else None))
        if mesh.is_main else MetricsLogger(echo=False))
    try:
        summary = train_and_evaluate(cfg, data, mesh=mesh, logger=logger,
                                     resume=args.resume,
                                     profile_dir=args.profile_dir,
                                     device=device)
    finally:
        logger.close()
    if not mesh.is_main:
        return 0

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
    mesh = _build_mesh(cfg, device)
    data = _build_data(cfg, device, pad_eval_to=mesh.shape["data"])
    out = evaluate_checkpoint(cfg, load_checkpoint_variables(args.checkpoint),
                              data, split=args.split, device=device,
                              mesh=mesh)
    if not mesh.is_main:
        return 0
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
    mesh = _build_mesh(cfg0, device)
    summary = compare_models(entries, _build_data(
        cfg0, device, pad_eval_to=mesh.shape["data"]), split=args.split,
        out_dir=args.out, device=device, mesh=mesh)
    if not mesh.is_main:
        return 0
    if args.out:
        with open(os.path.join(args.out, "comparison.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


def cmd_export(argv: list[str]) -> int:
    """``torch.export`` a checkpoint as a fixed-batch serving artifact
    (``infer/serve.py``); ``infer.serve.load_exported`` runs it."""
    import argparse

    import torch

    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
    from surya_tpu_torch.infer.serve import export_model

    ap = argparse.ArgumentParser(prog="surya_tpu_torch export")
    ap.add_argument("checkpoint")
    ap.add_argument("out", help="output artifact path (.pt2)")
    ap.add_argument("--preset", default="quadtree-fusion")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--param-dtype", default=None,
                    choices=["bfloat16", "float16", "float32"],
                    help="cast baked-in weights (bfloat16 roughly "
                         "halves the artifact; BN stats stay f32)")
    ap.add_argument("--input-dtype", default="float32",
                    choices=["float32", "bfloat16", "uint8"],
                    help="image wire format: uint8 takes RAW 0-255 "
                         "pixels and bakes the /255 into the program "
                         "(4x smaller host->device transfer)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' traces on the CPU")
    args, rest = ap.parse_known_args(argv)
    cfg, _ = _config(args, rest)
    export_model(cfg.model, load_checkpoint_variables(args.checkpoint),
                 args.out, batch_size=args.batch_size,
                 image_size=cfg.data.image_size,
                 param_dtype=(None if args.param_dtype is None
                              else getattr(torch, args.param_dtype)),
                 input_dtype=args.input_dtype, device=args.device)
    print(json.dumps({"artifact": os.path.abspath(args.out),
                      "bytes": os.path.getsize(args.out),
                      "batch_size": args.batch_size,
                      "input_dtype": args.input_dtype,
                      "model": cfg.model.name}), flush=True)
    return 0


def cmd_export_torch(argv: list[str]) -> int:
    """Write a checkpoint as a reference-named torch state_dict
    (``models/full_export.py``, the inverse of ``full_import``): the
    ``.pth`` loads into the reference's own ``get_model`` with
    ``load_state_dict``. A host conversion: no device is used."""
    import argparse

    import torch

    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
    from surya_tpu_torch.models.full_export import export_reference_state_dict
    from surya_tpu_torch.models.full_import import family_kwargs

    ap = argparse.ArgumentParser(prog="surya_tpu_torch export-torch")
    ap.add_argument("checkpoint")
    ap.add_argument("out", help="output path (.pth)")
    ap.add_argument("--preset", default="quadtree-fusion")
    args, rest = ap.parse_known_args(argv)
    cfg, _ = _config(args, rest)
    sd = export_reference_state_dict(
        cfg.model.name, load_checkpoint_variables(args.checkpoint),
        **family_kwargs(cfg.model))
    torch.save(sd, args.out)
    print(json.dumps({"artifact": os.path.abspath(args.out),
                      "format": "torch", "model": cfg.model.name,
                      "tensors": len(sd)}), flush=True)
    return 0


def _card_report(report: dict) -> bool:
    """The card, nvidia-smi's name and power limit, nvcc, and each
    ``csrc/*.cu`` built and opened, into ``report``. → all present."""
    import shutil
    import subprocess

    import torch

    from surya_tpu_torch.ops.cuda import KERNELS, _build

    ok = torch.cuda.is_available()
    report["card"] = torch.cuda.get_device_name(0) if ok else None
    report["device_count"] = torch.cuda.device_count()
    smi = shutil.which("nvidia-smi")
    report["nvidia_smi"] = None if smi is None else subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    try:
        report["nvcc"], report["nvcc_version"] = _build.nvcc_version()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        report["nvcc"], report["nvcc_version"] = None, str(e)
        ok = False
    kernels = report["kernels"] = {}
    for name in KERNELS:
        if report["nvcc"] is None:
            kernels[name] = {"built": False, "error": "no nvcc"}
            continue
        try:
            kernels[name] = {"built": True,
                             "library": str(_build.build_and_open(name))}
        except (RuntimeError, OSError) as e:
            kernels[name] = {"built": False, "error": str(e)[-2000:]}
            ok = False
    return ok


def cmd_check(argv: list[str]) -> int:
    """Environment report, as JSON: torch and CUDA, the card and its power
    limit, nvcc, whether each kernel of ``csrc/`` builds and loads, the
    native decoder and the optional packages of ``python -m surya_tpu
    check``. Exits 1 when there is no card or a kernel fails to build
    (the report is printed all the same); ``--device cpu`` reports without
    building."""
    import argparse
    import importlib.util

    import torch

    from surya_tpu_torch import native

    ap = argparse.ArgumentParser(prog="surya_tpu_torch check")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' skips the card checks")
    args = ap.parse_args(argv)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "cuda_available": torch.cuda.is_available()}
    ok = True
    if args.device != "cpu":
        ok = _card_report(report)
    for dep, why in [("PIL", "image IO"), ("cv2", "video IO/skeletons"),
                     ("msgpack", "pose checkpoints (core/flax_msgpack.py)"),
                     ("mediapipe", "pose landmark extraction (optional: "
                                   "the port's landmark net needs none)"),
                     ("rembg", "background removal (optional)"),
                     ("diffusers", "Zero123-Plus multiview (optional)"),
                     ("matplotlib", "plots"),
                     ("sklearn", "metric cross-checks (tests)")]:
        report[dep] = {"available": importlib.util.find_spec(dep) is not None,
                       "needed_for": why}
    report["native_decoder"] = native.available()
    print(json.dumps(report, indent=2), flush=True)
    return 0 if ok else 1


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
                "pose-train": cmd_pose_train, "export": cmd_export,
                "export-torch": cmd_export_torch, "check": cmd_check}
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
