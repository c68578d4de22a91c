"""Video inference: per-frame pose classification with annotated output,
ported from ``surya_tpu/infer/video.py``.

Read a video, extract each frame's 47 pose features (landmark detection,
then ``features.extract_features_47`` on the device), classify, overlay
the predicted label and its softmax confidence, and write the annotated
video. Frames go through in batches: :func:`classify_frame_batch` is the
per-batch body, on decoded BGR uint8 frames, and needs neither cv2 nor
PIL, so it runs wherever frames come from; the video reader and
writer, the overlay and ``--display`` need cv2, a gated import, as does
MediaPipe, the default landmark extractor.

Usage:
  python -m surya_tpu_torch video CKPT VIDEO.mp4 --classes names.json \\
      [--out annotated.mp4] [--pose-ckpt pose.msgpack] [--device cpu]
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.data.augment import eval_preprocess
from surya_tpu_torch.data.resample import linear_resize
from surya_tpu_torch.features import extract_features_47
from surya_tpu_torch.models import get_model
from surya_tpu_torch.models.common import apply_mode_ablation
from surya_tpu_torch.ops import resolve_device


def make_frame_classifier(cfg: ModelConfig, variables,
                          image_size: int = 224, device=None) -> Callable:
    """→ classify(frames f32 [0,1] (B,H,W,3), feats (B,47)) → (pred (B,),
    confidence (B,)), on the device of its model (the card unless
    ``device="cpu"``). ``variables`` is the port's state_dict (or
    ``models.from_jax.from_jax_variables`` of a JAX tree).
    ``classify.probs(frames, feats)`` gives the whole softmax."""
    device = resolve_device(device)
    model = get_model(cfg, image_size=image_size)
    model.load_state_dict(variables, strict=True)
    model = model.to(device).eval()

    @torch.inference_mode()
    def probs(frames: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        images = eval_preprocess(frames.to(device), out_size=image_size)
        images, feats = apply_mode_ablation(cfg.mode, images, feats.to(device))
        return torch.softmax(model(images, feats).float(), dim=-1)

    def classify(frames: torch.Tensor, feats: torch.Tensor):
        p = probs(frames, feats)
        conf, pred = p.max(-1)
        return pred, conf

    classify.probs = probs
    classify.device = device
    return classify


def _landmarks(extractor, frames_bgr):
    """→ (list of (33, 4) landmarks, list of detected flags)."""
    if hasattr(extractor, "process_batch"):
        # a device extractor (the neural landmark net): one forward for
        # the whole batch
        results = extractor.process_batch(frames_bgr)
    elif hasattr(extractor, "process_array"):
        results = [extractor.process_array(f) for f in frames_bgr]
    else:   # path-based: hand each frame over through a temporary file
        import tempfile

        import cv2

        results = []
        for frame in frames_bgr:
            with tempfile.NamedTemporaryFile(suffix=".jpg") as tf:
                cv2.imwrite(tf.name, frame)
                results.append(extractor(tf.name))
    return [lm for lm, _ in results], [d for _, d in results]


def classify_frame_batch(classify, extractor, frames_bgr, class_names,
                         image_size: int = 224, start: int = 0):
    """One batch of decoded BGR uint8 frames (one size) → (records
    [{frame, label, confidence}] numbered from ``start``, landmarks,
    detected flags).

    Frames are staged as the JAX loop stages them (RGB / 255, then
    ``cv2.resize`` to ``image_size``, here :func:`data.resample.
    linear_resize` on the device); features are ``extract_features_47``
    with NaN → 0."""
    device = classify.device
    lms, det = _landmarks(extractor, frames_bgr)
    rgb = torch.as_tensor(np.stack(frames_bgr)).to(device).flip(-1)
    staged = linear_resize(rgb.float() / 255.0, (image_size, image_size))
    feats = torch.nan_to_num(extract_features_47(
        torch.as_tensor(np.stack(lms), dtype=torch.float32).to(device),
        torch.as_tensor(np.asarray(det)).to(device)))
    preds, confs = classify(staged, feats)
    records = [{"frame": start + i, "label": class_names[int(p)],
                "confidence": float(c)}
               for i, (p, c) in enumerate(zip(preds.tolist(),
                                              confs.tolist()))]
    return records, lms, det


def run_video_inference(cfg: ModelConfig, variables, video_path: str,
                        class_names: list[str],
                        output_path: str | None = None,
                        extractor=None, batch_size: int = 16,
                        image_size: int = 224,
                        display: bool = False, device=None) -> list[dict]:
    """→ per-frame records [{frame, label, confidence}]; optionally writes
    the annotated video, and with ``display=True`` shows each annotated
    frame in a window (``cv2.imshow``; 'q' quits; frames show in batch
    bursts)."""
    try:
        import cv2
    except ImportError as e:  # pragma: no cover
        raise ImportError("cv2 required for video IO") from e

    if extractor is None:
        from surya_tpu_torch.data.prep.still_image_dataset import (
            mediapipe_extractor,
        )
        extractor = mediapipe_extractor()

    classify = make_frame_classifier(cfg, variables, image_size, device)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = None
    if output_path:
        writer = cv2.VideoWriter(
            output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError(
                f"cv2.VideoWriter failed to open {output_path!r} "
                "(codec mp4v unavailable or path unwritable)")

    records = []
    done = False
    try:
        while not done:
            frames_bgr = []
            while len(frames_bgr) < batch_size:
                ok, frame = cap.read()
                if not ok:
                    done = True
                    break
                frames_bgr.append(frame)
            if not frames_bgr:
                break
            recs, lms, det = classify_frame_batch(
                classify, extractor, frames_bgr, class_names, image_size,
                start=len(records))
            records += recs
            if writer is None and not display:
                continue
            for rec, frame, lm, d in zip(recs, frames_bgr, lms, det):
                if d:
                    from surya_tpu_torch.data.prep.sequence_features import (
                        _annotate,
                    )

                    frame = _annotate(frame, lm)
                cv2.putText(frame, f"{rec['label']} ({rec['confidence']:.2f})",
                            (16, 40), cv2.FONT_HERSHEY_SIMPLEX, 1.0,
                            (0, 255, 0), 2)
                if writer is not None:
                    writer.write(frame)
                if display:
                    cv2.imshow("surya_tpu_torch inference", frame)
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        done = True
                        break
    finally:
        cap.release()
        if writer is not None:
            writer.release()
        if display:
            cv2.destroyAllWindows()
    return records


def main(argv: list[str] | None = None) -> int:
    """CLI entry (``python -m surya_tpu_torch video``)."""
    import argparse
    import json

    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables

    ap = argparse.ArgumentParser(prog="surya_tpu_torch video")
    ap.add_argument("params_path")
    ap.add_argument("video")
    ap.add_argument("--out", default=None)
    ap.add_argument("--model", default="quadtree")
    ap.add_argument("--mode", default="fusion")
    ap.add_argument("--classes", required=True,
                    help="JSON file with class names list")
    ap.add_argument("--display", action="store_true",
                    help="show annotated frames live (q to quit)")
    ap.add_argument("--pose-ckpt", default=None,
                    help="msgpack checkpoint of the landmark net "
                         "(models/pose, pose-train): replaces MediaPipe "
                         "for landmark extraction")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    with open(args.classes) as f:
        class_names = json.load(f)
    cfg = ModelConfig(name=args.model, mode=args.mode,
                      num_classes=len(class_names))
    extractor = None
    if args.pose_ckpt:
        from surya_tpu_torch.models.pose import load_pose_extractor

        extractor = load_pose_extractor(args.pose_ckpt, device=args.device)
    # a CheckpointManager dir, a .pt state_dict or a JAX .npz
    variables = load_checkpoint_variables(args.params_path)
    recs = run_video_inference(cfg, variables, args.video, class_names,
                               output_path=args.out, extractor=extractor,
                               display=args.display, device=args.device)
    print(json.dumps(recs[:10], indent=2))
    print(f"{len(recs)} frames classified")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
