"""Smoke run of the PyTorch port (``surya_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``surya_tpu_torch/csrc`` and
holds each kernel, in its inference and its training form (outputs and
gradients), against its plain PyTorch version on the card (the head at the
temporal widths too). Then it drives its paths, with every kernel's launch
count set to 0 just before and read just after (the loop's in the CLI
processes that run it):

- **serve**: the flagship ``quadtree-fusion`` model (resnet18 trunk,
  224 px, 8 classes, random weights from seed 0, bf16 weights, uint8 wire,
  batch 64) over HTTP through ``PredictionServer``/``Predictor``;
- **train**: the same preset through ``create_train_state`` /
  ``make_train_step`` at batch 256, bf16 over f32 parameters, dropout 0.5,
  a fixed batch from seed 0, then an eval step; and one f32 step on the
  card against the same step on the CPU;
- **bench**: ``python -m surya_tpu_torch bench`` in three children:
  ``quadtree`` train at its defaults (batch 256, 20 steps), the same in
  infer mode, and ``BENCH_MODEL=quadtree-3d``; one line each with
  ``bench.py``'s keys, the card, and exactly 4 × 20 launches of each
  kernel form the model runs; the train line's images/s beside the
  ``train`` phase's;
- **augment**: ``device_transform`` at batch 256, 256 px → 224, train
  (augmentation) and eval (resize) split, on the card against the CPU
  with the same drawn parameters (plain PyTorch on both sides);
- **loop**: ``python -m surya_tpu_torch train --preset quadtree-fusion``
  as published (batch 16, augmentation on, bf16) for 2 epochs on a
  synthetic pack of the replay set's sizes, its second epoch traced;
  ``eval`` on the best checkpoint; a run sent SIGTERM at its first step
  and resumed;
- **replay**: the replay campaign's ``data`` phase at full width (1,280
  quality-92 JPEGs, 848 windows, ``pack`` and ``pack --sequences``), then
  seed 0 of ``quadtree-fusion`` through the published recipe (the CLI's
  ``train`` in a child: 10 epochs of 48 steps at batch 16, early stop,
  best reload): test accuracy at least 0.80, launches counted exactly;
  Grad-CAM on its best checkpoint, card vs CPU end to end at f32;
- **stem_probe**: a train-mode stem forward (cuDNN conv 7x7/2 on
  (256, 224, 224, 3) bf16, then the two stem-BN kernels) against
  ``F.batch_norm`` + ReLU on the same map;
- **spatial**: the other spatial configurations at 224 px, published
  widths, random weights from seed 0 — the three ``experiment-*`` presets
  (the quadtree, frozen trunk), the five ``comparative-*`` presets
  (StandardMultimodalCNN over resnet18/50, vgg16, mobilenet_v2,
  densenet121), ``hierarchical_quadtree``, ``attention_hierarchical`` and
  ``standard_resnet``: each one's f32 logits on the card against the CPU,
  bf16 ``Predictor.predict`` images/s at batch 64 and 5 bf16 train steps
  at the preset's batch with dropout 0.5, its kernel launches counted
  exactly; Grad-CAM at f32 on the card against the CPU for every target
  of the quadtree, the comparative resnet18 and both hierarchical
  families; the CLI's ``train`` (one epoch on a small synthetic pack) and
  ``eval`` for ``comparative-mobilenet-v2`` and for ``quadtree-fusion
  --model.name=hierarchical_quadtree``; and the head kernel timed at the
  two new edge widths (D 25,344 and D 128 → H 1024).
- **temporal**: ``cnn-lstm``, ``ji-3dcnn``, ``quadtree-3d`` (fusion and
  image_only), ``resnet3d-video``, ``hybrid-quadtree-3d`` (fusion and
  image_only), ``fact`` and ``fact-bs16`` at 224 px, 8 classes, 47
  features, each preset's own T (4, 5), random weights from seed 0: f32
  logits on the card against the CPU, bf16 ``Predictor.predict`` clips/s
  at the preset batch (uint8 wire) and 5 bf16 train steps at the preset
  batch, the head's launches counted exactly (none on FACT, whose head is
  LN + Dense); the frozen trunks held: cnn-lstm's BN statistics and the
  r3d models' stem..layer3 ones bit-unchanged by the steps while layer4's
  move, FACT's ViT parameters bit-unchanged; one temporal ``.npz``
  request to ``/predict``; the temporal replay set
  (``make_replay_temporal``) written as ``.npz`` windows, ``pack
  --sequences`` at T = 5 and 4, the CLI's ``train`` (2 epochs) and
  ``eval`` for ``quadtree-3d``, ``cnn-lstm``, ``hybrid-quadtree-3d`` and
  ``fact``; the head kernel timed at the six temporal widths in both
  forms.
- **pose**: ``python -m surya_tpu_torch pose-train`` at its published
  size (600 steps, batch 64, 256 px, width 32) in a child, its holdout
  PCK@0.10 held to 0.99; the JAX package's trained checkpoint
  (``runs/pose_landmark``) through ``core/flax_msgpack.py``, f32
  landmarks on the card against the CPU on 128 renders, bf16
  ``process_batch`` frames/s at batch 64; ``video``'s frame-batch core on
  64 class-conditional renders at batch 16 (the neural extractor,
  ``extract_features_47``, ``quadtree-fusion`` at 224 px from seed 0):
  exactly 4 quadrant and 4 head launches, each of them held against its
  plain version on the inputs it was given, and f32 probabilities card
  vs CPU, end to end and on the card's staged images and features.
- **export**: ``python -m surya_tpu_torch export`` of ``quadtree-fusion``
  (224 px, seed 0, batch 64) as a bf16 artifact on a uint8 wire and an
  f32 one, and of ``quadtree-3d`` at its batch of 8, each served by
  ``load_exported(...).call`` in a child that imports only
  ``surya_tpu_torch``: 640 images launch exactly 10 + 10 inference-form
  kernels, probabilities against the in-process ``Predictor`` (bf16
  2e-2, f32 1e-5; the f32 artifact on the CPU 1e-4 from the card), both
  operators and no training form in each graph, img/s of ``call``
  against ``Predictor.predict`` in turns; ``export-torch`` and back
  through ``load_reference_state_dict``, bit-equal; ``check`` exits 0
  naming the card and the three kernel builds.
- **generate**: the generative augmentation tier at published widths,
  weights from seed 0 (no pretrained file ships). U²-Net ``u2net`` and
  ``u2netp`` at 320²: f32 card vs CPU (the fused map and the alpha, 1e-4),
  bf16 frames/s at batch 16, ``process_pipeline`` over a renamed tree of
  2 clips × 6 frames of 480×640 (12 RGBA PNGs; a second run skips them).
  The zero123plus UNet (865,910,724 parameters) and the SD VAE
  (83,653,863): one write + read pass on a 128-px tile's latents and the
  VAE at 256 px, f32 card vs CPU (1e-4, TF32 off), bf16 vs f32 reported.
  The published trajectory in bf16: ``zero123plus_unet_generate_fn``
  (320-px tiles, a 3×2 grid, a 120×80 latent, 75 Euler-Ancestral steps,
  two UNet passes each) through ``process_augmentation`` on 2 clean PNGs:
  12 finite views, a resume that generates none, s/image, UNet
  forwards/s, peak memory, flops per step (``FlopCounterMode``), one
  profiled step's conv / attention / GroupNorm split. The TinyDenoiser
  path over the 12 PNGs (72 views). Then the clean frames as view 00,
  ``build_sequence_dataset`` (28 windows) and two ``cnn-lstm`` train steps
  at batch 16: exactly 2 training-form head launches, each held against
  its plain version on its own inputs.

The phases run in that order, with two exceptions that keep the script
well inside its time limit. The replay set is written and packed by a
child from the start, while the kernels build and are checked, and is
awaited before anything is timed. The stages whose children only check
results run side by side after **generate** (``side_by_side``): the
loop's eval and preempted run, the replay run and its Grad-CAM, the
spatial and temporal CLI runs, the export artifacts, and the gloo runs of
**parallel** and **fact_parallel**; then, one at a time, the stages they
hold that time something: the loop's resumed run, the timed bf16
artifact, and the NCCL runs. Every phase line carries ``at_s``, the
script's seconds so far.

It times kernels, serving and the train step with CUDA events; each
main-path kernel in turns with its library yardstick, after the same L2
flush, with the median of the per-pair ratio, its launch plan, and the
HGMMA count of its bf16 body read from the built library's SASS. One JSON
line per phase; then the card's name and power limit as ``nvidia-smi``
reports them, the ``kernels`` line, and the result line
``{"ok": true, "device": {...}}`` last. Any failed check raises, and the
script exits non-zero without a result line. It needs a CUDA device and
the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data sheet (dense, at its 700 W limit): device memory bytes/s
# and bf16 tensor-core FLOP/s, for the bounds of the bf16 kernels.
PEAK_BYTES_S, PEAK_BF16_FLOP_S = 3.35e12, 989e12
TRAIN_BATCH, TRAIN_STEPS = 256, 20

# first: the serving path's; (4, 14, 1024, 128): a resnet50 trunk's
# layer3; then the edges of the wgmma tilings: B in {1, 3, 256}, Cout 16,
# 64 and 256, Cin 32 and 1024, H 8, 14 and 28 (quadrants of 4, 7, 14);
# last: the video core's (pose phase, B 16)
QUADRANT_SHAPES = [(64, 14, 256, 128), (3, 28, 32, 16), (8, 8, 16, 8),
                   (4, 14, 1024, 128), (1, 14, 256, 128), (3, 8, 32, 16),
                   (256, 14, 256, 128), (2, 14, 256, 64), (2, 14, 256, 256),
                   (2, 28, 1024, 64), (3, 14, 32, 16), (16, 14, 256, 128)]
# first: the serving path's; then B in {1, 63, 100, 256, 257}, H a
# multiple of the 128-unit tile or not (2688, 40), D off the 64-wide K
# stage (264), C = 3; last: the video core's (pose phase, B 16)
HEAD_SHAPES = [(64, 5376, 2688, 8), (5, 256, 128, 3), (1, 5376, 2688, 8),
               (63, 256, 128, 8), (100, 264, 40, 5), (256, 5376, 2688, 8),
               (257, 512, 2688, 3), (16, 5376, 2688, 8)]
# the other spatial families' heads at 224 px (spatial phase): the
# comparative ones over vgg16 (D 25,344: 396 K steps), resnet50,
# mobilenet_v2 and densenet121, the hierarchical and attention ones,
# numerical_only (D 128 → H 1024), standard_resnet, the experiment presets
SPATIAL_HEAD_SHAPES = [(16, 25344, 512, 8), (64, 2176, 1024, 8),
                       (64, 1216, 1024, 8), (16, 128, 1024, 8),
                       (64, 512, 256, 8), (16, 2304, 512, 8),
                       (64, 1536, 512, 8), (16, 1280, 512, 8),
                       (16, 5120, 2560, 8), (16, 256, 128, 8)]
HEAD_SHAPES += SPATIAL_HEAD_SHAPES
# the temporal families' heads at their preset batches (temporal phase):
# cnn-lstm (D 256 → 128, B 32), ji-3dcnn (192 → 128, B 8), quadtree-3d in
# fusion (1536 → 768) and image_only (1024 → 512) mode, B 8; resnet3d-video
# and hybrid-quadtree-3d image_only (512 → 256), hybrid fusion (768 → 384)
TEMPORAL_HEAD_SHAPES = [(32, 256, 128, 8), (8, 192, 128, 8),
                        (8, 1536, 768, 8), (8, 1024, 512, 8),
                        (8, 512, 256, 8), (8, 768, 384, 8)]
HEAD_SHAPES += TEMPORAL_HEAD_SHAPES
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel - plain| / max |plain|


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so
    far (``at_s``), so the lines give the run's time line."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj), flush=True)


def card_info():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return smi


def clocks() -> str:
    """SM clock, memory clock, power draw and temperature right now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# kernel inputs and checks
# ---------------------------------------------------------------------------

def quadrant_inputs(b, h, cin, cout, dtype, seed=0, ones=False):
    if ones:
        fmap = np.ones((b, h, h, cin), np.float32)
        kernel = np.ones((3, 3, cin, cout), np.float32)
        bias = np.zeros((cout,), np.float32)
    else:
        rng = np.random.default_rng(seed)
        fmap = rng.normal(size=(b, h, h, cin)).astype(np.float32)
        kernel = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(
            np.float32)
        bias = rng.normal(size=(cout,)).astype(np.float32)
    dev = lambda a, dt=dtype: torch.from_numpy(a).cuda().to(dt)  # noqa: E731
    return dev(fmap), dev(kernel), dev(bias, torch.float32)


def head_inputs(b, d, h, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, d)) * 0.1).astype(np.float32)
    w1 = (rng.normal(size=(h, d)) * 0.02).astype(np.float32)
    b1 = rng.normal(size=(h,)).astype(np.float32)
    w2 = (rng.normal(size=(c, h)) * 0.02).astype(np.float32)
    b2 = rng.normal(size=(c,)).astype(np.float32)
    dev = lambda a, dt=dtype: torch.from_numpy(a).cuda().to(dt)  # noqa: E731
    return (dev(x), dev(w1), dev(b1, torch.float32), dev(w2),
            dev(b2, torch.float32))


def compare(got, plain_f32):
    got, want = got.float(), plain_f32.float()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    return err, err / scale


def check_kernels(quadrant, fusion_head):
    """Each kernel against its plain version on the same inputs: f32 to
    1e-4 relative; bf16 against the plain version run in f32 on the same
    bf16-rounded inputs, to 2e-2 relative. A second launch on the same
    inputs must give the same bits."""
    results, failed = {}, []
    cases = []
    for shape in QUADRANT_SHAPES + [(1, 8, 4, 4, "ones")]:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("quadrant", shape, dtype))
    for shape in HEAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("fusion_head", shape, dtype))
    for name, shape, dtype in cases:
        if name == "quadrant":
            ones = shape[-1] == "ones"
            args = quadrant_inputs(*shape[:4], dtype, ones=ones)
            got = quadrant.quadrant_process(*args)
            again = quadrant.quadrant_process(*args)
            want = quadrant.quadrant_process_plain(
                *(a.float() for a in args))
            ok_shape = got.shape == want.shape and got.dtype == dtype
        else:
            args = head_inputs(*shape, dtype)
            got = fusion_head.fusion_head(*args)
            again = fusion_head.fusion_head(*args)
            want = fusion_head.fusion_head_plain(*(a.float() for a in args))
            ok_shape = got.shape == want.shape and got.dtype == torch.float32
        torch.cuda.synchronize()
        err, rel = compare(got, want)
        dname = str(dtype).removeprefix("torch.")
        same = bool(torch.equal(got, again))
        ok = ok_shape and same and rel <= TOL[dname] and bool(
            torch.isfinite(got.float()).all())
        row = {"phase": "check", "kernel": name, "shape": list(shape),
               "dtype": dname, "max_abs_err": err, "max_rel_err": rel,
               "tol": TOL[dname], "same_bits_twice": same, "ok": ok}
        emit(row)
        results[(name, tuple(shape), dname)] = row
        if not ok:
            failed.append(row)
    if failed:
        raise AssertionError(f"{len(failed)} kernel checks failed: {failed}")
    return results


# ---------------------------------------------------------------------------
# serving path
# ---------------------------------------------------------------------------

def npz_bytes(images, feats) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, images=images, features=feats)
    return buf.getvalue()


def http_json(url, body=None):
    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": "application/x-npz"} if body else {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def serve_phase(quadrant, fusion_head, card):
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.infer.http_server import PredictionServer
    from surya_tpu_torch.infer.serve import Predictor
    from surya_tpu_torch.models import get_model

    cfg = get_preset("quadtree-fusion")
    size = cfg.data.image_size
    state = get_model(cfg.model, image_size=size, seed=0).state_dict()
    predictor = Predictor(cfg.model, state, batch_size=64,
                          param_dtype=torch.bfloat16, input_dtype="uint8")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (100, size, size, 3), dtype=np.uint8)
    feats = rng.normal(size=(100, cfg.model.num_features)).astype(np.float32)

    # the layer3 map the quadrant kernel reads: NHWC view of channels_last
    with torch.inference_mode():
        x = torch.from_numpy(images[:2]).cuda().float() / 255.0
        l3 = predictor.model.trunk(x, upto="layer3")["out"]
        layer3_contiguous = bool(l3.is_contiguous())

    server = PredictionServer(predictor)
    httpd = server.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        health = http_json(url + "/healthz")
        assert health["status"] == "ok" and health["batch_size"] == 64
        quadrant.launches = fusion_head.launches = 0
        replies, latency = [], []
        for n in (1, 64, 100):
            t0 = time.perf_counter()
            replies.append(http_json(url + "/predict",
                                     npz_bytes(images[:n], feats[:n])))
            latency.append(time.perf_counter() - t0)
        launches = {"quadrant": quadrant.launches,
                    "fusion_head": fusion_head.launches}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()

    for n, rep in zip((1, 64, 100), replies):
        probs = np.asarray(rep["probabilities"], np.float64)
        preds = np.asarray(rep["predictions"])
        assert rep["n"] == n and probs.shape == (n, 8) and preds.shape == (n,)
        assert np.isfinite(probs).all()
        assert np.abs(probs.sum(-1) - 1).max() < 1e-4, probs.sum(-1)
        assert ((preds >= 0) & (preds < 8)).all()
    assert launches == {"quadrant": 4, "fusion_head": 4}, launches
    emit({"phase": "serve", "requests": [1, 64, 100],
          "request_s": latency, "launches": launches,
          "layer3_nhwc_contiguous": layer3_contiguous, **card})

    # f32 on the card against f32 on the CPU, same weights and images
    f32 = dataclasses.replace(cfg.model, compute_dtype="float32")
    p_gpu = Predictor(f32, state, batch_size=8, input_dtype="uint8")
    p_cpu = Predictor(f32, state, batch_size=8, input_dtype="uint8",
                      device="cpu")
    pred_g, prob_g = p_gpu.predict(images[:8], feats[:8])
    pred_c, prob_c = p_cpu.predict(images[:8], feats[:8])
    err = float(np.abs(prob_g - prob_c).max())
    top2 = np.sort(prob_c, -1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2e-4   # not a tie at this tol
    same = bool((pred_g == pred_c)[decided].all())
    emit({"phase": "serve_f32_parity", "max_abs_prob_err": err, "tol": 1e-4,
          "argmax_equal": same, "near_ties": int((~decided).sum())})
    assert err <= 1e-4 and same, (err, pred_g, pred_c)
    return predictor, images, feats, launches


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

# About 0.5 ms of the card's clock: a spin queued before each timed launch,
# so that the host's enqueue of the call (30-125 us through Python and the
# wrappers, measured on the chip machine) is over before the start event
# and the events time the device's work alone.
HIDE_HOST_CYCLES = 1_000_000


def time_ms(fn, flush=None, reps=20, hide_host=True, spin=HIDE_HOST_CYCLES):
    """Median device time of ``fn`` over ``reps`` launches, each timed by
    CUDA events after a write of ``flush`` that evicts the 50 MB L2, as
    the serving path (trunk between heads) leaves it cold. Without
    ``hide_host`` the events also count the time the card waits for the
    host to enqueue ``fn``; with it, a spin of ``spin`` cycles (longer
    than the enqueue) is queued before the start event."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if hide_host:
            torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def enqueue_ms(fn, reps=10, spin=HIDE_HOST_CYCLES):
    """Median host time of a call of ``fn`` that launches and does not
    wait for the card: the card is kept busy by a spin of ``spin`` cycles
    queued before each call, so the call's time is its enqueue."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_pair(kernel_fn, library_fn, flush, reps=20):
    """The kernel and its library yardstick in turns, each launch timed by
    CUDA events after the same L2-evicting write of ``flush`` (and the same
    spin that hides the host's enqueue): the median
    of each and the median of the per-pair ratio kernel / library, so
    that a drift of the card between launches moves both sides of a
    pair."""
    for _ in range(3):
        kernel_fn()
        library_fn()
    torch.cuda.synchronize()
    times = ([], [])
    for _ in range(reps):
        for fn, out in zip((kernel_fn, library_fn), times):
            flush.zero_()
            torch.cuda._sleep(HIDE_HOST_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    ratios = [k / lib for k, lib in zip(*times)]
    return (statistics.median(times[0]), statistics.median(times[1]),
            statistics.median(ratios))


def timed_row(kernel_fn, plain_fn, library_fn, flush, nbytes, flops, plan):
    ms, library_ms, ratio = time_pair(kernel_fn, library_fn, flush)
    bound_bytes, bound_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return {"ms": ms, "plain_ms": time_ms(plain_fn, flush),
            "library_ms": library_ms, "ratio_vs_library_median": ratio,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bound_bytes, bound_ops) * 1e3,
            "bound_by": "bytes" if bound_bytes > bound_ops else "operations",
            "plan": plan}


def head_timed(fusion_head, shape, flush, train=False):
    """The head kernel at ``shape`` (B, D, H, C) in bf16, timed in turns
    with its library composition (addmm + ReLU + addmm; with ``train``,
    dropout 0.5 and the h output, and F.dropout in the composition)."""
    bf = torch.bfloat16
    b, d, hdim, c = shape
    x, w1, b1, w2, b2 = head_inputs(b, d, hdim, c, bf)
    b1_bf, b2_bf = b1.to(bf), b2.to(bf)
    nbytes = ((x.numel() + w1.numel() + w2.numel()) * 2
              + (b1.numel() + b2.numel() + b * c) * 4)
    if not train:
        return timed_row(
            lambda: fusion_head.fusion_head(x, w1, b1, w2, b2),
            lambda: fusion_head.fusion_head_plain(x, w1, b1, w2, b2),
            lambda: torch.addmm(b2_bf, torch.relu(torch.addmm(b1_bf, x,
                                                              w1.t())),
                                w2.t()), flush,
            nbytes=nbytes, flops=2 * b * hdim * (d + c),
            plan=fusion_head.launch_plan(b, d, hdim))
    seed = torch.tensor([1234], dtype=torch.int64, device="cuda")
    keep = torch.rand(b, hdim, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)) >= 0.5
    return timed_row(
        lambda: fusion_head.fusion_head_with_h(x, w1, b1, w2, b2, rate=0.5,
                                               seed=seed),
        lambda: fusion_head.fusion_head_plain(x, w1, b1, w2, b2, 0.5, keep,
                                              with_h=True),
        # a yardstick only: F.dropout draws from the global generator
        lambda: torch.addmm(b2_bf, F.dropout(torch.relu(torch.addmm(
            b1_bf, x, w1.t())), 0.5, True), w2.t()), flush,
        nbytes=nbytes + b * hdim * 2 + 8, flops=2 * b * hdim * (d + c),
        plan=fusion_head.launch_plan(b, d, hdim))


def time_phase(quadrant, fusion_head, card, hgmma):
    from surya_tpu_torch.ops.quadtree import quadrant_split

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bf = torch.bfloat16
    rows, shapes = {}, {}

    # the inference forms at the serving batch
    b, h, cin, cout = QUADRANT_SHAPES[0]
    fmap, kernel, bias = quadrant_inputs(b, h, cin, cout, bf)
    hp = h // 4
    q = quadrant_split(fmap).permute(0, 3, 1, 2)           # channels_last
    w_oihw = kernel.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bias_bf = bias.to(bf)
    shapes["quadrant"] = (b, h, cin, cout)
    rows["quadrant"] = timed_row(
        lambda: quadrant.quadrant_process(fmap, kernel, bias),
        lambda: quadrant.quadrant_process_plain(fmap, kernel, bias),
        lambda: F.max_pool2d(F.relu(F.conv2d(q, w_oihw, bias_bf,
                                             padding=1)), 2, 2), flush,
        nbytes=(fmap.numel() * 2 + kernel.numel() * 2 + bias.numel() * 4
                + b * 4 * hp * hp * cout * 2),
        flops=2 * b * 4 * (2 * hp) ** 2 * 9 * cin * cout,  # pooled outputs
        plan=quadrant.launch_plan(b, h, cin, cout, False))

    shapes["fusion_head"] = HEAD_SHAPES[0]
    rows["fusion_head"] = head_timed(fusion_head, HEAD_SHAPES[0], flush)

    # the training forms at the train step's batch: all hq x hq conv
    # outputs and the act map; dropout and the h output
    b = TRAIN_BATCH
    _, h, cin, cout = QUADRANT_SHAPES[0]
    fmap, kernel, bias = quadrant_inputs(b, h, cin, cout, bf)
    q = quadrant_split(fmap).permute(0, 3, 1, 2)

    def library_quadrant_train():
        act = F.relu(F.conv2d(q, w_oihw, bias_bf, padding=1))
        return F.max_pool2d(act, 2, 2), act

    shapes["quadrant_train"] = (b, h, cin, cout)
    rows["quadrant_train"] = timed_row(
        lambda: quadrant.quadrant_process_with_act(fmap, kernel, bias),
        lambda: quadrant.quadrant_process_plain(fmap, kernel, bias,
                                                with_act=True),
        library_quadrant_train, flush,
        nbytes=(fmap.numel() * 2 + kernel.numel() * 2 + bias.numel() * 4
                + b * 4 * hp * hp * cout * 2 + b * h * h * cout * 2),
        flops=2 * b * h * h * 9 * cin * cout,              # every position
        plan=quadrant.launch_plan(b, h, cin, cout, True))

    shapes["fusion_head_train"] = (b,) + HEAD_SHAPES[0][1:]
    rows["fusion_head_train"] = head_timed(
        fusion_head, shapes["fusion_head_train"], flush, train=True)
    after = clocks()
    for name, row in rows.items():
        row["hgmma_in_bf16_body"] = hgmma[name.removesuffix("_train")]
        emit({"phase": "time", "kernel": name, "dtype": "bfloat16",
              "clocks_after": after, "shape": list(shapes[name]), **row,
              **card})
    return rows


def hgmma_counts():
    """HGMMA instructions in the SASS of each bf16 wgmma body, read with
    cuobjdump from the built library: proof that wgmma is what runs."""
    import os

    from torch.utils.cpp_extension import CUDA_HOME
    from surya_tpu_torch.ops.cuda import _build

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    counts = {}
    for lib, body in (("quadrant", "quadrant_wgmma_kernel"),
                      ("fusion_head", "head_wgmma_kernel")):
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        n, inside = 0, False
        for line in sass.splitlines():
            if "Function :" in line:
                inside = body in line
            elif inside and "HGMMA" in line:
                n += 1
        counts[lib] = n
    emit({"phase": "sass", "hgmma": counts})
    if not all(counts.values()):
        raise AssertionError(f"a bf16 body has no HGMMA: {counts}")
    return counts


def forward_split(predictor, images, feats, card):
    """Device time of one batch-64 forward and of its trunk, beside the
    host-clock time per chunk of ``Predictor.predict``."""
    model = predictor.model
    with torch.inference_mode():
        x = torch.from_numpy(images[:64]).cuda().float() / 255.0
        f = torch.from_numpy(feats[:64]).cuda()
        # host enqueue included: the forward waits on its ~60 launches
        fwd = time_ms(lambda: model(x, f), hide_host=False)
        trunk = time_ms(lambda: model.trunk(
            x, upto="layer4", capture=("layer3",)), hide_host=False)
    emit({"phase": "forward_split", "batch": 64, "forward_ms": fwd,
          "trunk_ms": trunk, **card})
    return fwd, trunk


def serve_throughput(predictor, images, feats, card, runs=3):
    big_i = np.concatenate([images] * 7)[:640]
    big_f = np.concatenate([feats] * 7)[:640]
    predictor.predict(big_i[:64], big_f[:64])              # warm-up
    rates = []
    for _ in range(runs):
        t0 = time.perf_counter()
        preds, _ = predictor.predict(big_i, big_f)
        rates.append(640 / (time.perf_counter() - t0))
        assert preds.shape == (640,)
    emit({"phase": "serve_throughput", "images": 640, "batch_size": 64,
          "runs": runs, "img_per_s": rates,
          "img_per_s_median": statistics.median(rates),
          "ms_per_chunk_median": 64e3 / statistics.median(rates), **card})


# ---------------------------------------------------------------------------
# training forms: outputs and gradients against the plain versions
# ---------------------------------------------------------------------------

# last shape: the train step's own; (2, 6, ..) has odd 3x3 quadrants on the
# CUDA-core body, (2, 30, ..) 15x15 quadrants on the wgmma body; then the
# tilings' edges: B 1 and 64, Cout 64 and 256, Cin 32 and 1024, H 8 and 28
QUADRANT_TRAIN_SHAPES = [(16, 14, 256, 128), (3, 28, 32, 16), (2, 6, 4, 2),
                         (2, 30, 16, 16), (1, 14, 256, 128), (3, 8, 32, 64),
                         (2, 14, 1024, 256), (64, 14, 256, 128),
                         (2, 28, 256, 16), (TRAIN_BATCH, 14, 256, 128)]
HEAD_TRAIN_SHAPES = [(64, 256, 512, 8), (8, 64, 32, 8), (70, 264, 40, 5),
                     (1, 5376, 2688, 8), (100, 264, 40, 3),
                     (257, 512, 2688, 8), (16, 25344, 512, 8),
                     (16, 128, 1024, 8), *TEMPORAL_HEAD_SHAPES,
                     (TRAIN_BATCH, 5376, 2688, 8)]
# relL2 of a gradient against autograd through the plain version in f32 on
# the same rounded inputs. f32: both sides sum the same products in another
# order. bf16: the kernel path rounds cotangents and gradients to bf16.
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# The quadrant block in bf16 saves act in bf16, as JAX does, so two values
# of a pool window that round to one bf16 value tie and the gradient goes
# to the first: against the f32 reference that alone is several percent.
# There the kernel is held against the same backward fed by the plain
# version's act, where only a rounding that differs by one bf16 step can
# move a tie, and the f32 reference is reported beside it.
QUADRANT_BF16_GRAD_TOL = 5e-2
STEM_SHAPES = [((4, 16, 16, 64), "float32"), ((2, 14, 14, 64), "bfloat16"),
               ((3, 7, 5, 24), "float32"), ((3, 7, 5, 5), "float32"),
               ((3, 7, 5, 5), "bfloat16"), ((8, 112, 112, 64), "bfloat16")]
STEM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # rtol = atol, as JAX's test


def rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / (want.norm() + 1e-30)).item()


def leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def finish_checks(rows):
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"{len(failed)} checks failed: {failed}")


def check_quadrant_train(quadrant):
    """(out, act) of the training form against the plain version, and the
    three gradients of sum(out^2) through the autograd Function (kernel
    forward, hand-written backward) against autograd through the plain
    version in f32."""
    rows, results = [], {}
    for shape in QUADRANT_TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            fmap, kernel, bias = quadrant_inputs(*shape, dtype)
            k32 = kernel.float()        # f32 parameter, values as rounded
            out, act = quadrant.quadrant_process_with_act(fmap, k32, bias)
            out2, act2 = quadrant.quadrant_process_with_act(fmap, k32, bias)
            want_out, want_act = quadrant.quadrant_process_plain(
                fmap.float(), k32, bias, with_act=True)
            torch.cuda.synchronize()
            err, rel = compare(out, want_out)
            act_err, act_rel = compare(act, want_act)
            row = {"phase": "check", "kernel": "quadrant_train",
                   "shape": list(shape), "dtype": dname, "max_abs_err": err,
                   "max_rel_err": rel, "act_max_rel_err": act_rel,
                   "tol": TOL[dname], "same_bits_twice": bool(
                       torch.equal(out, out2) and torch.equal(act, act2))}
            ok = (row["same_bits_twice"] and out.dtype == dtype
                  and act.dtype == dtype
                  and act.shape == want_act.shape
                  and max(rel, act_rel) <= TOL[dname])
            if shape[0] <= 16:
                # a cotangent 2 * out + 1: not 0 where the output is, so the
                # act > 0 mask after the pool VJP matters
                f, k, b = leaves(fmap, k32, bias)
                before = quadrant.launches
                got = quadrant.quadrant_process(f, k, b).float()
                (got ** 2 + got).sum().backward()
                ok = ok and quadrant.launches == before + 1
                fr, kr, br = leaves(fmap.float(), k32, bias)
                ref = quadrant.quadrant_process_plain(fr, kr, br)
                (ref ** 2 + ref).sum().backward()
                grads = {n: rel_l2(a.grad, r.grad) for n, a, r in (
                    ("fmap", f, fr), ("kernel", k, kr), ("bias", b, br))}
                row.update(grad_rel_l2_vs_f32_autograd=grads)
                ok = (ok and f.grad.dtype == dtype
                      and k.grad.dtype == b.grad.dtype == torch.float32)
                if dtype == torch.float32:
                    row.update(grad_tol=GRAD_TOL[dname])
                    ok = ok and max(grads.values()) <= GRAD_TOL[dname]
                else:
                    same = quadrant.quadrant_backward(
                        fmap, k32, bias, want_act.to(dtype),
                        2 * want_out.to(dtype).float() + 1)
                    grads = {n: rel_l2(a.grad, r) for n, a, r in zip(
                        ("fmap", "kernel", "bias"), (f, k, b), same)}
                    row.update(grad_rel_l2_vs_plain_act=grads,
                               grad_tol=QUADRANT_BF16_GRAD_TOL)
                    ok = ok and max(grads.values()) <= QUADRANT_BF16_GRAD_TOL
            row["ok"] = bool(ok)
            emit(row)
            rows.append(row)
            results[(tuple(shape), dname)] = row
    finish_checks(rows)
    return results


def check_head_train(fusion_head, rate=0.5, seed=1234):
    """The head's training form at rate 0.5: the dropped share of the
    positive units, kept units equal relu/(1-rate), logits equal
    h @ W2^T + b2, the mask a function of the seed alone and equal to the
    Philox reference, and, with that mask fed to the plain version as
    ``keep``, logits, h and all five gradients."""
    rows, results = [], {}
    for shape in HEAD_TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            tol = TOL[dname]
            x, w1, b1, w2, b2 = head_inputs(*shape, dtype)
            w1f, w2f = w1.float(), w2.float()   # f32 parameters, as rounded
            logits, h = fusion_head.fusion_head_with_h(
                x, w1f, b1, w2f, b2, rate=rate, seed=seed)
            logits_same, h_same = fusion_head.fusion_head_with_h(
                x, w1f, b1, w2f, b2, rate=rate,
                seed=torch.tensor([seed], dtype=torch.int64, device="cuda"))
            _, h_diff = fusion_head.fusion_head_with_h(
                x, w1f, b1, w2f, b2, rate=rate, seed=99)
            torch.cuda.synchronize()
            hf = h.float()
            pre = torch.addmm(b1, x.float(), w1f.t())
            relu, pos = pre.clamp(min=0), pre > 0
            frac = (((hf == 0) & pos).sum() / pos.sum()).item()
            kept = hf > 0
            kept_rel = ((hf[kept] - relu[kept] / (1 - rate)).abs().max()
                        / relu.max()).item()
            _, logit_rel = compare(logits, torch.addmm(b2, hf, w2f.t()))
            keep = (fusion_head.philox_bits(seed, shape[0], shape[2], "cuda")
                    >= fusion_head.dropout_threshold(rate))
            decided = pre.abs() > 1e-3   # the sign of pre is beyond doubt
            mask_ok = bool(((hf > 0) == (keep & pos))[decided].all())
            want_logits, want_h = fusion_head.fusion_head_plain(
                x.float(), w1f, b1, w2f, b2, rate, keep, with_h=True)
            err, rel = compare(logits, want_logits)
            _, h_rel = compare(h, want_h)
            row = {"phase": "check", "kernel": "fusion_head_train",
                   "shape": list(shape), "dtype": dname, "rate": rate,
                   "drop_fraction": frac, "kept_max_rel_err": kept_rel,
                   "logits_vs_h_rel_err": logit_rel,
                   "mask_equals_philox_reference": mask_ok,
                   "same_seed_same_mask": bool(torch.equal(h, h_same)),
                   "same_bits_twice": bool(torch.equal(logits, logits_same)),
                   "other_seed_other_mask": not torch.equal(h, h_diff),
                   "max_abs_err": err, "max_rel_err": rel,
                   "h_max_rel_err": h_rel, "tol": tol}
            ok = (0.4 < frac < 0.6 and kept_rel <= tol and logit_rel <= tol
                  and mask_ok and row["same_seed_same_mask"]
                  and row["same_bits_twice"]
                  and row["other_seed_other_mask"] and rel <= tol
                  and h_rel <= tol and h.dtype == dtype
                  and logits.dtype == torch.float32)
            if shape[0] <= 70:
                got = leaves(x, w1f, b1, w2f, b2)
                before = fusion_head.launches
                (fusion_head.fusion_head(*got, rate=rate, seed=seed)
                 ** 2).sum().backward()
                ok = ok and fusion_head.launches == before + 1
                ref = leaves(x.float(), w1f, b1, w2f, b2)
                (fusion_head.fusion_head_plain(*ref, rate, keep)
                 ** 2).sum().backward()
                grads = {n: rel_l2(a.grad, r.grad) for n, a, r in zip(
                    ("x", "w1", "b1", "w2", "b2"), got, ref)}
                row.update(grad_rel_l2=grads, grad_tol=GRAD_TOL[dname])
                ok = (ok and got[0].grad.dtype == dtype
                      and all(t.grad.dtype == torch.float32
                              for t in got[1:])
                      and max(grads.values()) <= GRAD_TOL[dname])
            row["ok"] = bool(ok)
            emit(row)
            rows.append(row)
            results[(tuple(shape), dname)] = row
    finish_checks(rows)
    return results


def close(got, want, tol):
    got, want = got.float(), want.float()
    return bool(torch.allclose(got, want, rtol=tol, atol=tol)), (
        got - want).abs().max().item()


def check_stem_bn(stem_bn):
    """The two stem-BN kernels and their combination against the plain
    versions, including channel counts other than 64 (with and without
    16-byte rows) and odd row counts."""
    rows = []
    for shape, dname in STEM_SHAPES:
        dtype, tol = getattr(torch, dname), STEM_TOL[dname]
        rng = np.random.default_rng(0)
        c = shape[-1]
        dev = lambda a: torch.from_numpy(  # noqa: E731
            a.astype(np.float32)).cuda()
        x = dev(rng.normal(size=shape) * 3 + 0.5).to(dtype)
        scale, bias = dev(rng.uniform(0.5, 2.0, c)), dev(rng.normal(size=c))
        sums, sumsq = stem_bn.channel_stats(x)
        ps, pss = stem_bn.channel_stats_plain(x)
        _, sums_rel = compare(sums, ps)
        _, sumsq_rel = compare(sumsq, pss)
        ok_a, a_err = close(stem_bn.affine_relu(x, scale, bias),
                            stem_bn.affine_relu_plain(x, scale, bias), tol)
        y, mean, var = stem_bn.fused_bn_relu_train(x, scale, bias)
        yr, mr, vr = stem_bn.reference_bn_relu_train(x, scale, bias)
        torch.cuda.synchronize()
        ok_y, y_err = close(y, yr, tol)
        ok_m, m_err = close(mean, mr, tol)
        ok_v, v_err = close(var, vr, tol)
        row = {"phase": "check", "kernel": "stem_bn", "shape": list(shape),
               "dtype": dname, "sums_max_rel_err": sums_rel,
               "sumsq_max_rel_err": sumsq_rel, "affine_max_abs_err": a_err,
               "fused_y_max_abs_err": y_err, "mean_max_abs_err": m_err,
               "var_max_abs_err": v_err, "tol": tol}
        row["ok"] = bool(
            ok_a and ok_y and ok_m and ok_v and y.dtype == dtype
            and y.shape == x.shape and max(sums_rel, sumsq_rel) <= 1e-5
            and sums.dtype == mean.dtype == var.dtype == torch.float32)
        emit(row)
        rows.append(row)
    finish_checks(rows)


# ---------------------------------------------------------------------------
# training path
# ---------------------------------------------------------------------------

def train_batch(cfg, n, seed=0):
    size = cfg.data.image_size
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.normal(size=(n, cfg.model.num_features)).astype(np.float32),
            rng.integers(0, cfg.model.num_classes, n).astype(np.int64))


def train_phase(quadrant, fusion_head, card):
    """``quadtree-fusion`` through create_train_state / make_train_step at
    full width: batch 256, bf16 over f32 parameters, dropout 0.5, one fixed
    batch (put on the card once, as a prefetching loader would), then an
    eval step with padded rows. → (launches, median step ms)."""
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.models.losses import cross_entropy
    from surya_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    cfg = get_preset("quadtree-fusion")
    assert cfg.model.compute_dtype == "bfloat16" and cfg.train.nan_guard
    model = get_model(cfg.model, image_size=cfg.data.image_size, seed=0)
    assert model.classifier.dropout == 0.5
    state, tx = create_train_state(model, cfg)
    step = make_train_step(model, tx, cfg)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in train_batch(cfg, TRAIN_BATCH))
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running_" in k}
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}

    torch.cuda.reset_peak_memory_stats()
    quadrant.launches = fusion_head.launches = 0
    losses, accs, ms = [], [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["accuracy"]))
    launches = {"quadrant": quadrant.launches,
                "fusion_head": fusion_head.launches}
    peak = torch.cuda.max_memory_allocated()

    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert launches == {"quadrant": TRAIN_STEPS,
                        "fusion_head": TRAIN_STEPS}, launches
    assert state.step == TRAIN_STEPS
    stats1 = model.state_dict()
    bn_moved = max((stats1[k] - v).abs().max().item()
                   for k, v in stats0.items())
    assert bn_moved > 0 and all(
        bool(torch.isfinite(stats1[k]).all()) for k in stats0)
    moved = [k for k, v in model.named_parameters()
             if not torch.equal(v, params0[k])]
    for key in ("trunk.conv1.weight", "quadrant_conv_kernel",
                "quadrant_conv_bias", "numerical_mlp.fc1.weight",
                "classifier.fc1.weight", "classifier.fc2.bias"):
        assert key in moved, f"{key} did not move in {TRAIN_STEPS} steps"
    assert all(v.dtype == torch.float32 for v in model.parameters())

    labels = batch[2].clone()
    labels[-3:] = -1                       # padding rows
    out = make_eval_step(model, cfg.model.num_classes)(
        (batch[0], batch[1], labels))
    count = int(out["count"])
    assert count == TRAIN_BATCH - 3 and int(out["confusion"].sum()) == count
    assert 0 <= int(out["correct"]) <= count
    assert np.isfinite(float(out["loss_sum"]))
    eval_launches = {"quadrant": quadrant.launches - TRAIN_STEPS,
                     "fusion_head": fusion_head.launches - TRAIN_STEPS}
    assert eval_launches == {"quadrant": 1, "fusion_head": 1}, eval_launches

    step_ms = statistics.median(ms[3:])
    emit({"phase": "train", "preset": "quadtree-fusion",
          "batch": TRAIN_BATCH, "dtype": "bfloat16", "dropout": 0.5,
          "steps": TRAIN_STEPS, "losses": losses, "accuracy": accs,
          "launches": launches, "eval_launches": eval_launches,
          "bn_running_stats_max_move": bn_moved,
          "params_moved": [len(moved), len(params0)],
          "eval": {"count": count, "correct": int(out["correct"]),
                   "loss_mean": float(out["loss_sum"]) / count},
          "step_ms": ms, "step_ms_median": step_ms,
          "img_per_s": TRAIN_BATCH / step_ms * 1e3,
          "peak_memory_bytes": peak, **card})

    # where a step's device time goes: the same step by hand, cut by events
    images, feats, labels = batch
    model.train()
    split = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        tx.zero_grad(set_to_none=True)
        ev[0].record()
        loss = cross_entropy(model(images, feats, state.generator), labels)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tx.step()
        ev[3].record()
        ev[3].synchronize()
        split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, opt = (statistics.median(col) for col in zip(*split))
    emit({"phase": "train_split", "batch": TRAIN_BATCH, "forward_ms": fwd,
          "backward_ms": bwd, "optimizer_ms": opt, **card})

    # which kernels the card spends a step in, and how long it idles: five
    # more steps under the profiler (which slows the host, so the idle share
    # is taken against the unprofiled step time above)
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    kernels = [(e.key, e.device_time_total / 1e3 / steps, e.count // steps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.key]
    busy = sum(ms for _, ms, _ in kernels)
    if not busy > 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    emit({"phase": "train_profile", "batch": TRAIN_BATCH, "steps": steps,
          "device_busy_ms_per_step": busy, "step_ms_median": step_ms,
          "device_idle_share": max(0.0, 1.0 - busy / step_ms),
          "kernel_kinds": len(kernels),
          "top_kernels": [{"name": n[:100], "ms_per_step": ms,
                           "launches_per_step": c} for n, ms, c in top],
          **card})
    return launches, step_ms


def train_f32_parity(card, batch_size=8):
    """One f32 train step at dropout 0 on the card against the same step
    with device="cpu": same initial weights, same batch. Compared: the
    loss, the BN running statistics, every gradient (read back from
    AdamW's first moment, which after one step is 0.1 * gradient) and the
    updated parameters. The CPU step is also run on one thread, to show
    how far this step's gradients move when only the order of the sums
    changes."""
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.train import create_train_state, make_train_step

    cfg = get_preset("quadtree-fusion")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32", dropout=0.0))
    base = get_model(cfg.model, image_size=cfg.data.image_size, seed=0)
    batch = train_batch(cfg, batch_size, seed=1)

    def one_step(dev):
        model = copy.deepcopy(base)
        state, tx = create_train_state(model, cfg, device=dev)
        state, metrics = make_train_step(model, tx, cfg)(state, batch)
        return (float(metrics["loss"]),
                {k: v.detach().cpu() for k, v in model.state_dict().items()},
                {k: tx.state[p]["exp_avg"].cpu() / 0.1
                 for k, p in model.named_parameters()})

    loss_g, sd_g, grad_g = one_step("cuda")
    loss_c, sd_c, grad_c = one_step("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, grad_c1 = one_step("cpu")
    finally:
        torch.set_num_threads(threads)
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    bn_err = max(((sd_g[k] - sd_c[k]).abs() / (1 + sd_c[k].abs())).max().item()
                 for k in sd_c if "running_" in k)
    grad_errs = {k: rel_l2(grad_g[k], grad_c[k]) for k in grad_c}
    grad_err = max(grad_errs.values())
    worst = sorted(grad_errs, key=grad_errs.get)[-3:]
    cpu_self = max(rel_l2(grad_c1[k], grad_c[k]) for k in grad_c)
    param_err = max((sd_g[k] - sd_c[k]).abs().max().item() for k in grad_c)
    # Gradients: at random weights on random images this step is badly
    # conditioned (ReLU and pool masks near ties, BN backward cancelling):
    # the CPU against itself on another number of threads moves some
    # gradients by a percent or more (cpu_self_grad_max_rel_l2), so the
    # card is held to 3e-2 relative L2, not to float accuracy.
    # Parameters: AdamW's first step moves each by lr * g / (|g| + eps), so
    # where a gradient is within that noise of 0 the two devices may step
    # in opposite directions: two steps' size.
    tol = {"loss_rel": 1e-5, "bn_rel": 1e-5, "grad_rel_l2": 3e-2,
           "param_abs": 2.01 * cfg.train.lr}
    emit({"phase": "train_f32_parity", "batch": batch_size, "steps": 1,
          "loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": loss_err,
          "bn_stats_max_rel_err": bn_err, "grad_max_rel_l2": grad_err,
          "grad_worst": {k: grad_errs[k] for k in worst},
          "cpu_self_grad_max_rel_l2": cpu_self, "cpu_threads": [threads, 1],
          "param_max_abs_err": param_err, "tol": tol, **card})
    assert loss_err <= tol["loss_rel"], loss_err
    assert bn_err <= tol["bn_rel"], bn_err
    assert grad_err <= tol["grad_rel_l2"], grad_err
    assert param_err <= tol["param_abs"], param_err


def stem_probe(stem_bn, card, eps=1e-5):
    """A train-mode stem forward, conv 7x7/2 (cuDNN) → BN(train) → ReLU, on
    (256, 224, 224, 3) bf16: the two stem-BN kernels against the plain
    version first, then timed against ``F.batch_norm`` + ReLU on the same
    map, kernel by kernel and as a whole stem."""
    from surya_tpu_torch.models.backbones.resnet import Conv

    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(
        TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda().to(bf)
    conv = Conv(3, 64, 7, 2, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            (rng.normal(size=(64, 3, 7, 7)) * 0.1).astype(np.float32)))
    conv = conv.cuda().to(bf).to(memory_format=torch.channels_last)
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(
        np.float32)).cuda()
    bias = torch.from_numpy(rng.normal(size=64).astype(np.float32)).cuda()
    x_nchw = images.permute(0, 3, 1, 2)    # channels_last view of NHWC

    def conv_map():                        # NHWC view of the conv's output
        return conv(x_nchw).permute(0, 2, 3, 1)

    def library_bn_relu(m):                # m: the NHWC map
        return F.relu_(F.batch_norm(m.permute(0, 3, 1, 2), None, None,
                                    scale, bias, True, 0.0, eps))

    with torch.no_grad():
        stem_bn.launches.update(channel_stats=0, affine_relu=0)
        y, mean, var = stem_bn.fused_bn_relu_train(conv_map(), scale, bias,
                                                   eps)
        torch.cuda.synchronize()
        launches = dict(stem_bn.launches)
        assert launches == {"channel_stats": 1, "affine_relu": 1}, launches

        cmap = conv_map()
        assert cmap.is_contiguous() and cmap.shape == (TRAIN_BATCH, 112, 112,
                                                       64)
        yr, mr, vr = stem_bn.reference_bn_relu_train(cmap, scale, bias, eps)
        y_err = (y.float() - yr.float()).abs().max().item()
        m_err = (mean - mr).abs().max().item()
        v_err = (var - vr).abs().max().item()
        lib = library_bn_relu(cmap).permute(0, 2, 3, 1)
        lib_err = (y.float() - lib.float()).abs().max().item()
        ok_y, _ = close(y, yr, STEM_TOL["bfloat16"])
        assert y_err < 0.05 and m_err < 1e-2 and ok_y, (y_err, m_err)
        assert bool(torch.isfinite(y.float()).all()) and v_err < 1e-2, v_err
        del yr, lib

        sums, sumsq = stem_bn.channel_stats(cmap)
        ps, pss = stem_bn.channel_stats_plain(cmap)
        stats_abs = max((sums - ps).abs().max().item(),
                        (sumsq - pss).abs().max().item())
        stats_rel = max(compare(sums, ps)[1], compare(sumsq, pss)[1])
        a = scale * torch.rsqrt(var + eps)
        b = bias - mean * a
        affine_abs = (stem_bn.affine_relu(cmap, a, b).float()
                      - stem_bn.affine_relu_plain(cmap, a, b).float()
                      ).abs().max().item()
        assert stats_rel <= 1e-5 and affine_abs <= 0.05, (stats_rel,
                                                           affine_abs)

        map_bytes = cmap.numel() * 2
        vec_bytes = 2 * 64 * 4
        rows = {
            "channel_stats": {
                "ms": time_ms(lambda: stem_bn.channel_stats(cmap)),
                "plain_ms": time_ms(
                    lambda: stem_bn.channel_stats_plain(cmap), reps=5),
                # one library call on the f32 cast of the map (the cast is
                # timed with it: it is what a caller without the kernel pays)
                "library_ms": time_ms(lambda: torch.var_mean(
                    cmap.float(), dim=(0, 1, 2), correction=0), reps=5),
                "bytes": map_bytes + vec_bytes, "max_abs_err": stats_abs,
                "max_rel_err": stats_rel},
            "affine_relu": {
                "ms": time_ms(lambda: stem_bn.affine_relu(cmap, a, b)),
                "plain_ms": time_ms(
                    lambda: stem_bn.affine_relu_plain(cmap, a, b), reps=5),
                "library_ms": time_ms(lambda: F.relu_(F.batch_norm(
                    cmap.permute(0, 3, 1, 2), mean, var, scale, bias, False,
                    0.0, eps))),
                "bytes": 2 * map_bytes + vec_bytes,
                "max_abs_err": affine_abs}}
        for row in rows.values():
            row["flops"] = 2 * cmap.numel()
            row["bound_ms"] = row["bytes"] / PEAK_BYTES_S * 1e3
            row["bound_by"] = "bytes"
            # timed apart, not in turns: the ratio of the two medians
            row["ratio_vs_library"] = row["ms"] / row["library_ms"]
        ab = {
            "bn_relu_kernels_ms": time_ms(
                lambda: stem_bn.fused_bn_relu_train(cmap, scale, bias, eps)),
            "bn_relu_library_ms": time_ms(lambda: library_bn_relu(cmap)),
            "bn_relu_plain_ms": time_ms(
                lambda: stem_bn.reference_bn_relu_train(cmap, scale, bias,
                                                        eps), reps=5),
            "stem_kernels_ms": time_ms(lambda: stem_bn.fused_bn_relu_train(
                conv_map(), scale, bias, eps)),
            "stem_library_ms": time_ms(lambda: library_bn_relu(conv_map())),
            "conv_ms": time_ms(conv_map),
            "bound_3_passes_ms": 3 * map_bytes / PEAK_BYTES_S * 1e3}
    emit({"phase": "stem_probe", "shape": list(cmap.shape),
          "dtype": "bfloat16", "launches": launches, "y_max_abs_err": y_err,
          "mean_max_abs_err": m_err, "var_max_abs_err": v_err,
          "y_vs_library_max_abs_err": lib_err, "map_bytes": map_bytes, **ab,
          **card})
    after = clocks()
    for name, row in rows.items():
        emit({"phase": "time", "kernel": name, "dtype": "bfloat16",
              "clocks_after": after, "shape": list(cmap.shape), **row,
              **card})
    return launches, rows


# ---------------------------------------------------------------------------
# the training pipeline: device_transform, and the CLI's loop
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
# the split sizes of the reference replay set
# (runs/reference_replay/dataset_regen.json: 768/256/256 images)
LOOP_SPLITS = {"train": 768, "valid": 256, "test": 256}
STAGING, AUGMENT_BATCH, AUGMENT_TOL = 256, 256, 1e-5
# about 20 ms of the card's clock: longer than device_transform's enqueue
# (3.5-4.3 ms on an H100), so the events time its device work alone
TRANSFORM_SPIN = 40 * HIDE_HOST_CYCLES
CLASS_NAMES = [f"pose{i}" for i in range(8)]


def synthetic_splits(counts, staging=STAGING):
    """Seeded class-separable images (the port's data/synthetic.py) at the
    staging size, quantised to uint8 as a decoded dataset holds them, and
    47 features with one missing value in every seventh sample."""
    from surya_tpu_torch.data import make_synthetic_spatial

    splits = {}
    for i, (name, n) in enumerate(counts.items()):
        imgs, feats, labels = make_synthetic_spatial(
            num_classes=len(CLASS_NAMES), per_class=n // len(CLASS_NAMES),
            image_size=staging, seed=i)
        feats[::7, 5] = np.nan
        splits[name] = (np.clip((imgs + 1.5) * 85.0 + 0.5, 0, 255).astype(
            np.uint8), feats, labels)
    return splits


def augment_stages(cfg, host):
    """Each stage of the train transform, and the eval transform, on the
    card against the CPU from the same input (the CPU's output of the
    stage before, moved to the card) with the same drawn parameters: the
    max |card - CPU| of each stage alone. And how far one ulp of a drawn
    crop height or of cos θ moves the normalised geometry output on the
    card (the sensitivity that makes the draw derive cos and sin, and
    ``augment.div`` divide, on the generator's device)."""
    from surya_tpu_torch.data import augment as A

    b, h, w, _ = host.shape
    params = A.draw_augment_params(
        torch.Generator().manual_seed(7), b, h, w, cfg.rrc_scale_min,
        cfg.hflip_prob, (cfg.jitter_brightness, cfg.jitter_contrast,
                         cfg.jitter_saturation, cfg.jitter_hue),
        cfg.rotation_deg, (cfg.blur_sigma_min, cfg.blur_sigma_max))
    no_hue = {**params, "hue": None}
    hue_only = {**params, "brightness": None, "contrast": None,
                "saturation": None}

    def on(p, device):
        return {k: None if v is None else v.to(device) for k, v in p.items()}

    stages = (
        ("div255", lambda x, d: A.div(x.float(), 255.0)),
        ("crop_flip_rotate", lambda x, d: A.crop_flip_rotate(
            x, on(params, d), cfg.image_size)),
        ("jitter", lambda x, d: A.color_jitter(x, on(no_hue, d))),
        ("hue", lambda x, d: A.color_jitter(x, on(hue_only, d))),
        ("gaussian_blur", lambda x, d: A.gaussian_blur(
            x, params["sigma"].to(d))),
        ("normalize", lambda x, d: A.normalize(x)))
    errs, x = {}, host
    for name, fn in stages:
        want = fn(x, "cpu")
        errs[name] = (fn(x.cuda(), "cuda").cpu() - want).abs().max().item()
        x = want
    unit = A.div(host.float(), 255.0)
    errs["eval_preprocess"] = (
        A.eval_preprocess(unit.cuda(), cfg.image_size).cpu()
        - A.eval_preprocess(unit, cfg.image_size)).abs().max().item()

    dev, p = unit.cuda(), on(params, "cuda")
    base = A.normalize(A.crop_flip_rotate(dev, p, cfg.image_size))
    ulp = {}
    for key in ("ch", "cos"):
        nudged = {**p, key: torch.nextafter(p[key],
                                            torch.full_like(p[key], 2e9))}
        ulp[key] = (A.normalize(A.crop_flip_rotate(dev, nudged,
                                                   cfg.image_size))
                    - base).abs().max().item()
    return errs, ulp


def augment_phase(card):
    """``device_transform`` of the preset (augmentation on, 224 px out) at
    batch 256 from the 256-px staging size, the train split (augment) and
    the eval split (resize), with per-class imputation: on the card against
    the same call on the CPU. Both calls take a CPU generator of one seed,
    so the parameters are drawn on the CPU once and moved to the batch:
    the same drawn parameters on both sides. The ops are plain PyTorch on
    both: this holds the card's results to the CPU's; it is not a kernel
    check. Each stage's own card-vs-CPU difference is reported beside it
    (:func:`augment_stages`). Timed with a CUDA generator as the loop
    draws, at batch 256 and at the loop's batch 16: by CUDA events with
    the host's enqueue included, as the loop sees it (``event_ms``), and
    behind a spin that hides it (``device_ms``); and the host's time to
    enqueue a call (``enqueue_ms``)."""
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.data.dataset import device_transform
    from surya_tpu_torch.data.imputation import (
        ClassFeatureStats,
        compute_class_stats,
    )

    cfg = get_preset("quadtree-fusion").data
    imgs, feats, labels = synthetic_splits({"train": AUGMENT_BATCH})["train"]
    stats = ClassFeatureStats(*compute_class_stats(feats, labels, 8),
                              CLASS_NAMES)
    host = tuple(torch.from_numpy(a) for a in (imgs, feats, labels))
    dev = tuple(t.cuda() for t in host)
    row = {"phase": "augment", "batch": AUGMENT_BATCH, "staging": STAGING,
           "out": cfg.image_size, "tol": AUGMENT_TOL}
    for split in ("train", "valid"):
        def gen(device="cpu"):
            return (torch.Generator(device=device).manual_seed(7)
                    if split == "train" else None)

        got = device_transform(cfg, stats, split, gen(), dev)
        t0 = time.perf_counter()
        want = device_transform(cfg, stats, split, gen(), host)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        assert got[0].shape == (AUGMENT_BATCH, cfg.image_size,
                                cfg.image_size, 3)
        err = max((g.cpu().float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
        row[split] = {"max_abs_err": err, "finite": finite, "cpu_ms": cpu_ms}
        for b in (AUGMENT_BATCH, 16):
            part = tuple(t[:b] for t in dev)

            def call():
                return device_transform(cfg, stats, split, gen("cuda"), part)

            row[split][f"event_ms_b{b}"] = time_ms(call, reps=10,
                                                   hide_host=False)
            row[split][f"device_ms_b{b}"] = time_ms(call, reps=10,
                                                    spin=TRANSFORM_SPIN)
            row[split][f"enqueue_ms_b{b}"] = enqueue_ms(call,
                                                        spin=TRANSFORM_SPIN)
        assert err <= AUGMENT_TOL and finite, (split, err)
    row["stage_max_abs_err"], row["one_ulp_moves"] = augment_stages(
        cfg, host[0])
    assert all(e <= AUGMENT_TOL for e in row["stage_max_abs_err"].values()), \
        row["stage_max_abs_err"]
    emit({**row, **card})
    return row


# ---------------------------------------------------------------------------
# children side by side: the phases whose children only check results run
# together at the end, each one's children while another's are awaited
# ---------------------------------------------------------------------------

SOLO = "solo"   # what a side-by-side phase yields before a stage it times
_CHILDREN: list = []   # every child started through start_child
POOL = concurrent.futures.ThreadPoolExecutor(max_workers=16)


def start_child(cmd: list, stderr=subprocess.PIPE):
    """``cmd`` from the repository with its output piped, started and
    recorded, so that :func:`stop_children` can end it."""
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=stderr, text=True)
    _CHILDREN.append(proc)
    return proc


def stop_children() -> None:
    """Kill every recorded child that is still running."""
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def until_done(*futures):
    """Yield while any of ``futures`` runs: a side-by-side phase waits so."""
    while not all(f.done() for f in futures):
        yield


def side_by_side(phases: dict) -> dict:
    """Run phases written as generators side by side. Each yields while
    its children (or a blocking call handed to :data:`POOL`) run, and the
    phases are resumed in turn, so their children overlap while the work
    a phase does in this process stays in this thread, one phase at a
    time. A phase that yields :data:`SOLO` is resumed only once every
    other phase has ended, and then alone, so what it times has the card
    and the host to itself. → {name: the value each phase returned}. If a
    phase raises, the others are closed and every child is killed."""
    done, live, solo = {}, dict(phases), []

    def step(name, gen):
        try:
            return "solo" if next(gen) == SOLO else "live"
        except StopIteration as stop:
            done[name] = stop.value
            return "done"

    try:
        while live:
            for name, gen in list(live.items()):
                state = step(name, gen)
                if state != "live":
                    del live[name]
                    if state == "solo":
                        solo.append((name, gen))
            time.sleep(0.1)
        for name, gen in solo:
            while step(name, gen) != "done":
                time.sleep(0.1)
    except BaseException:
        for gen in [*live.values(), *(g for _, g in solo)]:
            gen.close()
        stop_children()
        raise
    return done


def run_cli(args, timeout=900):
    """``python -m surya_tpu_torch ARGS`` from the repository, as a user
    runs it → (stdout, the JSON of its last line)."""
    proc = start_cli(args)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]} failed ({proc.returncode}):\n"
                             f"{stdout[-4000:]}\n{stderr[-4000:]}")
    return stdout, json.loads(stdout.strip().splitlines()[-1])


def epoch_records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train_loss" in r]


LOOP_SPANS = ("host_batch", "to_device", "device_transform", "train_step",
              "evaluate")


def trace_summary(trace_path):
    """From a torch.profiler Chrome trace: device time (the union of
    kernel, copy and set intervals) in ms, the kernels by total time, and
    the host time in each of the loop's annotated spans in ms."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    host = dict.fromkeys(LOOP_SPANS, 0.0)
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        elif e.get("cat") == "user_annotation" and e["name"] in host:
            host[e["name"]] += e["dur"] / 1e3
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (busy / 1e3, [{"name": n[:100], "ms": t / 1e3} for n, t in top],
            host)


def preempt(flags, run):
    """A ``train`` child sent SIGTERM at its first logged step → its loop
    state at the stop."""
    import signal

    proc = start_child([sys.executable, "-m", "surya_tpu_torch", "train",
                        *flags, "--out", run, "--train.epochs=2",
                        "--train.log_every=1"], stderr=subprocess.STDOUT)
    watchdog = threading.Timer(900, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step="):
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=900)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines.append(out)
    assert proc.returncode == 0, "".join(lines)[-4000:]
    stopped = json.loads("".join(lines).strip().splitlines()[-1])
    assert stopped["preempted"] is True, stopped
    with open(os.path.join(run, "ckpt", "loop_state.json")) as f:
        return json.load(f)


def loop_phase(card, augment):
    """The training pipeline as a user runs it. A pack of seeded synthetic
    images at the replay set's sizes (768/256/256, 256 px, about 250 MB)
    in a temporary directory; then, each as its own process:
    ``train --preset quadtree-fusion`` for 2 epochs as published (batch
    16, augmentation on, bf16, dropout 0.5) with the second epoch traced;
    ``eval`` on its best checkpoint; a third ``train`` sent SIGTERM at its
    first step and resumed with ``--resume``. Each child reports the
    kernel wrappers' launch counters of its own run, training and
    inference form apart. A generator: the first advance packs and runs
    the traced train alone; the eval and the preempted run, which only
    check results, run side by side (:func:`side_by_side`), and the
    resumed run, whose second epoch is the steady one timed, alone."""
    import shutil
    import tempfile

    from surya_tpu_torch.data.packed import pack_arrays

    root = tempfile.mkdtemp(prefix="surya_loop_")
    try:
        t0 = time.perf_counter()
        pack = os.path.join(root, "pack")
        pack_arrays(pack, synthetic_splits(LOOP_SPLITS), CLASS_NAMES)
        pack_s = time.perf_counter() - t0
        flags = ["--preset", "quadtree-fusion", f"--data.packed_dir={pack}"]
        run = os.path.join(root, "run")
        t0 = time.perf_counter()
        _, summary = run_cli(["train", *flags, "--out", run,
                              "--train.epochs=2", "--profile-dir",
                              os.path.join(root, "prof")])
        train_s = time.perf_counter() - t0
        epochs = epoch_records(run)
        steps = LOOP_SPLITS["train"] // 16
        evals = LOOP_SPLITS["valid"] // 16
        want = {"training": 2 * steps,
                "inference": 2 * evals + LOOP_SPLITS["test"] // 16}
        launches = summary["kernel_launches"]
        assert launches == {"quadrant": want, "fusion_head": want,
                            "channel_stats": 0, "affine_relu": 0}, launches
        assert [r["epoch"] for r in epochs] == [0, 1]
        assert [r["steps"] for r in epochs] == [steps, steps]
        assert epochs[1]["train_loss"] < epochs[0]["train_loss"], epochs
        assert all(np.isfinite(r["val_loss"]) for r in epochs)
        busy_ms, top, host_ms = trace_summary(
            os.path.join(root, "prof", "trace_epoch1.json"))
        assert busy_ms > 0, "the profiler recorded no device time"
        yield   # the traced run is done; the rest only checks results

        best = os.path.join(run, "ckpt", f"{summary['best_epoch']}.pt")
        evaluated = POOL.submit(run_cli, ["eval", best, *flags])
        # SIGTERM at the first step, then --resume
        run3 = os.path.join(root, "run3")
        preempted = POOL.submit(preempt, flags, run3)
        yield from until_done(evaluated, preempted)
        _, ev = evaluated.result()
        tests = {"training": 0, "inference": LOOP_SPLITS["test"] // 16}
        assert ev["kernel_launches"] == {
            "quadrant": tests, "fusion_head": tests,
            "channel_stats": 0, "affine_relu": 0}, ev["kernel_launches"]
        assert ev["count"] == summary["test"]["count"] == LOOP_SPLITS["test"]

        ls = preempted.result()
        assert ls["preempt"] and ls["epoch"] == 0 and ls["batch_idx"] > 0
        yield SOLO
        _, resumed = run_cli(["train", *flags, "--out", run3,
                              "--train.epochs=2", "--resume"])
        resumed_epochs = epoch_records(run3)
        assert resumed["preempted"] is False
        assert [r["epoch"] for r in resumed_epochs] == [0, 1]
        assert resumed_epochs[0]["steps"] == steps - ls["batch_idx"]
        # the resumed run's second epoch: after warm-up, not traced
        steady = resumed_epochs[1]
        assert steady["steps"] == steps

        e1 = epochs[1]
        row = {"phase": "loop", "preset": "quadtree-fusion", "batch": 16,
               "images": LOOP_SPLITS, "staging": STAGING,
               "pack_s": pack_s, "train_cli_s": train_s,
               "epoch_time_s": [r["epoch_time_s"] for r in epochs],
               "train_time_s": [r["train_time_s"] for r in epochs],
               "images_per_sec": [r["images_per_sec"] for r in epochs],
               "train_loss": [r["train_loss"] for r in epochs],
               "val_loss": [r["val_loss"] for r in epochs],
               "val_accuracy": [r["val_accuracy"] for r in epochs],
               "input_wait_share": [r["input_wait_s"] / r["train_time_s"]
                                    for r in epochs],
               "epoch1_profiled": True,
               "epoch1_device_busy_ms": busy_ms,
               "epoch1_device_idle_share": 1 - busy_ms / (
                   e1["epoch_time_s"] * 1e3),
               "epoch1_top_kernels": top,
               "epoch1_host_ms_per_step": {k: v / steps
                                           for k, v in host_ms.items()},
               "steady": {
                   "epoch_time_s": steady["epoch_time_s"],
                   "train_time_s": steady["train_time_s"],
                   "train_ms_per_step": steady["train_time_s"] * 1e3 / steps,
                   "images_per_sec": steady["images_per_sec"],
                   "input_wait_share": (steady["input_wait_s"]
                                        / steady["train_time_s"]),
                   "device_transform_enqueue_share": (
                       augment["train"]["enqueue_ms_b16"]
                       / (steady["train_time_s"] * 1e3 / steps))},
               "device_transform_ms": {
                   s: {k: v for k, v in augment[s].items() if "_ms_" in k}
                   for s in ("train", "valid")},
               "launches": launches, "eval_launches": ev["kernel_launches"],
               "test": summary["test"],
               "eval": {k: ev[k] for k in ("loss", "accuracy", "count")},
               "preempted_at": {"epoch": ls["epoch"],
                                "batch_idx": ls["batch_idx"]},
               "resumed_epochs": [r["epoch"] for r in resumed_epochs],
               "resumed_launches": resumed["kernel_launches"], **card}
        emit(row)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the other spatial families: models, serving, train steps, Grad-CAM, CLI
# ---------------------------------------------------------------------------

# (label, preset, overrides): the eleven spatial configurations at 224 px
SPATIAL_MODELS = [
    ("experiment-fusion", "experiment-fusion", {}),
    ("experiment-image-only", "experiment-image-only", {}),
    ("experiment-numerical-only", "experiment-numerical-only", {}),
    ("comparative-resnet18", "comparative-resnet18", {}),
    ("comparative-resnet50", "comparative-resnet50", {}),
    ("comparative-vgg16", "comparative-vgg16", {}),
    ("comparative-mobilenet-v2", "comparative-mobilenet-v2", {}),
    ("comparative-densenet121", "comparative-densenet121", {}),
    ("hierarchical_quadtree", "quadtree-fusion",
     {"model.name": "hierarchical_quadtree"}),
    ("attention_hierarchical", "quadtree-fusion",
     {"model.name": "attention_hierarchical"}),
    ("standard_resnet", "quadtree-fusion", {"model.name": "standard_resnet"}),
]
SPATIAL_STEPS, SPATIAL_SERVE = 5, 640
# Grad-CAM card vs CPU: (label of a model above, targets)
CAM_TARGETS = [("experiment-fusion", ("layer3", "layer4")),
               ("comparative-resnet18", ("layer4",)),
               ("hierarchical_quadtree", ("layer2", "level1", "level2")),
               ("attention_hierarchical", ("layer2", "level1", "level2"))]
CAM_BATCH, CAM_TOL = 4, 2e-4
# the CLI runs: a small pack (the loop phase runs the replay set's sizes)
SPATIAL_SPLITS = {"train": 128, "valid": 64, "test": 64}
SPATIAL_CLI = [["--preset", "comparative-mobilenet-v2"],
               ["--preset", "quadtree-fusion",
                "--model.name=hierarchical_quadtree"]]


def spatial_config(preset, overrides):
    from surya_tpu_torch.core.config import get_preset

    return get_preset(preset).override(overrides)


def reset_launches(*modules):
    for m in modules:
        m.launches = m.training_launches = 0


def read_launches(quadrant, fusion_head):
    return {f"{name}{form}": (m.training_launches if form
                              else m.launches - m.training_launches)
            for name, m in (("quadrant", quadrant),
                            ("fusion_head", fusion_head))
            for form in ("", "_train")}


def spatial_model(label, cfg, images, feats, quadrant, fusion_head, card):
    """One configuration at 224 px, random weights from seed 0: f32 logits
    on the card against the CPU (B = 2), bf16 ``Predictor.predict`` images/s
    at batch 64, 5 bf16 train steps at the preset's batch (dropout 0.5),
    and the two kernels' launches in each, counted exactly."""
    from surya_tpu_torch.infer.serve import Predictor
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.train import create_train_state, make_train_step

    size = cfg.data.image_size
    f32 = dataclasses.replace(cfg.model, compute_dtype="float32")
    base = get_model(f32, image_size=size, seed=0)
    state = base.state_dict()
    head = [base.classifier.fc1.in_features, base.classifier.fc1.out_features]
    has_quadrant = hasattr(base, "quadrant_conv_kernel")
    forms = {"quadrant": int(has_quadrant), "fusion_head": 1}

    x = torch.from_numpy(images[:2]).float() / 255.0
    f = torch.from_numpy(feats[:2])
    with torch.no_grad():
        want = base(x, f)
        gpu = copy.deepcopy(base).cuda()
        if hasattr(gpu, "trunk"):
            gpu.trunk.to(memory_format=torch.channels_last)
        reset_launches(quadrant, fusion_head)
        got = gpu(x.cuda(), f.cuda())
        torch.cuda.synchronize()
    f32_launches = read_launches(quadrant, fusion_head)
    del gpu
    err, rel = compare(got.cpu(), want)
    assert rel <= TOL["float32"] and bool(torch.isfinite(got).all()), (
        label, err, rel)
    assert f32_launches == {"quadrant": forms["quadrant"], "quadrant_train": 0,
                            "fusion_head": 1, "fusion_head_train": 0}, (
        label, f32_launches)

    predictor = Predictor(cfg.model, state, batch_size=64,
                          param_dtype=torch.bfloat16, input_dtype="uint8")
    predictor.predict(images[:64], feats[:64])             # warm-up
    reset_launches(quadrant, fusion_head)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        preds, probs = predictor.predict(images, feats)
        rates.append(len(images) / (time.perf_counter() - t0))
    chunks = 3 * len(images) // 64
    serve_launches = read_launches(quadrant, fusion_head)
    assert preds.shape == (len(images),) and np.isfinite(probs).all()
    assert serve_launches == {
        "quadrant": chunks * forms["quadrant"], "quadrant_train": 0,
        "fusion_head": chunks, "fusion_head_train": 0}, (
        label, serve_launches)
    del predictor

    model = get_model(cfg.model, image_size=size, seed=0)
    model.load_state_dict(state, strict=True)
    assert model.classifier.dropout == 0.5
    train_state, tx = create_train_state(model, cfg)
    step = make_train_step(model, tx, cfg)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in train_batch(cfg, cfg.data.batch_size))
    reset_launches(quadrant, fusion_head)
    losses, ms = [], []
    for _ in range(SPATIAL_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        train_state, metrics = step(train_state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    train_launches = read_launches(quadrant, fusion_head)
    assert np.isfinite(losses).all(), (label, losses)
    assert train_launches == {
        "quadrant": 0, "quadrant_train": SPATIAL_STEPS * forms["quadrant"],
        "fusion_head": 0, "fusion_head_train": SPATIAL_STEPS}, (
        label, train_launches)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    row = {"phase": "spatial", "model": label, "family": cfg.model.name,
           "backbone": cfg.model.backbone, "mode": cfg.model.mode,
           "freeze_backbone": cfg.model.freeze_backbone, "image_size": size,
           "head_d_h": head, "frozen_params": len(frozen),
           "f32_card_vs_cpu": {"batch": 2, "max_abs_err": err,
                               "max_rel_err": rel, "tol": TOL["float32"]},
           "serve": {"batch_size": 64, "images": len(images), "runs": 3,
                     "img_per_s": rates,
                     "img_per_s_median": statistics.median(rates)},
           "train": {"batch": cfg.data.batch_size, "dtype": "bfloat16",
                     "dropout": 0.5, "losses": losses, "step_ms": ms,
                     "step_ms_median": statistics.median(ms)},
           "launches": {"f32_forward": f32_launches, "serve": serve_launches,
                        "train": train_launches}, **card}
    emit(row)
    del model, train_state, tx, step
    torch.cuda.empty_cache()
    return state, row


def spatial_cam(states, quadrant, fusion_head, card):
    """Grad-CAM at f32, B = 4, on the card against the CPU for every target
    of the quadtree, the comparative resnet18 and both hierarchical
    families. Two comparisons, heatmaps to 2e-4 and preds equal in each:

    - from the same target activation: the CPU runs the tail (the rest of
      the model and the backward) from the card's activation and
      constants, so what is compared is the card's tail — kernels in their
      training forms, autograd, the CAM and the quadrant merges;
    - end to end, from the same images: asserted where the tail's backward
      crosses no trunk stage. Where it does (quadtree ``layer3`` →
      layer4, hierarchical ``layer2`` → layer3 and layer4) it is reported:
      there the trunk's forward on the card and the CPU differs by ~1e-6
      relative, which moves the ReLU masks of the few pre-activations that
      close to 0, and the gradient with them (measured: layer4's backward
      to the layer3 map 1% apart in relative L2, the layer3 CAM 6.5e-4)."""
    from surya_tpu_torch.interpret.gradcam import (
        cam_from,
        cam_model,
        cam_split,
        grad_cam_of,
    )

    rng = np.random.default_rng(2)
    rows, totals = [], dict.fromkeys(
        ("quadrant", "quadrant_train", "fusion_head", "fusion_head_train"), 0)
    for label, targets in CAM_TARGETS:
        cfg = spatial_config(*{lb: (p, o) for lb, p, o in SPATIAL_MODELS}[
            label])
        size = cfg.data.image_size
        images = rng.normal(size=(CAM_BATCH, size, size, 3)).astype(
            np.float32)
        feats = rng.normal(size=(CAM_BATCH, cfg.model.num_features)).astype(
            np.float32)
        models = {dev: cam_model(cfg.model, states[label], size, dev)
                  for dev in ("cuda", "cpu")}
        for target in targets:
            reset_launches(quadrant, fusion_head)
            cam_g, pred_g, logit_g = grad_cam_of(
                cfg.model, models["cuda"], images, feats, target)
            torch.cuda.synchronize()
            launches = read_launches(quadrant, fusion_head)
            cam_c, pred_c, logit_c = grad_cam_of(
                cfg.model, models["cpu"], images, feats, target)
            act, consts, merges = cam_split(
                cfg.model, models["cuda"], torch.from_numpy(images).cuda(),
                target)
            cam_s, pred_s, _ = cam_from(
                cfg.model, models["cpu"], act.cpu(),
                {k: v.cpu() for k, v in consts.items()}, merges,
                torch.from_numpy(feats), target)
            through_trunk = target in ("layer3", "layer2")
            row = {"model": label, "target": target,
                   "shape": list(cam_g.shape), "tol": CAM_TOL,
                   "same_activation": {
                       "max_abs_err": (cam_g.cpu() - cam_s).abs().max()
                       .item(),
                       "preds_equal": bool(torch.equal(pred_g.cpu(),
                                                       pred_s))},
                   "end_to_end": {
                       "max_abs_err": (cam_g.cpu() - cam_c).abs().max()
                       .item(),
                       "preds_equal": bool(torch.equal(pred_g.cpu(),
                                                       pred_c)),
                       "logits_max_rel_err": compare(logit_g.cpu(),
                                                     logit_c)[1],
                       "asserted": not through_trunk},
                   "launches": launches}
            rows.append(row)
            for k, v in launches.items():
                totals[k] += v
            same, e2e = row["same_activation"], row["end_to_end"]
            assert same["max_abs_err"] <= CAM_TOL and same["preds_equal"], row
            assert e2e["preds_equal"], row
            assert through_trunk or e2e["max_abs_err"] <= CAM_TOL, row
            # the tail runs the head once, in its training form
            assert launches["fusion_head_train"] == 1, row
        del models
    emit({"phase": "spatial_cam", "batch": CAM_BATCH, "dtype": "float32",
          "cams": rows, "launches": totals, **card})
    return totals


def spatial_cli(card):
    """``python -m surya_tpu_torch train`` for one epoch on a small seeded
    pack for ``comparative-mobilenet-v2`` and for ``quadtree-fusion
    --model.name=hierarchical_quadtree``, then ``eval`` on each best
    checkpoint: finite losses, eval = the loop's test loss, and each
    child's head launches counted exactly. The two trains run at once,
    then the two evals. A side-by-side phase (:func:`side_by_side`)."""
    import shutil
    import tempfile

    from surya_tpu_torch.data.packed import pack_arrays

    root = tempfile.mkdtemp(prefix="surya_spatial_")
    rows, totals = [], {"fusion_head": 0, "fusion_head_train": 0}
    try:
        pack = os.path.join(root, "pack")
        pack_arrays(pack, synthetic_splits(SPATIAL_SPLITS), CLASS_NAMES)
        steps = SPATIAL_SPLITS["train"] // 16
        tests = SPATIAL_SPLITS["test"] // 16
        flags = [[*preset, f"--data.packed_dir={pack}"]
                 for preset in SPATIAL_CLI]
        runs = [os.path.join(root, f"run{i}") for i in range(len(flags))]
        # the two trains run at once, then the two evals
        trains = POOL.submit(finish, {i: start_cli(
            ["train", *f, "--out", run, "--train.epochs=1"])
            for i, (f, run) in enumerate(zip(flags, runs))})
        yield from until_done(trains)
        trains = trains.result()
        summaries = [last_json(trains[i][0]) for i in range(len(flags))]
        evals = POOL.submit(finish, {i: start_cli(
            ["eval", os.path.join(run, "ckpt",
                                  f"{summary['best_epoch']}.pt"), *f])
            for i, (f, run, summary) in enumerate(zip(flags, runs,
                                                      summaries))})
        yield from until_done(evals)
        evals = evals.result()
        for i, preset in enumerate(SPATIAL_CLI):
            summary, ev = summaries[i], last_json(evals[i][0])
            epochs = epoch_records(runs[i])
            want = {"training": steps,
                    "inference": SPATIAL_SPLITS["valid"] // 16 + tests}
            launches = summary["kernel_launches"]
            assert launches["fusion_head"] == want, (preset, launches)
            assert launches["quadrant"] == {"training": 0, "inference": 0}
            assert [r["steps"] for r in epochs] == [steps]
            assert np.isfinite(epochs[0]["train_loss"]), epochs
            assert np.isfinite(summary["test"]["loss"]), summary
            assert ev["kernel_launches"]["fusion_head"] == {
                "training": 0, "inference": tests}, ev["kernel_launches"]
            assert ev["count"] == summary["test"]["count"]
            assert abs(ev["loss"] - summary["test"]["loss"]) <= 1e-5 * max(
                1.0, abs(summary["test"]["loss"])), (ev, summary["test"])
            totals["fusion_head"] += want["inference"] + tests
            totals["fusion_head_train"] += steps
            rows.append({"args": preset, "train_cli_s": trains[i][1],
                         "train_loss": epochs[0]["train_loss"],
                         "val_loss": epochs[0]["val_loss"],
                         "test_loss": summary["test"]["loss"],
                         "eval_loss": ev["loss"],
                         "images_per_sec": epochs[0]["images_per_sec"],
                         "launches": launches,
                         "eval_launches": ev["kernel_launches"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "spatial_cli", "images": SPATIAL_SPLITS, "runs": rows,
          **card})
    return totals


def spatial_phase(quadrant, fusion_head, card):
    """Every spatial configuration (:data:`SPATIAL_MODELS`), Grad-CAM card
    vs CPU, and the head kernel timed at the two new edge widths (VGG16's
    D = 25,344 and numerical_only's D = 128 → H = 1024) in both forms;
    the CLI on two of them is :func:`spatial_cli`, run side by side. →
    (launches of this process per kernel form, timed rows)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (SPATIAL_SERVE, 224, 224, 3),
                          dtype=np.uint8)
    feats = rng.normal(size=(SPATIAL_SERVE, 47)).astype(np.float32)
    totals = dict.fromkeys(
        ("quadrant", "quadrant_train", "fusion_head", "fusion_head_train"), 0)
    states, summary = {}, []
    for label, preset, overrides in SPATIAL_MODELS:
        cfg = spatial_config(preset, overrides)
        states[label], row = spatial_model(label, cfg, images, feats,
                                           quadrant, fusion_head, card)
        for part in row["launches"].values():
            for k, v in part.items():
                totals[k] += v
        summary.append({"model": label, "head_d_h": row["head_d_h"],
                        "f32_max_rel_err": row["f32_card_vs_cpu"][
                            "max_rel_err"],
                        "serve_img_per_s": row["serve"]["img_per_s_median"],
                        "train_step_ms": row["train"]["step_ms_median"]})
    del images, feats
    for k, v in spatial_cam(states, quadrant, fusion_head, card).items():
        totals[k] += v

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timed = {}
    for shape in ((16, 25344, 512, 8), (16, 128, 1024, 8)):
        for train in (False, True):
            name = "fusion_head_train" if train else "fusion_head"
            row = head_timed(fusion_head, shape, flush, train)
            timed[(name, shape)] = row
            emit({"phase": "time", "kernel": name, "dtype": "bfloat16",
                  "clocks_after": clocks(), "shape": list(shape), **row,
                  **card})
    emit({"phase": "spatial_summary", "models": summary, "launches": totals,
          "seconds": time.perf_counter() - t0, **card})
    return totals, timed


# ---------------------------------------------------------------------------
# the temporal families: models, serving, train steps, CLI, HTTP
# ---------------------------------------------------------------------------

# (label, preset, overrides): the temporal configurations at 224 px
TEMPORAL_CONFIGS = [
    ("cnn-lstm", "cnn-lstm", {}),
    ("ji-3dcnn", "ji-3dcnn", {}),
    ("quadtree-3d", "quadtree-3d", {}),
    ("quadtree-3d-image-only", "quadtree-3d", {"model.mode": "image_only"}),
    ("resnet3d-video", "resnet3d-video", {}),
    ("hybrid-quadtree-3d", "hybrid-quadtree-3d", {}),
    ("hybrid-quadtree-3d-image-only", "hybrid-quadtree-3d",
     {"model.mode": "image_only"}),
    ("fact", "fact", {}),
    ("fact-bs16", "fact-bs16", {}),
]
# each family's preset dropout, and the families whose trunk trains layer4
# only (its BN on batch statistics) under freeze_backbone
TEMPORAL_DROPOUT = {"cnn_lstm": 0.5, "ji_3dcnn": 0.5, "quadtree_3d": 0.6,
                    "resnet3d_video": 0.5, "hybrid_quadtree_3d": 0.6,
                    "fact": 0.1}
PARTIAL_UNFREEZE = ("resnet3d_video", "hybrid_quadtree_3d")
TEMPORAL_STEPS, TEMPORAL_SERVE_CHUNKS = 5, 4
# the CLI's temporal replay windows per class (make_replay_disk.py's
# layout and seeds 2000-2002, 224 px, T = 5), and the packs trained from
TEMPORAL_WINDOWS = {"train": 8, "valid": 4, "test": 4}
TEMPORAL_CLI = [("quadtree-3d", 5), ("cnn-lstm", 4), ("hybrid-quadtree-3d", 5),
                ("fact", 4)]
REPLAY_CLASSES = [f"pose_{i}" for i in range(8)]


def clip_batch(cfg, n, seed=0, raw=True):
    """``n`` clips at the preset's T and size with their feature sequences:
    uint8 pixels (``raw``) or normalised-scale f32 values, and labels."""
    t, size = cfg.data.seq_len, cfg.data.image_size
    rng = np.random.default_rng(seed)
    clips = (rng.integers(0, 256, (n, t, size, size, 3), dtype=np.uint8)
             if raw else rng.normal(size=(n, t, size, size, 3)).astype(
                 np.float32))
    return (clips,
            rng.normal(size=(n, t, cfg.model.num_features)).astype(
                np.float32),
            rng.integers(0, cfg.model.num_classes, n).astype(np.int64))


def temporal_model(label, cfg, quadrant, fusion_head, card):
    """One temporal configuration at 224 px, its own T, random weights from
    seed 0: f32 logits on the card against the CPU (B = 2), bf16
    ``Predictor.predict`` clips/s at the preset batch (uint8 wire, 3 runs of
    4 chunks), 5 bf16 train steps at the preset batch with the preset's
    dropout, and the head's launches in each, counted exactly (one a
    forward; none on FACT). The frozen trunks through the steps: the
    ``cnn-lstm`` trunk's BN statistics unchanged; the r3d models'
    stem..layer3 statistics unchanged and layer4's moved; FACT's ViT
    parameters unchanged."""
    from surya_tpu_torch.infer.serve import Predictor
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.models.backbones import trunk_channels_last
    from surya_tpu_torch.train import create_train_state, make_train_step

    bs, family = cfg.data.batch_size, cfg.model.name
    size = cfg.data.image_size
    heads = int(family != "fact")     # FACT's head is LN + Dense
    f32 = dataclasses.replace(cfg.model, compute_dtype="float32")
    base = get_model(f32, image_size=size, seed=0)
    state = base.state_dict()
    head = ([base.classifier.fc1.in_features,
             base.classifier.fc1.out_features] if heads else None)
    clips, feats, _ = clip_batch(cfg, TEMPORAL_SERVE_CHUNKS * bs)

    x = torch.from_numpy(clips[:2]).float() / 255.0
    f = torch.from_numpy(feats[:2])
    with torch.no_grad():
        t0 = time.perf_counter()
        want = base(x, f)
        cpu_s = time.perf_counter() - t0
        gpu = trunk_channels_last(copy.deepcopy(base).cuda())
        reset_launches(quadrant, fusion_head)
        got = gpu(x.cuda(), f.cuda())
        torch.cuda.synchronize()
    f32_launches = read_launches(quadrant, fusion_head)
    del gpu, base
    err, rel = compare(got.cpu(), want)
    assert rel <= TOL["float32"] and bool(torch.isfinite(got).all()), (
        label, err, rel)
    assert f32_launches == {"quadrant": 0, "quadrant_train": 0,
                            "fusion_head": heads, "fusion_head_train": 0}, (
        label, f32_launches)

    predictor = Predictor(cfg.model, state, batch_size=bs, image_size=size,
                          param_dtype=torch.bfloat16, input_dtype="uint8")
    predictor.predict(clips[:bs], feats[:bs])              # warm-up
    reset_launches(quadrant, fusion_head)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        preds, probs = predictor.predict(clips, feats)
        rates.append(len(clips) / (time.perf_counter() - t0))
    serve_launches = read_launches(quadrant, fusion_head)
    assert preds.shape == (len(clips),) and np.isfinite(probs).all()
    assert serve_launches == {
        "quadrant": 0, "quadrant_train": 0,
        "fusion_head": 3 * TEMPORAL_SERVE_CHUNKS * heads,
        "fusion_head_train": 0}, (label, serve_launches)

    model = get_model(cfg.model, image_size=size, seed=0)
    model.load_state_dict(state, strict=True)
    dropout = (model.fusion0 if family == "fact" else
               model.classifier).dropout
    assert dropout == TEMPORAL_DROPOUT[family], (label, dropout)
    train_state, tx = create_train_state(model, cfg)
    step = make_train_step(model, tx, cfg)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in clip_batch(cfg, bs, seed=1, raw=False))
    partial = family in PARTIAL_UNFREEZE
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("trunk.") and "running_" in k}
    vit = {k: p.detach().clone() for k, p in model.named_parameters()
           if k.startswith("vit_backbone.")}
    assert not any(p.requires_grad for k, p in model.named_parameters()
                   if k in vit)
    reset_launches(quadrant, fusion_head)
    losses, ms = [], []
    for _ in range(TEMPORAL_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        train_state, metrics = step(train_state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    train_launches = read_launches(quadrant, fusion_head)
    assert np.isfinite(losses).all(), (label, losses)
    assert train_launches == {
        "quadrant": 0, "quadrant_train": 0, "fusion_head": 0,
        "fusion_head_train": TEMPORAL_STEPS * heads}, (label, train_launches)
    after = model.state_dict()
    moved = sorted(k for k in stats if partial and "layer4" in k)
    kept = [k for k in stats if k not in moved]
    assert all(torch.equal(stats[k], after[k]) for k in kept), label
    assert all(not torch.equal(stats[k], after[k]) for k in moved), label
    assert all(torch.equal(v, after[k]) for k, v in vit.items()), label
    assert (len(moved) == 10) == partial, (label, len(moved))  # 5 BNs
    row = {"phase": "temporal", "model": label, "family": family,
           "mode": cfg.model.mode, "seq_len": cfg.data.seq_len,
           "image_size": cfg.data.image_size, "head_d_h": head,
           "freeze_backbone": cfg.model.freeze_backbone,
           "frozen_trunk_bn_stats": len(kept),
           "moved_layer4_bn_stats": len(moved),
           "frozen_vit_params": len(vit),
           "f32_card_vs_cpu": {"batch": 2, "max_abs_err": err,
                               "max_rel_err": rel, "tol": TOL["float32"],
                               "cpu_forward_s": cpu_s},
           "serve": {"batch_size": bs, "clips": len(clips), "runs": 3,
                     "clips_per_s": rates,
                     "clips_per_s_median": statistics.median(rates)},
           "train": {"batch": bs, "dtype": "bfloat16", "dropout": dropout,
                     "losses": losses, "step_ms": ms,
                     "step_ms_median": statistics.median(ms)},
           "launches": {"f32_forward": f32_launches, "serve": serve_launches,
                        "train": train_launches}, **card}
    emit(row)
    del model, train_state, tx, step, batch
    torch.cuda.empty_cache()
    return predictor, clips, feats, row


def temporal_http(predictor, clips, feats, quadrant, fusion_head, card):
    """One temporal ``.npz`` request (3 clips) to ``/predict`` of a
    ``PredictionServer`` around ``predictor``: the reply's predictions are
    those of ``predictor.predict`` on the same clips, one head launch."""
    from surya_tpu_torch.infer.http_server import PredictionServer

    server = PredictionServer(predictor, REPLAY_CLASSES)
    httpd = server.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        health = http_json(url + "/healthz")
        reset_launches(quadrant, fusion_head)
        t0 = time.perf_counter()
        reply = http_json(url + "/predict", npz_bytes(clips[:3], feats[:3]))
        latency = time.perf_counter() - t0
        launches = read_launches(quadrant, fusion_head)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    preds, probs = predictor.predict(clips[:3], feats[:3])
    assert health["status"] == "ok" and reply["n"] == 3, reply
    assert reply["predictions"] == preds.tolist(), (reply, preds)
    assert reply["labels"] == [REPLAY_CLASSES[i] for i in preds]
    err = float(np.abs(np.asarray(reply["probabilities"]) - probs).max())
    assert err <= 1e-5, err
    assert launches == {"quadrant": 0, "quadrant_train": 0,
                        "fusion_head": 1, "fusion_head_train": 0}, launches
    row = {"phase": "temporal_http", "model": health["model"],
           "clips": 3, "request_s": latency, "max_abs_prob_err": err,
           "launches": launches, **card}
    emit(row)
    return launches


def temporal_cli(card):
    """The temporal replay set (``make_replay_temporal``, 8/4/4 windows
    per class, 224 px, T = 5) written as ``.npz`` windows in
    ``scripts/make_replay_disk.py``'s layout; ``pack --sequences`` at
    T = 5 and T = 4; ``train`` for 2 epochs from those packs with each
    preset of :data:`TEMPORAL_CLI` (``quadtree-3d``, ``cnn-lstm``,
    ``hybrid-quadtree-3d``, ``fact``), then ``eval`` of each best
    checkpoint: finite losses, eval = the loop's test loss, and each
    child's head launches counted exactly (none for FACT). The children of
    each step run at once (their times are the step's wall time). A
    side-by-side phase (:func:`side_by_side`)."""
    import shutil
    import tempfile

    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.data.replay import make_replay_temporal
    from surya_tpu_torch.data.sequences import write_windows

    root = tempfile.mkdtemp(prefix="surya_temporal_")
    rows = []
    totals = dict.fromkeys(("quadrant", "quadrant_train", "fusion_head",
                            "fusion_head_train", "channel_stats",
                            "affine_relu"), 0)
    try:
        windows = os.path.join(root, "windows")
        t0 = time.perf_counter()
        write_windows(windows, {
            split: make_replay_temporal(per_class=n, image_size=224,
                                        seq_len=5, seed=2000 + i)
            for i, (split, n) in enumerate(TEMPORAL_WINDOWS.items())},
            REPLAY_CLASSES)
        write_s = time.perf_counter() - t0
        count = {s: 8 * n for s, n in TEMPORAL_WINDOWS.items()}
        # the children run at once (each mostly host start-up): the two
        # packs, then every preset's train, then every eval
        packs = POOL.submit(finish, {t: start_cli(
            ["pack", "--sequences", "--root", windows, "--out",
             os.path.join(root, f"pack{t}"), "--seq-len", str(t)])
            for t in sorted({t for _, t in TEMPORAL_CLI})})
        yield from until_done(packs)
        packs = packs.result()
        for t, (stdout, _) in packs.items():
            meta = last_json(stdout)
            assert meta["kind"] == "sequences", meta
            assert {s: v["count"] for s, v in meta["splits"].items()} == count
        flags = {preset: ["--preset", preset,
                          f"--data.packed_dir={os.path.join(root, f'pack{t}')}",
                          f"--data.seq_root={windows}"]
                 for preset, t in TEMPORAL_CLI}
        trains = POOL.submit(finish, {preset: start_cli(
            ["train", *flags[preset], "--out",
             os.path.join(root, f"run_{preset}"), "--train.epochs=2"])
            for preset, _ in TEMPORAL_CLI})
        yield from until_done(trains)
        trains = trains.result()
        summaries = {p: last_json(out) for p, (out, _) in trains.items()}
        evals_run = POOL.submit(finish, {preset: start_cli(
            ["eval", os.path.join(root, f"run_{preset}", "ckpt",
                                  f"{summaries[preset]['best_epoch']}.pt"),
             *flags[preset]]) for preset, _ in TEMPORAL_CLI})
        yield from until_done(evals_run)
        evals_run = evals_run.result()
        for preset, t in TEMPORAL_CLI:
            summary = summaries[preset]
            preset_cfg = get_preset(preset)
            bs = preset_cfg.data.batch_size
            heads = int(preset_cfg.model.name != "fact")
            steps = count["train"] // bs
            evals = -(-count["valid"] // bs), -(-count["test"] // bs)
            epochs = epoch_records(os.path.join(root, f"run_{preset}"))
            want = {"training": 2 * steps * heads,
                    "inference": (2 * evals[0] + evals[1]) * heads}
            launches = summary["kernel_launches"]
            assert launches["fusion_head"] == want, (preset, launches)
            assert launches["quadrant"] == {"training": 0, "inference": 0}
            assert [r["steps"] for r in epochs] == [steps, steps], epochs
            assert all(np.isfinite(r["train_loss"]) for r in epochs), epochs
            assert np.isfinite(summary["test"]["loss"]), summary
            assert summary["test"]["count"] == count["test"], summary
            ev = last_json(evals_run[preset][0])
            assert ev["kernel_launches"]["fusion_head"] == {
                "training": 0, "inference": evals[1] * heads}, (
                ev["kernel_launches"])
            assert ev["count"] == summary["test"]["count"]
            assert abs(ev["loss"] - summary["test"]["loss"]) <= 1e-5 * max(
                1.0, abs(summary["test"]["loss"])), (ev, summary["test"])
            for out in (launches, ev["kernel_launches"]):
                for k in ("quadrant", "fusion_head"):
                    totals[k] += out[k]["inference"]
                    totals[k + "_train"] += out[k]["training"]
                totals["channel_stats"] += out["channel_stats"]
                totals["affine_relu"] += out["affine_relu"]
            rows.append({"preset": preset, "seq_len": t, "batch": bs,
                         "pack_cli_s": packs[t][1],
                         "train_cli_s": trains[preset][1],
                         "train_loss": [r["train_loss"] for r in epochs],
                         "val_loss": [r["val_loss"] for r in epochs],
                         "clips_per_sec": [r["images_per_sec"]
                                           for r in epochs],
                         "epoch_time_s": [r["epoch_time_s"] for r in epochs],
                         "test_loss": summary["test"]["loss"],
                         "test_accuracy": summary["test"]["accuracy"],
                         "eval_loss": ev["loss"], "launches": launches,
                         "eval_launches": ev["kernel_launches"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "temporal_cli", "windows": count, "write_s": write_s,
          "runs": rows, **card})
    return totals


def temporal_phase(quadrant, fusion_head, stem_bn, card):
    """Every temporal configuration (:data:`TEMPORAL_CONFIGS`), one temporal
    request over HTTP, and the head kernel timed at the six temporal
    widths in both forms; the CLI on the temporal replay set is
    :func:`temporal_cli`, run side by side. → (launches of this process
    per kernel form, timed rows)."""
    from surya_tpu_torch.core.config import get_preset

    t0 = time.perf_counter()
    for k in stem_bn.launches:
        stem_bn.launches[k] = 0
    totals = dict.fromkeys(("quadrant", "quadrant_train", "fusion_head",
                            "fusion_head_train"), 0)
    summary = []
    http = None
    for label, preset, overrides in TEMPORAL_CONFIGS:
        cfg = get_preset(preset).override(overrides)
        predictor, clips, feats, row = temporal_model(
            label, cfg, quadrant, fusion_head, card)
        for part in row["launches"].values():
            for k, v in part.items():
                totals[k] += v
        summary.append({"model": label, "head_d_h": row["head_d_h"],
                        "f32_max_rel_err": row["f32_card_vs_cpu"][
                            "max_rel_err"],
                        "serve_clips_per_s": row["serve"][
                            "clips_per_s_median"],
                        "train_step_ms": row["train"]["step_ms_median"]})
        if label == "quadtree-3d":
            http = temporal_http(predictor, clips, feats, quadrant,
                                 fusion_head, card)
            for k, v in http.items():
                totals[k] += v
        del predictor, clips, feats
        torch.cuda.empty_cache()
    assert http is not None
    totals.update(stem_bn.launches)
    assert totals["quadrant"] == totals["quadrant_train"] == 0, totals
    assert totals["channel_stats"] == totals["affine_relu"] == 0, totals

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timed = {}
    for shape in TEMPORAL_HEAD_SHAPES:
        for train in (False, True):
            name = "fusion_head_train" if train else "fusion_head"
            row = head_timed(fusion_head, shape, flush, train)
            timed[(name, shape)] = row
            emit({"phase": "time", "kernel": name, "dtype": "bfloat16",
                  "clocks_after": clocks(), "shape": list(shape), **row,
                  **card})
    del flush
    emit({"phase": "temporal_summary", "models": summary, "launches": totals,
          "seconds": time.perf_counter() - t0, **card})
    return totals, timed


POSE_CKPT = os.path.join(REPO, "runs", "pose_landmark", "pose_landmark.msgpack")
POSE_WIDTH, POSE_SIZE, POSE_HOLDOUT = 32, 256, 128   # the checkpoint's
POSE_FRAMES, POSE_BATCH, POSE_CLASSES = 64, 16, 8
POSE_METRICS = ("pck05", "pck10", "mean_err_px", "z_mae", "vis_acc")


def bgr_frames(images):
    """(N, S, S, 3) f32 [0, 1] on the card → N BGR uint8 host frames, as a
    video decoder hands them over."""
    u8 = (images * 255.0).round().to(torch.uint8).flip(-1).cpu().numpy()
    return list(u8)


def pose_train_cli(card):
    """``python -m surya_tpu_torch pose-train`` at its published defaults
    (600 steps, batch 64, 256 px, width 32, lr 1e-3) in a child: the
    holdout PCK@0.10 must reach 0.99; printed beside the JAX package's TPU
    run (``runs/pose_landmark/summary.json``)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="surya_pose_")
    try:
        t0 = time.perf_counter()
        _, summary = run_cli(["pose-train", "--out", root])
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with open(os.path.join(REPO, "runs", "pose_landmark", "summary.json")) as f:
        jax_run = json.load(f)
    row = {"phase": "pose_train", "steps": summary["steps"],
           "batch": summary["batch"], "image_size": summary["image_size"],
           "width": summary["width"], "params": summary["params"],
           "backend": summary["backend"], "cli_wall_s": wall,
           "train_wall_s": summary["wall_s"],
           "step_ms_median": summary["step_ms_median"],
           **{k: summary[k] for k in POSE_METRICS},
           "jax_tpu_run": {k: jax_run[k] for k in POSE_METRICS + (
               "params", "backend")}, **card}
    emit(row)
    if summary["backend"] != "cuda" or not summary["pck10"] >= 0.99:
        raise AssertionError(f"pose-train missed PCK@0.10 >= 0.99 on the "
                             f"card: {row}")
    return row


def pose_checkpoint(card, reps=5):
    """The JAX package's trained checkpoint through the port's codec and
    bridge: f32 landmarks on the card against the CPU on a generator-seed-99
    holdout of 128 renders (1e-4 of the largest), each side against an f64
    forward on the card, the card's holdout metrics, and bf16
    ``process_batch`` frames/s at batch 64."""
    from surya_tpu_torch.data.synthetic_pose import make_pose_batch
    from surya_tpu_torch.models.pose import landmark_net as ln
    from surya_tpu_torch.models.pose.train import eval_metrics

    state = ln.load_pose_params(POSE_CKPT)
    holdout = make_pose_batch(torch.Generator("cuda").manual_seed(99),
                              POSE_HOLDOUT, POSE_SIZE)
    nets = {}
    for dev in ("cuda", "cpu"):
        net = ln.PoseLandmarkNet(width=POSE_WIDTH, dtype=torch.float32)
        net.load_state_dict(state, strict=True)
        nets[dev] = net.to(dev).eval()
    # f64 on the card: how far f32's own rounding moves each side
    f64 = ln.PoseLandmarkNet(width=POSE_WIDTH, dtype=torch.float64)
    f64.load_state_dict(state, strict=True)
    f64 = f64.to("cuda", torch.float64).eval()
    with torch.inference_mode():
        card_lm = nets["cuda"](holdout[0])["landmarks"].cpu()
        cpu_lm = torch.cat([nets["cpu"](x)["landmarks"]
                            for x in holdout[0].cpu().split(32)])
        exact = f64(holdout[0].double())["landmarks"].cpu()
        f32_metrics = {k: float(v) for k, v in
                       eval_metrics(nets["cuda"], *holdout).items()}
        bf16_net = ln.PoseLandmarkNet(width=POSE_WIDTH).cuda().eval()
        bf16_net.load_state_dict(state, strict=True)
        bf16_metrics = {k: float(v) for k, v in
                        eval_metrics(bf16_net, *holdout).items()}
    err = float((card_lm - cpu_lm).abs().max() / cpu_lm.abs().max())
    parts = {"xy": slice(0, 2), "z": slice(2, 3), "vis": slice(3, 4)}

    def abs_err(a, b):
        return {k: float((a[..., sl].double() - b[..., sl]).abs().max())
                for k, sl in parts.items()}

    extractor = ln.load_pose_extractor(POSE_CKPT)          # bf16, the card
    frames = bgr_frames(holdout[0][:POSE_FRAMES])
    extractor.process_batch(frames)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extractor.process_batch(frames)
        times.append(time.perf_counter() - t0)
    row = {"phase": "pose_checkpoint", "checkpoint": os.path.relpath(
               POSE_CKPT, REPO), "holdout": POSE_HOLDOUT,
           "f32_card_vs_cpu_max_rel_err": err, "tol": 1e-4,
           "f32_card_vs_cpu_abs_err": abs_err(card_lm, cpu_lm.double()),
           "f32_card_vs_f64_card_abs_err": abs_err(card_lm, exact),
           "f32_cpu_vs_f64_card_abs_err": abs_err(cpu_lm, exact),
           "card_f32": f32_metrics, "card_bf16": bf16_metrics,
           "process_batch": {"batch": POSE_FRAMES, "dtype": "bfloat16",
                             "frames_per_s_median":
                                 POSE_FRAMES / statistics.median(times)},
           **card}
    emit(row)
    if not err <= 1e-4:
        raise AssertionError(f"pose net f32 card vs CPU: {err}")
    return row


@contextlib.contextmanager
def recording_kernels():
    """Inside: every call of the two kernel wrappers from the models'
    common layers is kept, with copies of its arguments (as they were at
    the call) and its output (launch counts as before: the wrappers are
    called as they are). → {name: [(args, kwargs, out)]}."""
    from surya_tpu_torch.models import common
    from surya_tpu_torch.models.spatial import quadtree

    calls = {"quadrant": [], "fusion_head": []}

    def copied(a):   # a train step updates the weights in place later
        return a.detach().clone() if torch.is_tensor(a) else a

    def keep(fn, seen):
        def call(*args, **kw):
            out = fn(*args, **kw)
            seen.append((tuple(map(copied, args)),
                         {k: copied(v) for k, v in kw.items()},
                         out.detach()))
            return out
        return call

    originals = quadtree.quadrant_process, common.fusion_head
    quadtree.quadrant_process = keep(originals[0], calls["quadrant"])
    common.fusion_head = keep(originals[1], calls["fusion_head"])
    try:
        yield calls
    finally:
        quadtree.quadrant_process, common.fusion_head = originals


def hold_recorded(calls, quadrant, fusion_head):
    """Each kept kernel call against its plain version in f32 on the
    same inputs (weights rounded to the input's dtype, as the kernel
    reads them), to TOL of that dtype; every call must be the bf16
    inference form on the card. → per kernel: calls, shape, dtype and
    the largest errors."""
    plain = {"quadrant": lambda x, w, b, **_: quadrant.quadrant_process_plain(
                 x.float(), w.to(x.dtype).float(), b.float()),
             "fusion_head": lambda x, w1, b1, w2, b2, **_:
                 fusion_head.fusion_head_plain(
                     x.float(), w1.to(x.dtype).float(), b1.float(),
                     w2.to(x.dtype).float(), b2.float())}
    held, failed = {}, []
    with torch.inference_mode():
        for name, seen in calls.items():
            held[name] = _hold(name, seen, plain[name], failed)
    batches = POSE_FRAMES // POSE_BATCH
    if failed or not all(held[k]["calls"] == batches for k in held):
        raise AssertionError(f"video core kernels vs plain: {held} {failed}")
    return held


def _hold(name, seen, plain, failed, train=False, dtype=torch.bfloat16):
    row = {"calls": len(seen), "max_abs_err": 0.0, "max_rel_err": 0.0}
    form = "training" if train else "inference"
    for args, kw, out in seen:
        x = args[0]
        dname = str(x.dtype).removeprefix("torch.")
        row.update(shape=list(x.shape), dtype=dname, tol=TOL[dname])
        if not (x.is_cuda and out.is_cuda and x.dtype == dtype
                and bool(kw.get("rate")) == train):
            failed.append((name, f"not the {dtype} {form} form on the "
                                 "card"))
        err, rel = compare(out, plain(*args, **kw))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_rel_err"] = max(row["max_rel_err"], rel)
        if not (rel <= TOL[dname] and torch.isfinite(out.float()).all()):
            failed.append((name, list(x.shape), dname, err, rel))
    return row


def pose_video(quadrant, fusion_head, card, reps=3):
    """``video``'s frame-batch core on 64 class-conditional renders (8
    classes, 256 px, BGR uint8) at batch 16: the neural extractor on the
    JAX checkpoint, ``extract_features_47`` and the ``quadtree-fusion``
    classifier at 224 px (random weights from seed 0). The bf16 run
    launches exactly 4 quadrant and 4 head kernels, both in the inference
    form, and each launch's output is held against the plain version on
    its own inputs (2e-2). Then f32 probabilities on the card against the
    CPU (1e-4): end to end, each side with its own extractor, and the
    CPU's classifier on the card's staged images and features."""
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.data.synthetic_pose import (
        class_swing_centers,
        make_pose_class_batch,
    )
    from surya_tpu_torch.infer import video
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.models.pose import landmark_net as ln

    cfg = get_preset("quadtree-fusion")
    size = cfg.data.image_size
    state = get_model(cfg.model, image_size=size, seed=0).state_dict()
    labels = np.arange(POSE_FRAMES) % POSE_CLASSES
    frames = bgr_frames(make_pose_class_batch(
        torch.Generator("cuda").manual_seed(0), labels,
        class_swing_centers(POSE_CLASSES), POSE_SIZE)[0])
    names = [f"pose{i}" for i in range(POSE_CLASSES)]

    def run(classify, extractor):
        out = []
        for lo in range(0, POSE_FRAMES, POSE_BATCH):
            recs, _, det = video.classify_frame_batch(
                classify, extractor, frames[lo:lo + POSE_BATCH], names,
                size, start=lo)
            out += [dict(r, detected=d) for r, d in zip(recs, det)]
        return out

    extractor = ln.load_pose_extractor(POSE_CKPT)
    classify = video.make_frame_classifier(cfg.model, state, size)
    with recording_kernels() as calls:
        reset_launches(quadrant, fusion_head)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = run(classify, extractor)
        first_s = time.perf_counter() - t0
        launches = read_launches(quadrant, fusion_head)
    held = hold_recorded(calls, quadrant, fusion_head)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(classify, extractor)
        times.append(time.perf_counter() - t0)
    if launches != {"quadrant": 4, "quadrant_train": 0, "fusion_head": 4,
                    "fusion_head_train": 0}:
        raise AssertionError(f"video core launches: {launches}")
    assert len(records) == POSE_FRAMES and all(
        0.0 < r["confidence"] <= 1.0 for r in records), records

    # f32, end to end (each side its own extractor), and the CPU's
    # classifier on the card's staged images and features
    cfg32 = dataclasses.replace(cfg.model, compute_dtype="float32")
    probs, clfs, staged = {}, {}, []
    for dev in ("cuda", "cpu"):
        clf = clfs[dev] = video.make_frame_classifier(cfg32, state, size,
                                                      device=dev)
        seen = []

        def recording(x, f, clf=clf, seen=seen, dev=dev):
            p = clf.probs(x, f)
            seen.append(p.cpu())
            if dev == "cuda":
                staged.append((x.cpu(), f.cpu()))
            conf, pred = p.max(-1)
            return pred, conf

        recording.device = clf.device
        ext = ln.load_pose_extractor(POSE_CKPT, device=dev,
                                     dtype=torch.float32)
        recs = run(recording, ext)
        probs[dev] = (torch.cat(seen), recs)
    same_in = torch.cat([clfs["cpu"].probs(x, f) for x, f in staged])
    err = float((probs["cuda"][0] - probs["cpu"][0]).abs().max())
    err_same_in = float((probs["cuda"][0] - same_in).abs().max())
    same_labels = [r["label"] for r in probs["cuda"][1]] == [
        r["label"] for r in probs["cpu"][1]]
    row = {"phase": "pose_video", "frames": POSE_FRAMES,
           "batch": POSE_BATCH, "classes": POSE_CLASSES,
           "frame_size": POSE_SIZE, "classifier_size": size,
           "launches": launches,
           "detected": sum(r["detected"] for r in records),
           "first_run_s": first_s,
           "bf16_frames_per_s_median": POSE_FRAMES / statistics.median(times),
           "bf16_kernels_vs_plain": held,
           "f32_card_vs_cpu_max_abs_prob_err": err,
           "f32_same_inputs_max_abs_prob_err": err_same_in, "tol": 1e-4,
           "f32_labels_equal": same_labels, **card}
    emit(row)
    if not (err <= 1e-4 and err_same_in <= 1e-4 and same_labels):
        raise AssertionError(f"video core f32 card vs CPU: {row}")
    return launches


def pose_phase(quadrant, fusion_head, card):
    """The feature, prep and pose tier: ``pose-train`` through the CLI at
    its published size, the JAX package's checkpoint on the card, and
    ``video``'s frame-batch core through the flagship's two kernels. →
    the video core's launches per kernel form."""
    t0 = time.perf_counter()
    train = pose_train_cli(card)
    torch.cuda.empty_cache()
    ckpt = pose_checkpoint(card)
    torch.cuda.empty_cache()
    launches = pose_video(quadrant, fusion_head, card)
    emit({"phase": "pose_summary", "seconds": time.perf_counter() - t0,
          "pose_train_pck10": train["pck10"],
          "pose_train_step_ms_median": train["step_ms_median"],
          "checkpoint_f32_err": ckpt["f32_card_vs_cpu_max_rel_err"],
          "launches": launches, **card})
    return launches



# ---------------------------------------------------------------------------
# export: torch.export serving artifacts and the reference interchange
# ---------------------------------------------------------------------------

EXPORT_DIR = os.path.join(REPO, "build", "chip_smoke_export")
EXPORT_IMAGES, EXPORT_BATCH, EXPORT_RUNS = 640, 64, 3
TEMPORAL_EXPORT_CLIPS = 16        # two chunks at quadtree-3d's batch of 8
OP_NAMES = ("quadrant_process", "fusion_head")


def start_cli(args):
    """``python -m surya_tpu_torch ARGS`` from the repository, started."""
    return start_child([sys.executable, "-m", "surya_tpu_torch", *args])


def start_artifact_child(spec: dict):
    """``chip_smoke.py --serve-artifact SPEC``, started: a process that
    imports only ``surya_tpu_torch`` and serves an artifact."""
    return start_child([sys.executable, os.path.abspath(__file__),
                        "--serve-artifact", json.dumps(spec)])


def finish(procs: dict, timeout=600) -> dict:
    """Wait for every started child → {name: (stdout, seconds)}; a child
    that fails raises, and every child still running is killed."""
    t0, out = time.perf_counter(), {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            if proc.returncode != 0:
                raise AssertionError(f"{name} failed ({proc.returncode}):\n"
                                     f"{stdout[-4000:]}\n{stderr[-4000:]}")
            out[name] = (stdout, time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def wire_images(raw: np.ndarray, wire: str) -> np.ndarray:
    return raw if wire == "uint8" else (raw / 255.0).astype(np.float32)


def serve_artifact(spec: dict) -> dict:
    """The child: load the artifact onto ``spec["device"]`` and run the
    first ``n`` samples of the saved inputs through ``call`` in its fixed
    batch, with every launch count set to 0 just before and read just
    after; the probabilities go to ``spec["probs"]``. With
    ``spec["time_against"]`` (a checkpoint and its Predictor settings),
    ``EXPORT_RUNS`` timed passes of the artifact and of the Predictor in
    turns. → launches, graph nodes, timings."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from surya_tpu_torch.infer.serve import load_exported
    from surya_tpu_torch.ops.cuda import fusion_head, quadrant

    t0 = time.perf_counter()
    loaded = load_exported(spec["artifact"], device=spec["device"])
    load_s = time.perf_counter() - t0
    meta, n = loaded.meta, spec["n"]
    images = wire_images(np.load(spec["images"])[:n], meta["input_dtype"])
    feats = np.load(spec["feats"])[:n]
    b = meta["batch_size"]

    def run():
        return [loaded.call(images[lo:lo + b], feats[lo:lo + b])[1].cpu()
                for lo in range(0, n, b)]

    loaded.call(images[:b], feats[:b])                  # warm-up
    sync = torch.cuda.synchronize if spec["device"] == "cuda" else (
        lambda: None)
    sync()
    reset_launches(quadrant, fusion_head)
    probs = torch.cat(run()).numpy()
    sync()
    launches = read_launches(quadrant, fusion_head)
    np.save(spec["probs"], probs)
    nodes = [node for node in loaded.program.graph.nodes
             if node.op == "call_function"]
    graph = {name: sum(str(node.target) == f"surya_tpu_torch.{name}.default"
                       for node in nodes) for name in OP_NAMES}
    graph["training_form_nodes"] = sum(
        "autograd" in str(node.target) or "higher_order" in str(node.target)
        for node in nodes)
    graph["quadrant_plain_convs"] = sum(
        node.target == torch.ops.aten.conv2d.default and
        tuple(node.meta["val"].shape[2:]) == (meta["image_size"] // 32,) * 2
        and node.meta["val"].shape[0] == 4 * b for node in nodes)
    out = {"load_s": load_s, "launches": launches, "graph": graph,
           "input_dtype": meta["input_dtype"], "batch_size": b}
    if spec.get("time_against"):
        from surya_tpu_torch.core.checkpoint import load_params
        from surya_tpu_torch.core.config import get_preset
        from surya_tpu_torch.infer.serve import Predictor

        against = spec["time_against"]
        predictor = Predictor(
            get_preset(against["preset"]).model,
            load_params(against["checkpoint"]), batch_size=b,
            param_dtype=getattr(torch, against["param_dtype"]),
            input_dtype=meta["input_dtype"])
        predictor.predict(images[:b], feats[:b])        # warm-up
        rates = {"artifact": [], "predictor": []}
        order = ["artifact", "predictor", "predictor", "artifact"] * 2
        for name in order[:2 * EXPORT_RUNS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "artifact":
                [p.numpy() for p in run()]
            else:
                predictor.predict(images, feats)
            rates[name].append(n / (time.perf_counter() - t0))
        out["img_per_s"] = rates
        out["img_per_s_median"] = {k: statistics.median(v)
                                   for k, v in rates.items()}
    return out


def export_phase(quadrant, fusion_head, card):
    """``export`` through the CLI, each artifact served in a child that
    imports only ``surya_tpu_torch``: ``quadtree-fusion`` at 224 px from
    seed 0, batch 64, as a bf16 artifact on a uint8 wire (the serve
    phase's configuration: 640 images, exactly 10 + 10 inference-form
    launches, probabilities within 2e-2 of the in-process Predictor's,
    img/s of ``call`` against ``Predictor.predict`` in turns) and an f32
    one on an f32 wire (within 1e-5 of the f32 Predictor; loaded on the
    CPU, one chunk within 1e-4 of the card); both graphs hold the two
    operators and no training form. ``quadtree-3d`` at its batch of 8 (the
    head at D 1536: one launch per chunk). ``export-torch`` of the
    flagship and back through ``load_reference_state_dict``, bit-equal;
    ``check`` exits 0 naming the card and the three kernel builds. A
    side-by-side phase (:func:`side_by_side`): the timed bf16 artifact is
    served alone, once every other phase has ended. → the artifacts'
    launches on the card per kernel form."""
    from surya_tpu_torch.core.checkpoint import save_params
    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.infer.serve import Predictor
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.models.full_import import load_reference_state_dict
    from surya_tpu_torch.ops.cuda import KERNELS

    t_phase = time.perf_counter()
    os.makedirs(EXPORT_DIR, exist_ok=True)
    path = lambda name: os.path.join(EXPORT_DIR, name)   # noqa: E731
    cfg, cfg3d = get_preset("quadtree-fusion"), get_preset("quadtree-3d")
    size = cfg.data.image_size
    state = get_model(cfg.model, image_size=size, seed=0).state_dict()
    state3d = get_model(cfg3d.model, image_size=size, seed=0).state_dict()
    save_params(path("flagship.pt"), state)
    save_params(path("quadtree3d.pt"), state3d)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (EXPORT_IMAGES, size, size, 3), np.uint8)
    feats = rng.normal(size=(EXPORT_IMAGES, 47)).astype(np.float32)
    t3d = cfg3d.model.seq_len
    clips = rng.integers(0, 256, (TEMPORAL_EXPORT_CLIPS, t3d, size, size, 3),
                         np.uint8)
    clip_feats = rng.normal(size=(TEMPORAL_EXPORT_CLIPS, t3d, 47)).astype(
        np.float32)
    for name, a in (("images", raw), ("feats", feats), ("clips", clips),
                    ("clip_feats", clip_feats)):
        np.save(path(f"{name}.npy"), a)

    # the artifacts, the reference checkpoint and the report, at once
    f32 = ["--model.compute_dtype=float32"]
    procs = {
        "export_bf16": start_cli([
            "export", path("flagship.pt"), path("flagship_bf16.pt2"),
            "--batch-size", str(EXPORT_BATCH), "--param-dtype", "bfloat16",
            "--input-dtype", "uint8"]),
        "export_f32": start_cli([
            "export", path("flagship.pt"), path("flagship_f32.pt2"),
            "--batch-size", str(EXPORT_BATCH), "--param-dtype", "float32",
            "--input-dtype", "float32", *f32]),
        "export_3d": start_cli([
            "export", path("quadtree3d.pt"), path("quadtree3d_bf16.pt2"),
            "--preset", "quadtree-3d", "--batch-size",
            str(cfg3d.data.batch_size), "--param-dtype", "bfloat16",
            "--input-dtype", "uint8"]),
        "export_torch": start_cli(["export-torch", path("flagship.pt"),
                                   path("flagship_reference.pth")]),
        "check": start_cli(["check"])}
    made = POOL.submit(finish, procs)
    yield from until_done(made)
    made = made.result()
    lines = {k: last_json(v[0]) for k, v in made.items() if k != "check"}
    export_s = {k: made[k][1] for k in made}

    # the report: the card and every kernel build
    report = json.loads(made["check"][0])
    built = {k: v["built"] for k, v in report["kernels"].items()}
    if not (report["card"] == card["card"] and set(built) == set(KERNELS)
            and all(built.values())):
        raise AssertionError(f"check: {report}")

    # the reference round trip: export-torch → import, bit for bit
    ref = torch.load(path("flagship_reference.pth"), weights_only=True)
    back = load_reference_state_dict("quadtree", ref, mode="fusion")
    round_trip = sorted(back) == sorted(state) and all(
        torch.equal(back[k], state[k]) for k in state)
    if not round_trip:
        raise AssertionError("export-torch → import is not the identity")

    # serve the artifacts: f32 on the card and on the CPU and the temporal
    # one together, then the bf16 one alone (it is timed)
    def spec(artifact, n, probs, device="cuda", images="images",
             feats_name="feats", **kw):
        return {"artifact": path(artifact), "n": n, "device": device,
                "images": path(f"{images}.npy"),
                "feats": path(f"{feats_name}.npy"), "probs": path(probs),
                **kw}

    served = POOL.submit(finish, {
        "f32": start_artifact_child(spec("flagship_f32.pt2", EXPORT_IMAGES,
                                         "f32_card.npy")),
        "f32_cpu": start_artifact_child(spec("flagship_f32.pt2",
                                             EXPORT_BATCH, "f32_cpu.npy",
                                             device="cpu")),
        "3d": start_artifact_child(spec(
            "quadtree3d_bf16.pt2", TEMPORAL_EXPORT_CLIPS, "3d.npy",
            images="clips", feats_name="clip_feats"))})
    yield

    # the same weights and inputs through the in-process Predictor
    want = {"bf16": Predictor(cfg.model, state, batch_size=EXPORT_BATCH,
                              param_dtype=torch.bfloat16,
                              input_dtype="uint8").predict(raw, feats)}
    cfg32 = dataclasses.replace(cfg.model, compute_dtype="float32")
    want["f32"] = Predictor(cfg32, state, batch_size=EXPORT_BATCH).predict(
        wire_images(raw, "float32"), feats)
    want["3d"] = Predictor(cfg3d.model, state3d,
                           batch_size=cfg3d.data.batch_size,
                           param_dtype=torch.bfloat16,
                           input_dtype="uint8").predict(clips, clip_feats)
    yield from until_done(served)
    served = served.result()
    yield SOLO
    served.update(finish({"bf16": start_artifact_child(spec(
        "flagship_bf16.pt2", EXPORT_IMAGES, "bf16.npy",
        time_against={"checkpoint": path("flagship.pt"),
                      "preset": "quadtree-fusion",
                      "param_dtype": "bfloat16"}))}))
    runs = {k: last_json(v[0]) for k, v in served.items()}
    probs = {k: np.load(path(f"{k}.npy")) for k in ("bf16", "3d")}
    probs["f32"] = np.load(path("f32_card.npy"))
    probs["f32_cpu"] = np.load(path("f32_cpu.npy"))
    errs = {k: float(np.abs(probs[k] - want[k][1]).max()) for k in want}
    agree = {k: float((probs[k].argmax(-1) == want[k][0]).mean())
             for k in want}
    errs["f32_cpu_vs_card"] = float(np.abs(
        probs["f32_cpu"] - probs["f32"][:EXPORT_BATCH]).max())
    tol = {"bf16": 2e-2, "f32": 1e-5, "3d": 2e-2, "f32_cpu_vs_card": 1e-4}

    chunks = EXPORT_IMAGES // EXPORT_BATCH
    chunks3d = TEMPORAL_EXPORT_CLIPS // cfg3d.data.batch_size
    want_launches = {
        "bf16": {"quadrant": chunks, "quadrant_train": 0,
                 "fusion_head": chunks, "fusion_head_train": 0},
        "f32": {"quadrant": chunks, "quadrant_train": 0,
                "fusion_head": chunks, "fusion_head_train": 0},
        "3d": {"quadrant": 0, "quadrant_train": 0, "fusion_head": chunks3d,
               "fusion_head_train": 0}}
    graphs = {k: runs[k]["graph"] for k in runs}
    row = {"phase": "export", "preset": "quadtree-fusion", "image_size": size,
           "batch": EXPORT_BATCH, "images": EXPORT_IMAGES,
           "artifact_bytes": {k: lines[f"export_{k}"]["bytes"]
                              for k in ("bf16", "f32", "3d")},
           "child_s": export_s,
           "load_s": {k: runs[k]["load_s"] for k in runs},
           "launches": {k: runs[k]["launches"] for k in want_launches},
           "graph": graphs, "max_abs_prob_err": errs, "tol": tol,
           "argmax_agreement": agree,
           "img_per_s": runs["bf16"]["img_per_s"],
           "img_per_s_median": runs["bf16"]["img_per_s_median"],
           "reference_round_trip_bit_equal": round_trip,
           "reference_tensors": lines["export_torch"]["tensors"],
           "check_kernels": built,
           "seconds": time.perf_counter() - t_phase, **card}
    emit(row)
    for k, n in want_launches.items():
        if runs[k]["launches"] != n:
            raise AssertionError(f"{k} artifact launches {runs[k]['launches']}"
                                 f" != {n}")
    for k, g in graphs.items():
        quad = 0 if k == "3d" else 1
        if (g["quadrant_process"], g["fusion_head"]) != (quad, 1) or g[
                "training_form_nodes"] or g["quadrant_plain_convs"]:
            raise AssertionError(f"{k} artifact graph: {g}")
    if not all(errs[k] <= tol[k] for k in tol):
        raise AssertionError(f"export probabilities: {errs} (tol {tol})")
    if runs["f32_cpu"]["launches"] != {k: 0 for k in want_launches["3d"]}:
        raise AssertionError(f"the CPU child launched: {runs['f32_cpu']}")
    return {name: sum(runs[k]["launches"][name] for k in want_launches)
            for name in want_launches["bf16"]}

# ---------------------------------------------------------------------------
# generate: the generative augmentation tier
# ---------------------------------------------------------------------------

GEN_DIR = os.path.join(REPO, "build", "chip_smoke_generate")
GEN_CLIPS = (("video_clip_001", "cobra pose"), ("video_clip_002",
                                                "plank pose"))
GEN_FRAMES, GEN_FRAME_HW = 6, (480, 640)
GEN_TILE, GEN_STEPS, GEN_ROWS, GEN_COLS = 320, 75, 3, 2
GEN_IMAGES = 2                     # clean PNGs through the zero123plus path
PARITY_BANK, PARITY_LATENT = (16, 16), (48, 32)   # a 128-px tile's latents
VAE_PARITY_PX = 256
U2NET_SIZE, U2NET_BATCH, U2NET_RUNS = 320, 16, 5
PARAMS = {"unet": 865_910_724, "vae": 83_653_863, "u2net": 44_009_869,
          "u2netp": 1_131_181}      # jax.eval_shape of the JAX package's
CHAIN_BATCH, CHAIN_STEPS, CHAIN_T, CHAIN_STRIDE = 16, 2, 4, 2
GEN_NAME = re.compile(r"video_clip_00[12]_frame_0000[1-6]\.png")


def gen_renamed_tree(root):
    """The train split of a renamed tree: one clip per label
    (``video_clip_001`` cobra, ``video_clip_002`` plank), 6 frames of
    480×640 each (a bright subject on a noisy ground, PNG), with the
    frame maps ``rename_frames`` writes and a label CSV. → (renamed
    root, [label CSV])."""
    import csv

    from PIL import Image

    from surya_tpu_torch.data.prep.frame_renaming import rename_frames

    rng = np.random.default_rng(0)
    h, w = GEN_FRAME_HW
    rows = []
    for clip, label in GEN_CLIPS:
        raw = os.path.join(root, "raw", "train", clip)
        os.makedirs(raw, exist_ok=True)
        for k in range(GEN_FRAMES):
            frame = rng.integers(0, 96, (h, w, 3), dtype=np.uint8)
            top, left = 80 + 10 * k, 200 + 15 * k
            frame[top:top + 300, left:left + 160] = rng.integers(
                160, 256, 3, dtype=np.uint8)
            name = f"{clip}-{k + 1:05d}_png.rf.{k}.png"
            Image.fromarray(frame).save(os.path.join(raw, name))
            rows.append({"filename": name, "label": label})
    label_csv = os.path.join(root, "labels.csv")
    with open(label_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["filename", "label"])
        writer.writeheader()
        writer.writerows(rows)
    renamed = os.path.join(root, "renamed")
    rename_frames(os.path.join(root, "raw"), renamed)
    return renamed, [label_csv]


def gen_u2net(card):
    """U²-Net ``u2net`` and ``u2netp`` at 320², weights from seed 0: f32
    card vs CPU on 2 images (the fused map on normalised input, and the
    alpha of ``saliency`` on uint8 frames), 1e-4 relative; bf16 frames/s
    of the saliency core at batch 16; then ``process_pipeline`` with
    ``u2net_remove_fn(variant="u2net")`` over the renamed tree: 12 RGBA
    PNGs named ``video_clip_00N_frame_0000K.png``, per-frame wall time,
    and a second run that skips all 12. → the clean root."""
    from PIL import Image

    from surya_tpu_torch.augmentgen import background
    from surya_tpu_torch.models.common import (
        cast_matmul_weights,
        count_parameters,
        load_state,
        seeded,
    )
    from surya_tpu_torch.models.segmentation.u2net import U2Net, saliency

    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(
        0, 256, (2, U2NET_SIZE, U2NET_SIZE, 3), dtype=np.uint8))
    x = torch.from_numpy(rng.normal(size=(2, U2NET_SIZE, U2NET_SIZE, 3))
                         .astype(np.float32))
    batch = torch.from_numpy(rng.integers(
        0, 256, (U2NET_BATCH, U2NET_SIZE, U2NET_SIZE, 3),
        dtype=np.uint8)).to("cuda")
    rows = {}
    for variant in ("u2net", "u2netp"):
        cpu = seeded(lambda v=variant: U2Net(v), 0, "cpu").eval()
        if count_parameters(cpu) != PARAMS[variant]:
            raise AssertionError(f"{variant}: {count_parameters(cpu)} "
                                 f"parameters")
        gpu = copy.deepcopy(cpu).to("cuda")
        with torch.inference_mode():
            t0 = time.perf_counter()
            want_fused, _ = cpu(x)
            want_alpha = saliency(cpu, frames, U2NET_SIZE)
            cpu_s = time.perf_counter() - t0
            got_fused, _ = gpu(x.to("cuda"))
            got_alpha = saliency(gpu, frames.to("cuda"), U2NET_SIZE)
        fused_rel = compare(got_fused.cpu(), want_fused)[1]
        alpha_rel = compare(got_alpha.cpu(), want_alpha)[1]
        b16 = cast_matmul_weights(load_state(
            lambda v=variant: U2Net(v, torch.bfloat16), gpu.state_dict(),
            "cuda"), torch.bfloat16).eval()
        del gpu
        times = []
        with torch.inference_mode():
            for i in range(U2NET_RUNS + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                alpha = saliency(b16, batch, U2NET_SIZE)
                torch.cuda.synchronize()
                if i >= 2:
                    times.append(time.perf_counter() - t0)
        rows[variant] = {
            "parameters": PARAMS[variant], "cpu_f32_s": cpu_s,
            "f32_card_vs_cpu_fused_rel": fused_rel,
            "f32_card_vs_cpu_alpha_rel": alpha_rel, "tol": TOL["float32"],
            "bf16_batch": U2NET_BATCH,
            "bf16_frames_per_s_median":
                U2NET_BATCH / statistics.median(times),
            "bf16_finite": bool(torch.isfinite(alpha).all())}
        del b16
        if not (fused_rel <= TOL["float32"] and alpha_rel <= TOL["float32"]
                and rows[variant]["bf16_finite"]):
            raise AssertionError(f"U²-Net {variant}: {rows[variant]}")

    renamed, csvs = gen_renamed_tree(GEN_DIR)
    clean = os.path.join(GEN_DIR, "clean")
    remove = background.u2net_remove_fn(variant="u2net", size=U2NET_SIZE,
                                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = background.process_pipeline(renamed, csvs, clean,
                                        remove_fn=remove)
    wall = time.perf_counter() - t0
    again = background.process_pipeline(renamed, csvs, clean,
                                        remove_fn=remove)
    n = len(GEN_CLIPS) * GEN_FRAMES
    names = []
    for _, label in GEN_CLIPS:
        for name in sorted(os.listdir(os.path.join(clean, "train", label))):
            with Image.open(os.path.join(clean, "train", label, name)) as im:
                ok = (im.mode == "RGBA"
                      and im.size == GEN_FRAME_HW[::-1])
            names.append((name, ok))
    row = {"phase": "generate_u2net", **rows,
           "pipeline": {"variant": "u2net", "frames": n,
                        "frame_hw": list(GEN_FRAME_HW), "first": first,
                        "resumed": again, "wall_s": wall,
                        "f32_s_per_frame": wall / n}, **card}
    emit(row)
    if not (first == {"train": {"done": n, "skipped": 0}}
            and again == {"train": {"done": 0, "skipped": n}}
            and len(names) == n
            and all(ok and GEN_NAME.fullmatch(nm) for nm, ok in names)):
        raise AssertionError(f"process_pipeline: {first} {again} {names}")
    return clean


def two_pass(unet, cond, x, t, ehs):
    """One write pass over ``cond`` and one read pass over ``x`` with its
    bank, as the reference denoiser makes them."""
    _, bank = unet(cond, t, ehs)
    return unet(x, t, ehs, refs=bank)[0]


def gen_models(card):
    """The zero123plus UNet and the SD VAE at their published widths,
    weights from seed 0 on the CPU: parameter counts; f32 card vs CPU of
    one write + read pass on a 128-px tile's latents (a 16×16 bank, a
    48×32 latent, a (1, 77, 1024) context from seed 0), relative L2 1e-4
    with TF32 off, and bf16 against f32 on the card (reported); the VAE's
    f32 encode and decode at 256 px, 1e-4. → the bf16 UNet and VAE on the
    card and the context."""
    from surya_tpu_torch.models.common import (
        cast_matmul_weights,
        count_parameters,
        load_state,
        seeded,
    )
    from surya_tpu_torch.models.diffusion.unet_cond import (
        UNet2DCondition,
        zero123plus_config,
    )
    from surya_tpu_torch.models.diffusion.vae import (
        AutoencoderKL,
        sd_vae_config,
    )

    rng = np.random.default_rng(0)
    ehs = torch.from_numpy(rng.normal(size=(1, 77, 1024)).astype(np.float32))
    cond = torch.from_numpy(rng.normal(size=(1, *PARITY_BANK, 4))
                            .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(1, *PARITY_LATENT, 4))
                         .astype(np.float32))
    t = torch.tensor([499.0])
    t0 = time.perf_counter()
    cpu = seeded(lambda: UNet2DCondition(zero123plus_config(torch.float32)),
                 0, "cpu").eval()
    init_s = time.perf_counter() - t0
    n_unet = count_parameters(cpu)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = two_pass(cpu, cond, x, t, ehs)
        cpu_s = time.perf_counter() - t0
        gpu = cpu.to("cuda")          # moved: the CPU run is done
        dev = [a.to("cuda") for a in (cond, x, t, ehs)]
        got = two_pass(gpu, *dev)
        unet = cast_matmul_weights(load_state(
            lambda: UNet2DCondition(zero123plus_config()), gpu.state_dict(),
            "cuda"), torch.bfloat16).eval()
        del gpu, cpu
        got16 = two_pass(unet, *dev)
    unet_rel = rel_l2(got.cpu(), want)
    bf16_rel = rel_l2(got16.float(), got)

    vcpu = seeded(lambda: AutoencoderKL(sd_vae_config(torch.float32)), 0,
                  "cpu").eval()
    n_vae = count_parameters(vcpu)
    px = torch.from_numpy(rng.uniform(
        -1, 1, (1, VAE_PARITY_PX, VAE_PARITY_PX, 3)).astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        mean, logvar = vcpu.encode(px)
        rec = vcpu.decode(mean)
        vae_cpu_s = time.perf_counter() - t0
        vgpu = vcpu.to("cuda")
        gmean, glogvar = vgpu.encode(px.to("cuda"))
        grec = vgpu.decode(mean.to("cuda"))
        vae = cast_matmul_weights(load_state(
            lambda: AutoencoderKL(sd_vae_config()), vgpu.state_dict(),
            "cuda"), torch.bfloat16).eval()
        del vgpu, vcpu
    vae_rel = {"mean": compare(gmean.cpu(), mean)[1],
               "logvar": compare(glogvar.cpu(), logvar)[1],
               "decode": compare(grec.cpu(), rec)[1]}
    row = {"phase": "generate_models",
           "unet": {"parameters": n_unet, "cpu_init_s": init_s,
                    "bank_hw": list(PARITY_BANK),
                    "latent_hw": list(PARITY_LATENT), "timestep": 499.0,
                    "cpu_f32_two_pass_s": cpu_s,
                    "f32_card_vs_cpu_rel_l2": unet_rel,
                    "tol": TOL["float32"], "bf16_vs_f32_rel_l2": bf16_rel},
           "vae": {"parameters": n_vae, "px": VAE_PARITY_PX,
                   "cpu_f32_s": vae_cpu_s,
                   "f32_card_vs_cpu_rel": vae_rel, "tol": TOL["float32"]},
           **card}
    emit(row)
    if not (n_unet == PARAMS["unet"] and n_vae == PARAMS["vae"]
            and unet_rel <= TOL["float32"]
            and max(vae_rel.values()) <= TOL["float32"]
            and torch.isfinite(got16).all()):
        raise AssertionError(f"generate models: {row}")
    return unet, vae, ehs.to("cuda")


def step_flops(unet, ehs, lat_shape, cond_shape) -> int:
    """The operations of one denoiser step (write + read pass) at the
    published shapes, counted by ``FlopCounterMode`` on fake tensors, as
    ``Predictor.cost_analysis`` counts them; nothing runs on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from surya_tpu_torch.models.diffusion import (
        EulerAncestralSchedule,
        reference_conditioned_denoiser,
    )

    schedule = EulerAncestralSchedule.create(
        GEN_STEPS, timestep_spacing="trailing",
        prediction_type="v_prediction")
    schedule.sigma(0, ehs)    # the table as a real tensor, made first
    counter = FlopCounterMode(display=False)
    with (torch.inference_mode(),
          FakeTensorMode(allow_non_fake_inputs=True), counter):
        cond = torch.empty(cond_shape, device="cuda")
        denoiser = reference_conditioned_denoiser(
            unet, schedule, ehs, cond,
            cond_noise=lambda i: torch.empty(cond_shape, device="cuda"))
        denoiser(torch.empty(lat_shape, device="cuda"),
                 torch.empty((), device="cuda"), 0)
    return counter.get_total_flops()


@contextlib.contextmanager
def labelled_ops():
    """Inside: the UNet's attention core (the two products and the
    softmax), every GroupNorm and every conv run under a
    ``record_function`` range, so a profile attributes their kernels."""
    from torch.profiler import record_function

    from surya_tpu_torch.models import norms
    from surya_tpu_torch.models.backbones import resnet
    from surya_tpu_torch.models.diffusion import unet_cond

    def labelled(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    saved = (unet_cond.attention, norms.GroupNorm.forward,
             resnet.Conv.forward)
    unet_cond.attention = labelled("split::attention", saved[0])
    norms.GroupNorm.forward = labelled("split::group_norm", saved[1])
    resnet.Conv.forward = labelled("split::conv", saved[2])
    try:
        yield
    finally:
        (unet_cond.attention, norms.GroupNorm.forward,
         resnet.Conv.forward) = saved


def step_split(unet, ehs, lat_shape, cond_shape) -> dict:
    """One profiled denoiser step (write + read pass) at the published
    shapes: device ms of the convolutions, the attention core and the
    GroupNorms (the kernels launched inside each labelled range), and of
    every kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from surya_tpu_torch.models.diffusion import (
        EulerAncestralSchedule,
        reference_conditioned_denoiser,
    )

    schedule = EulerAncestralSchedule.create(
        GEN_STEPS, timestep_spacing="trailing",
        prediction_type="v_prediction")
    g = torch.Generator("cuda").manual_seed(1)
    cond = torch.randn(cond_shape, generator=g, device="cuda")
    lat = torch.randn(lat_shape, generator=g, device="cuda")
    denoiser = reference_conditioned_denoiser(unet, schedule, ehs, cond,
                                              generator=g)
    t = schedule.table("timesteps", "cuda")[0]
    with torch.inference_mode(), labelled_ops():
        denoiser(lat, t, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            denoiser(lat, t, 0)
            torch.cuda.synchronize()
    split = {"conv": 0.0, "attention": 0.0, "group_norm": 0.0}
    for e in prof.events():
        if (e.device_type == DeviceType.CPU
                and e.name.startswith("split::")):
            split[e.name.removeprefix("split::")] += e.device_time_total / 1e3
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3
    return {"device_ms": busy, "ms": split,
            "share": {k: (v / busy if busy else None)
                      for k, v in split.items()}}


def device_spans(prof) -> list:
    """A profile's device intervals (kernels, copies, sets) as sorted
    (start, end) ns pairs, read from its Kineto events: building the
    ``FunctionEvent`` tree of one image's ≈ 333,000 kernels takes 40 s."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation())


def busy_ms(spans) -> float:
    """The union of sorted (start, end) ns intervals, in ms: the time the
    card was doing something."""
    total, reach = 0, None
    for start, end in spans:
        if reach is None or end > reach:
            total += end - (start if reach is None else max(start, reach))
            reach = end
    return total / 1e6


@contextlib.contextmanager
def vae_marks(vae):
    """Inside: every ``vae.encode`` and ``vae.decode`` call is bracketed by
    CUDA events on the stream (no synchronisation). → the list of
    (name, start event, end event), in call order."""
    marks = []

    def marked(name, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((name, start, end))
            return out
        return call

    vae.encode = marked("encode", vae.encode)   # shadows the method
    vae.decode = marked("decode", vae.decode)
    try:
        yield marks
    finally:
        del vae.encode, vae.decode


def gen_trajectory(unet, vae, ehs, clean, card):
    """The published trajectory, bf16 on the card:
    ``zero123plus_unet_generate_fn`` (320-px tile, 3×2 grid, 75 steps,
    seed 0) through ``process_augmentation`` on the first clean PNG of
    each label: 12 finite views of 320×320, then a resumed run that
    generates none. Seconds per image and its spans (VAE encode, the
    denoising, VAE decode on the card's timeline; ``to_image`` and the
    PNG reads and writes on the host's), UNet forwards/s and the implied
    TFLOP/s over the denoising span, peak memory, the flops of a step,
    one profiled step's split; then one more generation traced whole,
    for the card's busy time and idle share over that call."""
    import shutil

    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from surya_tpu_torch.augmentgen import multiview

    src = os.path.join(GEN_DIR, "clean_two", "train")
    for _, label in GEN_CLIPS:
        os.makedirs(os.path.join(src, label), exist_ok=True)
        first = sorted(os.listdir(os.path.join(clean, "train", label)))[0]
        shutil.copy(os.path.join(clean, "train", label, first),
                    os.path.join(src, label, first))
    out = os.path.join(GEN_DIR, "views_zero123plus")

    def generator(seed):
        return multiview.zero123plus_unet_generate_fn(
            unet, vae, ehs, num_steps=GEN_STEPS, tile=GEN_TILE,
            rows=GEN_ROWS, cols=GEN_COLS, seed=seed)

    gen = generator(0)
    finite, gen_s, to_image_s = [], [], []
    to_image = multiview.to_image

    def checked(pixels):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finite.append(bool(torch.isfinite(pixels).all()))
        img = to_image(pixels)
        to_image_s.append(time.perf_counter() - t0)
        return img

    def timed(image):
        t0 = time.perf_counter()
        grid = gen(image)            # ends in to_image's copy to the host
        gen_s.append(time.perf_counter() - t0)
        return grid

    multiview.to_image = checked
    try:
        with vae_marks(vae) as marks:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            report = multiview.process_augmentation(
                os.path.dirname(src), out, generate_fn=timed,
                num_steps=GEN_STEPS, rows=GEN_ROWS, cols=GEN_COLS,
                splits=("train",))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
        again = multiview.process_augmentation(
            os.path.dirname(src), out, generate_fn=timed, rows=GEN_ROWS,
            cols=GEN_COLS, splits=("train",))
    finally:
        multiview.to_image = to_image
    views = []
    for _, label in GEN_CLIPS:
        for name in sorted(os.listdir(os.path.join(out, "train", label))):
            with Image.open(os.path.join(out, "train", label, name)) as im:
                views.append((name, im.size))
    # per image: encode, then the denoising up to decode, then decode
    names = [m[0] for m in marks]
    if names != ["encode", "decode"] * GEN_IMAGES:
        raise AssertionError(f"VAE calls {names}")
    encode_ms = [s.elapsed_time(e) for n, s, e in marks if n == "encode"]
    decode_ms = [s.elapsed_time(e) for n, s, e in marks if n == "decode"]
    denoise_ms = [marks[k][2].elapsed_time(marks[k + 1][1])
                  for k in range(0, len(marks), 2)]
    denoise_s = sum(denoise_ms) / 1e3

    factor = 2 ** (len(vae.config.block_out_channels) - 1)
    lat_shape = (1, GEN_ROWS * GEN_TILE // factor,
                 GEN_COLS * GEN_TILE // factor, 4)
    cond_shape = (1, GEN_TILE // factor, GEN_TILE // factor, 4)
    flops = step_flops(unet, ehs, lat_shape, cond_shape)
    split = step_split(unet, ehs, lat_shape, cond_shape)

    # one more generation (the first image, seed 1), traced whole: the
    # card's busy time against the call's wall time
    with Image.open(os.path.join(
            src, GEN_CLIPS[0][1],
            os.listdir(os.path.join(src, GEN_CLIPS[0][1]))[0])) as im:
        image = im.convert("RGB")
    traced = generator(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced(image)                # ends in to_image's copy to the host
        traced_ms = (time.perf_counter() - t0) * 1e3
    spans = device_spans(prof)
    busy = busy_ms(spans)
    trace = {"wall_ms": traced_ms, "busy_ms": busy,
             "idle_share": 1.0 - busy / traced_ms,
             "device_events": len(spans),
             "first_to_last_device_ms":
                 (max(e for _, e in spans) - spans[0][0]) / 1e6
                 if spans else None,
             "vs_untraced_call": traced_ms / (gen_s[-1] * 1e3)}

    forwards = 2 * GEN_STEPS * GEN_IMAGES
    row = {"phase": "generate_zero123plus", "dtype": "bfloat16",
           "tile": GEN_TILE, "grid": [GEN_ROWS, GEN_COLS],
           "latent_hw": list(lat_shape[1:3]), "steps": GEN_STEPS,
           "images": GEN_IMAGES, "report": report, "resumed": again,
           "views": len(views), "finite": finite, "wall_s": wall,
           "s_per_image": wall / GEN_IMAGES,
           "spans_ms_by_image": {
               "vae_encode": encode_ms, "denoise": denoise_ms,
               "vae_decode": decode_ms,
               "to_image": [x * 1e3 for x in to_image_s],
               "generate_call": [x * 1e3 for x in gen_s]},
           "png_io_ms_per_image": (wall - sum(gen_s)) / GEN_IMAGES * 1e3,
           "unet_forwards_per_s": forwards / denoise_s,
           "peak_memory_bytes": peak, "flops_per_step": flops,
           "implied_tflop_s": flops * GEN_STEPS * GEN_IMAGES / denoise_s
           / 1e12,
           "profiled_step": split, "traced_image": trace, **card}
    row["implied_share_of_989_tflop_s"] = row["implied_tflop_s"] / 989.0
    emit(row)
    n_views = GEN_IMAGES * GEN_ROWS * GEN_COLS
    if not (report["train"]["generated"] == GEN_IMAGES
            and again["train"] == {"generated": 0, "skipped": GEN_IMAGES,
                                   "views_per_image": GEN_ROWS * GEN_COLS}
            and len(views) == n_views
            and all(s == (GEN_TILE, GEN_TILE) for _, s in views)
            and finite == [True] * GEN_IMAGES
            and 0.0 < busy <= traced_ms
            and len(gen_s) == len(to_image_s) == GEN_IMAGES):
        raise AssertionError(f"zero123plus trajectory: {row} {views}")
    return row


def gen_tiny(clean, card):
    """The pixel-space path: ``torch_diffusion_generate_fn`` (TinyDenoiser
    from seed 0, the same 3×2 grid of 320-px tiles, 75 steps) over all 12
    clean PNGs: 72 views; seconds per image. → the view tree."""
    from surya_tpu_torch.augmentgen import multiview

    out = os.path.join(GEN_DIR, "views_tiny")
    gen = multiview.torch_diffusion_generate_fn(
        num_steps=GEN_STEPS, tile=GEN_TILE, rows=GEN_ROWS, cols=GEN_COLS,
        seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = multiview.process_augmentation(
        clean, out, generate_fn=gen, num_steps=GEN_STEPS, rows=GEN_ROWS,
        cols=GEN_COLS, splits=("train",))
    wall = time.perf_counter() - t0
    n = len(GEN_CLIPS) * GEN_FRAMES
    views = sum(len(os.listdir(os.path.join(out, "train", label)))
                for _, label in GEN_CLIPS)
    row = {"phase": "generate_tiny", "tile": GEN_TILE, "steps": GEN_STEPS,
           "images": n, "report": report, "views": views, "wall_s": wall,
           "s_per_image": wall / n, **card}
    emit(row)
    if not (report["train"]["generated"] == n
            and views == n * GEN_ROWS * GEN_COLS):
        raise AssertionError(f"TinyDenoiser path: {row}")
    return out


def hold_head_train(calls, fusion_head):
    """Each recorded launch of the head's training form against its plain
    version on the same inputs, the keep mask rebuilt from the launch's
    own seed (Philox), to bf16's TOL."""
    def plain(x, w1, b1, w2, b2, *, rate, seed, row_offset=0):
        keep = (fusion_head.philox_bits(int(seed.reshape(-1)[0]),
                                        x.shape[0], w1.shape[0], x.device,
                                        row_offset)
                >= fusion_head.dropout_threshold(rate))
        return fusion_head.fusion_head_plain(
            x.float(), w1.to(x.dtype).float(), b1.float(),
            w2.to(x.dtype).float(), b2.float(), rate, keep)

    failed = []
    with torch.inference_mode():
        row = _hold("fusion_head_train", calls["fusion_head"], plain, failed,
                    train=True)
    if failed or calls["quadrant"]:
        raise AssertionError(f"the chain's head launches: {row} {failed}")
    return row


def gen_chain(views, clean, quadrant, fusion_head, card):
    """The counterpart of ``tests/test_multiview_integration.py`` on the
    card: the clean frames copied in as view 00, ``build_sequence_dataset``
    (T 4, stride 2, 224 px) with seeded 47-feature ``.npy`` files: 2
    windows × 7 views × 2 labels = 28 train windows; two ``cnn-lstm``
    train steps at batch 16 (bf16, dropout 0.5), every launch counted and
    each of the head's held against its plain version. → the head's
    launches by form."""
    import shutil

    from surya_tpu_torch.core.config import get_preset
    from surya_tpu_torch.data.sequences import (
        SequenceDataSource,
        build_sequence_dataset,
    )
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.train import create_train_state, make_train_step
    from surya_tpu_torch.train.steps import to_device

    rng = np.random.default_rng(0)
    flat = os.path.join(GEN_DIR, "flat")
    for _, label in GEN_CLIPS:
        os.makedirs(os.path.join(flat, "train", label), exist_ok=True)
        for name in os.listdir(os.path.join(clean, "train", label)):
            base = os.path.splitext(name)[0]
            shutil.copy(os.path.join(clean, "train", label, name),
                        os.path.join(views, "train", label,
                                     f"{base}_view_00.png"))
            clip, frame = base.split("_frame_")
            np.save(os.path.join(flat, "train", label,
                                 f"{clip}_frame_{frame}_frame_{frame}.npy"),
                    rng.normal(size=47).astype(np.float32))
    cfg = get_preset("cnn-lstm").override({
        "data.batch_size": str(CHAIN_BATCH), "model.num_classes": "2",
        "data.seq_root": os.path.join(GEN_DIR, "seq")})
    size = cfg.data.image_size
    t0 = time.perf_counter()
    counts = build_sequence_dataset(views, flat, cfg.data.seq_root,
                                    seq_len=CHAIN_T, stride=CHAIN_STRIDE,
                                    image_size=size, splits=("train",))
    build_s = time.perf_counter() - t0
    want = 2 * (GEN_ROWS * GEN_COLS + 1) * len(GEN_CLIPS)
    if counts != {"train": want}:
        raise AssertionError(f"sequence windows: {counts}, want {want}")
    data = SequenceDataSource(cfg.data, splits=("train",),
                              pin_memory=True)
    model = get_model(cfg.model, image_size=size, seed=0)
    state, tx = create_train_state(model, cfg, device="cuda")
    step = make_train_step(model, tx, cfg)
    # 28 windows make one full batch of 16 an epoch (the rest is dropped)
    batches = (b for epoch in range(CHAIN_STEPS)
               for b in data.train_batches(epoch))
    losses = []
    with recording_kernels() as calls:
        reset_launches(quadrant, fusion_head)
        for i in range(CHAIN_STEPS):
            batch = data.device_transform(
                "train", torch.Generator("cuda").manual_seed(i),
                to_device(next(batches), "cuda"))
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        launches = read_launches(quadrant, fusion_head)
    held = hold_head_train(calls, fusion_head)
    row = {"phase": "generate_chain", "windows": counts, "seq_len": CHAIN_T,
           "stride": CHAIN_STRIDE, "image_size": size,
           "build_sequence_dataset_s": build_s, "batch": CHAIN_BATCH,
           "steps": CHAIN_STEPS, "losses": losses, "launches": launches,
           "head_train_vs_plain": held, **card}
    emit(row)
    if not (np.isfinite(losses).all()
            and launches == {"quadrant": 0, "quadrant_train": 0,
                             "fusion_head": 0,
                             "fusion_head_train": CHAIN_STEPS}
            and held["calls"] == CHAIN_STEPS
            and held["shape"] == [CHAIN_BATCH, 256]):
        raise AssertionError(f"the chain: {row}")
    return launches


def generate_phase(quadrant, fusion_head, card):
    """U²-Net background removal → the zero123plus UNet and SD VAE checked
    against the CPU → the published 75-step trajectory → the TinyDenoiser
    path → sequence windows → two ``cnn-lstm`` train steps. → the chain's
    launches per kernel form."""
    import shutil

    shutil.rmtree(GEN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    clean = gen_u2net(card)
    torch.cuda.empty_cache()
    unet, vae, ehs = gen_models(card)
    torch.cuda.empty_cache()
    traj = gen_trajectory(unet, vae, ehs, clean, card)
    del unet, vae
    torch.cuda.empty_cache()
    views = gen_tiny(clean, card)
    launches = gen_chain(views, clean, quadrant, fusion_head, card)
    emit({"phase": "generate_summary", "seconds": time.perf_counter() - t0,
          "s_per_image": traj["s_per_image"],
          "unet_forwards_per_s": traj["unet_forwards_per_s"],
          "peak_memory_bytes": traj["peak_memory_bytes"],
          "launches": launches, **card})
    return launches


# ---------------------------------------------------------------------------
# parallel: the mesh, DP, ZeRO-1, FSDP2 and TP (core/mesh.py, parallel/)
# ---------------------------------------------------------------------------

PARALLEL_BATCH, PARALLEL_F32_BATCH = 256, 16   # global rows; f32 with TF32 off
PARALLEL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the f32 gradients' relative L2 (dp2's merged BN statistics round apart
# from one process's and flip ReLU masks of pre-activations within ~1e-7
# of 0, as tests/test_torch_parallel.py holds the trunk's); bf16's are
# reported only: its activations round at 2^-8
PARALLEL_GRAD_TOL = 2e-2


def start_torchrun(nproc: int, args: list):
    """``torchrun --standalone --nproc-per-node=N ARGS`` from the
    repository, started (``torch.distributed.run``, the same launcher)."""
    return start_child([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", f"--nproc-per-node={nproc}", *args])


def parallel_spec(dtype: str, batch: int, mesh: dict) -> dict:
    return {"dtype": dtype, "batch": batch, "mesh": mesh}


def parallel_config(spec: dict):
    from surya_tpu_torch.core.config import get_preset

    return get_preset("quadtree-fusion").override({
        "model.compute_dtype": spec["dtype"],
        **{f"train.{k}": "true" for k in ("zero1", "fsdp") if spec.get(k)}})


def parallel_step(spec: dict, mesh=None, record=False) -> dict:
    """The flagship (seed 0, 224 px, dropout 0.5) on this rank's rows of a
    seeded global batch: a train-mode forward's logits, then one train step
    → logits, loss, accuracy, BN running statistics and parameters after
    the step, gathered to the single-device form (rank 0 of a mesh); with
    ``record``, every kernel call the two run held against its plain
    version."""
    from surya_tpu_torch.core.checkpoint import snapshot
    from surya_tpu_torch.core.mesh import batch_rows, shard_batch
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.ops.cuda import fusion_head, quadrant
    from surya_tpu_torch.train import create_train_state, make_train_step

    cfg = parallel_config(spec)
    model = get_model(cfg.model, image_size=cfg.data.image_size, seed=0)
    state, tx = create_train_state(model, cfg, mesh=mesh)
    step = make_train_step(model, tx, cfg, mesh=mesh)
    batch = train_batch(cfg, spec["batch"], seed=5)
    rows = None
    if mesh is not None and mesh.distributed:
        rows = mesh.row_shard(spec["batch"])
        batch = shard_batch(mesh, batch)
    batch = tuple(torch.from_numpy(a).cuda() for a in batch)
    buffers = [b.clone() for b in model.buffers()]
    quadrant.launches = fusion_head.launches = 0
    quadrant.training_launches = fusion_head.training_launches = 0
    rec = recording_kernels() if record else contextlib.nullcontext({})
    with rec as calls:
        model.train()
        with torch.no_grad(), batch_rows(rows):
            logits = model(batch[0], batch[1], torch.Generator(
                "cuda").manual_seed(11)).float()
        torch._foreach_copy_(list(model.buffers()), buffers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch,
                              torch.Generator("cuda").manual_seed(12))
        loss = float(metrics["loss"])
        step_s = time.perf_counter() - t0
    launches = {"quadrant": quadrant.launches,
                "quadrant_train": quadrant.training_launches,
                "fusion_head": fusion_head.launches,
                "fusion_head_train": fusion_head.training_launches}
    snap = snapshot(state)   # a collective on a mesh: before the holds
    held = (hold_parallel(calls, quadrant, fusion_head,
                          getattr(torch, spec["dtype"])) if record else None)
    return {"logits": logits.cpu(), "loss": loss,
            "rows": None if rows is None else rows.spans,
            "accuracy": float(metrics["accuracy"]), "model": snap["model"],
            "optimizer": snap["optimizer"],
            "launches": launches, "held": held, "step_s": step_s}


def hold_parallel(calls, quadrant, fusion_head, dtype=torch.bfloat16):
    """Every kept kernel call of a parallel run against its plain version
    on its own inputs (the head's dropout mask rebuilt from the call's
    seed and row offset), to TOL of its dtype: ``dtype`` on the card, and
    every head call with dropout 0.5 (a train-mode forward and the
    step)."""
    def head_plain(x, w1, b1, w2, b2, *, rate, seed, row_offset=0):
        keep = (fusion_head.philox_bits(
            int(seed.reshape(-1)[0]), x.shape[0], w1.shape[0], x.device,
            row_offset) >= fusion_head.dropout_threshold(rate))
        return fusion_head.fusion_head_plain(
            x.float(), w1.to(x.dtype).float(), b1.float(),
            w2.to(x.dtype).float(), b2.float(), rate, keep)

    def quadrant_plain(x, w, b, **_):
        return quadrant.quadrant_process_plain(
            x.float(), w.to(x.dtype).float(), b.float())

    failed = []
    with torch.inference_mode():
        held = {"quadrant": _hold("quadrant", calls["quadrant"],
                                  quadrant_plain, failed, dtype=dtype),
                "fusion_head": _hold("fusion_head", calls["fusion_head"],
                                     head_plain, failed, train=True,
                                     dtype=dtype)}
    if failed or not all(row["calls"] for row in held.values()):
        raise AssertionError(f"parallel kernel holds: {held} {failed}")
    return held


PARALLEL_RUNS = {
    "dp2_bf16": {**parallel_spec("bfloat16", PARALLEL_BATCH, {"data": 2})},
    "dp2_f32": {**parallel_spec("float32", PARALLEL_F32_BATCH,
                                {"data": 2})},
    "tp2_bf16": {**parallel_spec("bfloat16", PARALLEL_BATCH,
                                 {"data": 1, "model": 2}), "record": True}}


def parallel_gloo_child(out_dir: str) -> None:
    """One of two ranks on the one card (``torchrun --nproc-per-node=2``),
    over gloo with CUDA tensors (NCCL refuses two ranks on one device):
    each of ``PARALLEL_RUNS`` → ``rank<r>.pt`` in ``out_dir``."""
    import torch.distributed as dist

    from surya_tpu_torch.core import mesh as cmesh

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo")
    out = {}
    for name, spec in PARALLEL_RUNS.items():
        mesh = cmesh.create_mesh(cmesh.MeshSpec(**spec["mesh"]), "cuda")
        before = dict(cmesh.collective_bytes)
        out[name] = parallel_step(spec, mesh, record=spec.get("record"))
        out[name]["bytes"] = {k: cmesh.collective_bytes[k] - before[k]
                              for k in before}
        dist.barrier()
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


def _median_ms(fn, reps=10, warmup=3):
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def parallel_nccl_child(out_file: str) -> None:
    """One NCCL rank (``torchrun --nproc-per-node=1``): the flagship's
    batch-256 bf16 step without a mesh and on the world-1 mesh (its
    gradient all-reduce and metric all-reduce), in turns; the bytes one DP
    step all-reduces; forward + backward with the global-batch BN path
    against the fused one; peak memory of a step with and without fsdp."""
    import torch.distributed as dist

    from surya_tpu_torch.core import mesh as cmesh
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.models.losses import cross_entropy
    from surya_tpu_torch.train import create_train_state, make_train_step

    cmesh.maybe_initialize_distributed()
    mesh = cmesh.create_mesh(device="cuda")
    spec = parallel_spec("bfloat16", TRAIN_BATCH, {})
    cfg = parallel_config(spec)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in train_batch(cfg, TRAIN_BATCH))
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    runs = {}
    for name, m in (("plain", None), ("dp", mesh)):
        model = get_model(cfg.model, image_size=cfg.data.image_size, seed=0)
        state, tx = create_train_state(model, cfg, mesh=m)
        runs[name] = (model, state, make_train_step(model, tx, cfg, mesh=m))
    ms = {"plain": [], "dp": []}
    for _ in range(3):   # in turns
        for name, (_, state, step) in runs.items():
            ms[name].append(_median_ms(lambda: step(state, batch), reps=5,
                                       warmup=2))
    out["step_ms"] = {k: statistics.median(v) for k, v in ms.items()}
    before = cmesh.collective_bytes["all_reduce"]
    runs["dp"][2](runs["dp"][1], batch)
    out["all_reduce_bytes_per_step"] = (cmesh.collective_bytes["all_reduce"]
                                        - before)

    model, state, _ = runs["plain"]
    model.train()
    world = cmesh.RowShard(TRAIN_BATCH, ((0, TRAIN_BATCH),),
                           dist.group.WORLD)

    def fwd_bwd(rows):
        state.optimizer.zero_grad(set_to_none=True)
        with cmesh.batch_rows(rows):
            loss = cross_entropy(model(batch[0], batch[1], state.generator),
                                 batch[2])
            loss.backward()

    bn = {"fused": [], "global": []}
    for _ in range(3):
        bn["fused"].append(_median_ms(lambda: fwd_bwd(None), reps=5,
                                      warmup=2))
        bn["global"].append(_median_ms(lambda: fwd_bwd(world), reps=5,
                                       warmup=2))
    out["fwd_bwd_ms"] = {k: statistics.median(v) for k, v in bn.items()}
    del runs, model, state
    peaks = {}
    for name, fsdp in (("dp", False), ("fsdp", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        c = parallel_config({**spec, "fsdp": fsdp})
        model = get_model(c.model, image_size=c.data.image_size, seed=0)
        state, tx = create_train_state(model, c, mesh=mesh)
        step = make_train_step(model, tx, c, mesh=mesh)
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        del model, state, tx, step
    out["peak_memory_bytes"] = peaks
    with open(out_file, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parallel over cards: the flagship's forms over NCCL, one card a rank
# ---------------------------------------------------------------------------

# the forms of __graft_entry__.py's dryrun_multichip: name → (ranks, mesh
# axes, ZeRO form); each runs in bf16 at global batch PARALLEL_BATCH and in
# f32 (TF32 off) at PARALLEL_F32_BATCH
PARALLEL_CARD_FORMS = {
    "dp2": (2, {"data": 2}, None),
    "dp4": (4, {"data": 4}, None),
    "dp2tp2": (4, {"data": 2, "model": 2}, None),
    "zero1_dp4": (4, {"data": 4}, "zero1"),
    "fsdp_dp4": (4, {"data": 4}, "fsdp"),
    "zero1_dp2tp2": (4, {"data": 2, "model": 2}, "zero1"),
    "fsdp_dp2tp2": (4, {"data": 2, "model": 2}, "fsdp")}
PREDICT_IMAGES = 128   # (c): one request served over dpN, bf16 (TOL)
COST_STEPS = 20        # a timed run: the median of steps 4-20


def card_worlds() -> list:
    """The NCCL jobs the cards allow, one card a rank: 2 ranks, and 4 on a
    machine of four or more cards."""
    return [w for w in (2, 4) if w <= torch.cuda.device_count()]


def _in_step(world: int) -> None:
    """Before a timed rep over several ranks: every rank's card idle and
    every rank there (a barrier), so no rank's time holds another's lag."""
    if world > 1:
        import torch.distributed as dist

        torch.cuda.synchronize()
        dist.barrier()


def step_ms(fn, steps=COST_STEPS, world=1) -> dict:
    """``steps`` calls of ``fn``, each timed by CUDA events after
    :func:`_in_step` → the median of steps 4 on, and every step's ms."""
    ms = []
    for _ in range(steps):
        _in_step(world)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return {"median": statistics.median(ms[3:]), "ms": ms}


def step_profile(fn, steps=5, world=1) -> dict:
    """``steps`` calls of ``fn`` under the profiler (each after
    :func:`_in_step`) → a step's wall ms (host clock, the card synchronised)
    and the card's ms a step: busy (the union of its device intervals),
    in NCCL's kernels (their union: they spin while a peer is late) and
    in the others; the idle, NCCL and other shares of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _in_step(world)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]

    def union(evs):
        return busy_ms(sorted((e.start_ns(), e.end_ns()) for e in evs))

    nccl = [e for e in events if "nccl" in e.name().lower()]
    out = {"wall_ms": 1e3 * wall / steps, "busy_ms": union(events) / steps,
           "nccl_ms": union(nccl) / steps,
           "other_ms": union([e for e in events if e not in nccl]) / steps}
    if not out["busy_ms"] > 0:
        raise AssertionError("the profiler recorded no device time")
    for k in ("busy", "nccl", "other"):
        out[f"{k}_share"] = out[f"{k}_ms"] / out["wall_ms"]
    out["idle_share"] = max(0.0, 1 - out["busy_share"])
    return out


def dp_costs(world: int) -> dict:
    """What the bf16 DP step of the flagship costs on this job's ``world``
    (≥ 2) cards, as this rank sees it: the step at global batch 256 and
    at 256 a card (:func:`step_ms`); the wall, busy, NCCL and idle shares
    of a profiled step at 256 (:func:`step_profile`); the bytes this rank
    hands to ``all_reduce`` in a step; forward + backward with the
    global-batch BN against the fused BN of this rank's rows alone, in
    turns; at four ranks, peak memory of two steps with plain DP, ZeRO-1
    and FSDP2, and the dp2×tp2 step. One card's step is the ``train``
    phase's (the DP step at one rank is the plain one: ``nccl_one_rank``'s
    ``step_ms``)."""
    import gc

    from surya_tpu_torch.core import mesh as cmesh
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.models.losses import cross_entropy
    from surya_tpu_torch.train import create_train_state, make_train_step

    spec = parallel_spec("bfloat16", PARALLEL_BATCH, {})
    cfg = parallel_config(spec)
    full = train_batch(cfg, PARALLEL_BATCH * world, seed=5)

    def rows_of(mesh, n):   # this rank's rows of the first n of `full`
        return tuple(torch.from_numpy(a).cuda() for a in cmesh.shard_batch(
            mesh, tuple(a[:n] for a in full)))

    def build(c, mesh):
        model = get_model(c.model, image_size=c.data.image_size, seed=0)
        state, tx = create_train_state(model, c, mesh=mesh)
        return model, state, make_train_step(model, tx, c, mesh=mesh)

    dp = cmesh.create_mesh(cmesh.MeshSpec(data=world), "cuda")
    model, state, step = build(cfg, dp)
    batch = rows_of(dp, PARALLEL_BATCH)
    big = rows_of(dp, PARALLEL_BATCH * world)
    out = {"rows": len(batch[2]),
           "step_ms_global_256": step_ms(lambda: step(state, batch),
                                         world=world),
           "step_ms_256_a_card": step_ms(lambda: step(state, big),
                                         world=world)}
    del big
    before = cmesh.collective_bytes["all_reduce"]
    step(state, batch)
    out["all_reduce_bytes_per_step"] = (cmesh.collective_bytes["all_reduce"]
                                        - before)
    out["profile"] = step_profile(lambda: step(state, batch), world=world)
    median = out["step_ms_global_256"]["median"]

    model.train()
    rows = dp.row_shard(PARALLEL_BATCH)

    def fwd_bwd(r):
        state.optimizer.zero_grad(set_to_none=True)
        with cmesh.batch_rows(r):
            cross_entropy(model(batch[0], batch[1], state.generator),
                          batch[2]).backward()

    bn = {"fused_local": [], "global": []}
    for _ in range(3):   # in turns
        for name, r in (("fused_local", None), ("global", rows)):
            bn[name].append(step_ms(lambda: fwd_bwd(r), steps=8,
                                    world=world)["median"])
    bn = {k: statistics.median(v) for k, v in bn.items()}
    out["fwd_bwd_ms"] = {**bn, "global_bn_share_of_step": (
        bn["global"] - bn["fused_local"]) / median}
    del model, state, step, batch
    peaks = {}
    for name in ("dp", "zero1", "fsdp") if world == 4 else ():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        c = parallel_config({**spec, name: name != "dp"})
        model, state, step = build(c, dp)
        batch = rows_of(dp, PARALLEL_BATCH)
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        del model, state, step, batch
    out["peak_memory_bytes"] = peaks
    if world == 4:
        gc.collect()
        torch.cuda.empty_cache()
        mesh = cmesh.create_mesh(cmesh.MeshSpec(data=2, model=2), "cuda")
        model, state, step = build(cfg, mesh)
        batch = rows_of(mesh, PARALLEL_BATCH)
        out["dp2tp2_step_ms_global_256"] = step_ms(
            lambda: step(state, batch), world=world)
        del model, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _predict_over_cards(world: int) -> dict:
    """(c) The flagship from seed 0 served over a dp``world`` mesh
    (``Predictor(mesh=)``, bf16 weights, uint8 wire, batch 64): every rank
    returns the whole request's probabilities; rank 0 holds them against
    one card's ``Predictor`` (TOL of bf16, relative to the largest)."""
    import torch.distributed as dist

    from surya_tpu_torch.core import mesh as cmesh
    from surya_tpu_torch.infer.serve import Predictor
    from surya_tpu_torch.models import get_model

    cfg = parallel_config(parallel_spec("bfloat16", 0, {}))
    size = cfg.data.image_size
    sd = get_model(cfg.model, image_size=size, seed=0).state_dict()
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (PREDICT_IMAGES, size, size, 3), np.uint8)
    feats = rng.normal(size=(PREDICT_IMAGES, 47)).astype(np.float32)
    kw = dict(batch_size=64, image_size=size, param_dtype=torch.bfloat16,
              input_dtype="uint8")
    mesh = cmesh.create_mesh(cmesh.MeshSpec(data=world), "cuda")
    preds, probs = Predictor(cfg.model, sd, mesh=mesh, **kw).predict(
        images, feats)
    out = None
    if dist.get_rank() == 0:   # the reference's launches are not the path's
        from surya_tpu_torch.ops.cuda import fusion_head, quadrant

        counts = (quadrant.launches, fusion_head.launches)
        want_preds, want = Predictor(cfg.model, sd, **kw).predict(images,
                                                                  feats)
        quadrant.launches, fusion_head.launches = counts
        err, rel = compare(torch.from_numpy(probs), torch.from_numpy(want))
        out = {"images": PREDICT_IMAGES, "max_abs_err": err,
               "max_rel_err": rel, "tol": TOL["bfloat16"],
               "preds_agree": float((preds == want_preds).mean()),
               "shape": list(probs.shape)}
    dist.barrier()
    return out


def parallel_card_child(out_file: str) -> None:
    """One NCCL rank a card (``torchrun --nproc-per-node=W``, W 2 or 4).
    (a) Rank 0 first takes the one-process step on its card for each
    dtype; then every rank runs each form of ``PARALLEL_CARD_FORMS`` of W
    ranks (:func:`parallel_step`: a train-mode forward and one step, every
    kernel call held against its plain version), and rank 0 holds the
    gathered state, the loss and every rank's logits against the
    one-process step. (c) At the largest W the cards allow,
    :func:`_predict_over_cards`. Then :func:`dp_costs`. Rank 0 writes the
    record; a form that fails is recorded and the child goes on, then
    exits 1."""
    from surya_tpu_torch.core import mesh as cmesh
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.train.steps import trainable_mask

    os.environ.update(NCCL_DEBUG="INFO",
                      NCCL_DEBUG_SUBSYS="INIT,P2P,SHM,NET",
                      NCCL_DEBUG_FILE=f"{out_file}.nccl.%p")
    dist = _fact_child_setup("nccl")
    world, rank = dist.get_world_size(), dist.get_rank()
    specs = {"bfloat16": parallel_spec("bfloat16", PARALLEL_BATCH, {}),
             "float32": parallel_spec("float32", PARALLEL_F32_BATCH, {})}
    refs = {d: parallel_step(s) for d, s in specs.items()} if rank == 0 \
        else {}
    cfg = parallel_config(specs["bfloat16"])
    names = [n for n, t in trainable_mask(
        get_model(cfg.model, image_size=64), cfg.model.name,
        cfg.model.freeze_backbone).items() if t]
    dist.barrier()
    # this rank's launches on the path (the references' are not):
    # parallel_step counts each form's from 0
    tally = dict.fromkeys(launch_counts(), 0)
    out = {"backend": dist.get_backend(), "world": world, "forms": {},
           "failed": []}
    meshes = {}
    for name, (ranks, axes, zero) in PARALLEL_CARD_FORMS.items():
        if ranks != world:
            continue
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = cmesh.create_mesh(cmesh.MeshSpec(**axes), "cuda")
        for dtype, spec in specs.items():
            label = f"{name}_{'bf16' if dtype == 'bfloat16' else 'f32'}"
            moved0 = dict(cmesh.collective_bytes)
            got, fault = None, None
            try:
                got = parallel_step({**spec, "mesh": axes,
                                     **({zero: True} if zero else {})},
                                    meshes[key], record=True)
            except AssertionError as e:   # a kernel call that did not hold
                fault = str(e)[:2000]
            mine = {"fault": fault,
                    "bytes": {k: cmesh.collective_bytes[k] - moved0[k]
                              for k in moved0}}
            if got is not None:
                mine.update({k: got[k] for k in ("logits", "rows", "held",
                                                 "launches", "loss")})
                for k in ("quadrant", "fusion_head"):
                    n, t = got["launches"][k], got["launches"][f"{k}_train"]
                    tally[k] += n - t
                    tally[f"{k}_train"] += t
            every = [None] * world
            dist.all_gather_object(every, mine)
            if rank == 0:
                out["forms"][label] = row = _card_form_row(
                    got, every, refs[dtype], names, cfg.train.lr)
                if row["faults"] or parallel_failed(row, dtype):
                    out["failed"].append(label)
            del got
            torch.cuda.empty_cache()
    before = launch_counts()
    if world == max(card_worlds()):
        out["predictor"] = _predict_over_cards(world)
        if rank == 0 and not (
                out["predictor"]["max_rel_err"] <= TOL["bfloat16"]):
            out["failed"].append("predictor")
    out["costs"] = [None] * world
    dist.all_gather_object(out["costs"], dp_costs(world))
    mine = {k: tally[k] + v - before[k] for k, v in launch_counts().items()}
    out["launches_by_rank"] = [None] * world
    dist.all_gather_object(out["launches_by_rank"], mine)
    if rank == 0:
        out["links"] = card_links(out_file)
        with open(out_file, "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    if out["failed"]:
        sys.exit(1)


def card_links(out_file: str) -> dict:
    """How the cards reach each other: CUDA peer access between every
    pair, and the transports NCCL's INIT log (``NCCL_DEBUG_FILE``) names
    for its channels (e.g. ``P2P/CUMEM``, ``SHM``)."""
    import glob
    import re

    n = torch.cuda.device_count()
    via = {}
    for path in glob.glob(f"{out_file}.nccl.*"):
        with open(path, errors="replace") as f:
            for line in f:
                m = re.search(r" via (\S+)", line)
                if m:
                    via[m.group(1)] = via.get(m.group(1), 0) + 1
    return {"peer_access": [[i == j or torch.cuda.can_device_access_peer(
                i, j) for j in range(n)] for i in range(n)],
            "nccl_via": via}


def _card_form_row(got, every, ref, names, lr) -> dict:
    """Rank 0's record of one form: :func:`parallel_errors` of its gathered
    state, the logits error the largest over every rank's rows, and each
    rank's held kernel calls, launches and bytes."""
    def ref_rows(spans):
        return (ref["logits"] if spans is None else
                torch.cat([ref["logits"][a:b] for a, b in spans]))

    row = {"faults": [(r, e["fault"]) for r, e in enumerate(every)
                      if e["fault"]]}
    if got is not None and not row["faults"]:
        row.update(parallel_errors(got, ref, got["logits"],
                                   ref_rows(got["rows"]), names, lr))
        row["logits"] = max(compare(e["logits"], ref_rows(e["rows"]))[1]
                            for e in every)
        row["losses_equal"] = len({e["loss"] for e in every}) == 1
        if not row["losses_equal"]:
            row["faults"].append((None, "ranks report other losses"))
    for key in ("held", "launches", "bytes"):
        row[key] = [e.get(key) for e in every]
    return row


def card_guard(quadrant, fusion_head, stem_bn) -> dict:
    """(d) With device 0 current, each kernel form on tensors of every
    other card, at the shapes a dp4 rank gives it (B 64; the stem map of
    64 images), against its plain version on that card to TOL of bf16:
    each output must lie on its input's card and device 0 stay current.
    The wrappers' counters are put back: these launches compare."""
    counts = (quadrant.launches, quadrant.training_launches,
              fusion_head.launches, fusion_head.training_launches,
              dict(stem_bn.launches))
    rows, failed = {}, []
    bf = torch.bfloat16
    try:
        for i in range(1, torch.cuda.device_count()):
            dev = torch.device("cuda", i)
            fmap, kernel, bias = (t.to(dev) for t in quadrant_inputs(
                64, 14, 256, 128, bf, seed=i))
            x, w1, b1, w2, b2 = (t.to(dev) for t in head_inputs(
                64, 5376, 2688, 8, bf, seed=i))
            rng = np.random.default_rng(i)
            stem = torch.from_numpy((rng.normal(size=(64, 112, 112, 64)) * 3
                                     + 0.5).astype(np.float32)).to(dev, bf)
            a = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(
                np.float32)).to(dev)
            b = torch.from_numpy(rng.normal(size=64).astype(
                np.float32)).to(dev)
            keep = fusion_head.philox_bits(
                1234, 64, 2688, dev, 64 * i) >= fusion_head.dropout_threshold(
                0.5)
            plain_head = fusion_head.fusion_head_plain(
                x.float(), w1.float(), b1, w2.float(), b2, 0.5, keep,
                with_h=True)
            pairs = {
                "quadrant": (quadrant.quadrant_process(fmap, kernel, bias),
                             quadrant.quadrant_process_plain(
                                 fmap.float(), kernel.float(), bias)),
                "quadrant_train": (
                    quadrant.quadrant_process_with_act(fmap, kernel, bias),
                    quadrant.quadrant_process_plain(
                        fmap.float(), kernel.float(), bias, with_act=True)),
                "fusion_head": (fusion_head.fusion_head(x, w1, b1, w2, b2),
                                fusion_head.fusion_head_plain(
                                    x.float(), w1.float(), b1, w2.float(),
                                    b2)),
                "fusion_head_train": (fusion_head.fusion_head_with_h(
                    x, w1, b1, w2, b2, rate=0.5, seed=1234,
                    row_offset=64 * i), plain_head),
                "channel_stats": (stem_bn.channel_stats(stem),
                                  stem_bn.channel_stats_plain(stem)),
                "affine_relu": (stem_bn.affine_relu(stem, a, b),
                                stem_bn.affine_relu_plain(stem, a, b))}
            torch.cuda.synchronize(dev)
            for kname, (got, want) in pairs.items():
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                rel = max(compare(g, w)[1] for g, w in zip(got, want))
                on = all(g.device == dev for g in got)
                rows[f"{kname}_cuda{i}"] = {"max_rel_err": rel,
                                            "on_its_card": on}
                if not (on and rel <= TOL["bfloat16"]):
                    failed.append(f"{kname} on cuda:{i}")
            if torch.cuda.current_device() != 0:
                failed.append(f"device {torch.cuda.current_device()} "
                              f"current after cuda:{i}")
    except RuntimeError as e:   # a launch the runtime refused
        failed.append(str(e)[:500])
    finally:
        (quadrant.launches, quadrant.training_launches, fusion_head.launches,
         fusion_head.training_launches) = counts[:4]
        stem_bn.launches.update(counts[4])
    return {"rows": rows, "failed": failed}


def _param_errors(got, want, names, lr):
    """The state after one AdamW step against one process's. Adam's first
    update is lr·g/(|g| + 1e-8): ±lr whatever the gradient's scale, so the
    gradients are held through the first moments (0.1·g, relative L2 over
    all parameters) and the parameters per element: those whose gradient
    is resolved (larger than 10× the two runs' difference and than 1e-6)
    relative to the largest parameter, every element to 2·lr plus that;
    the unresolved share is reported."""
    g0 = torch.cat([want["optimizer"]["state"][i]["exp_avg"].reshape(-1)
                    for i in range(len(names))]).double()
    g1 = torch.cat([got["optimizer"]["state"][i]["exp_avg"].reshape(-1)
                    for i in range(len(names))]).double()
    p0 = torch.cat([want["model"][n].reshape(-1) for n in names]).double()
    p1 = torch.cat([got["model"][n].reshape(-1) for n in names]).double()
    g0, g1 = 10 * g0, 10 * g1
    loose = (g1 != g0) & ((g0.abs() < 10 * (g1 - g0).abs())
                          | (g0.abs() < 1e-6))
    d, scale = (p1 - p0).abs(), float(p0.abs().max())
    return {"grads": float((g1 - g0).norm() / g0.norm()),
            "params": float(torch.where(loose, 0.0, d).max()) / scale,
            "params_beyond_2lr": max(0.0, float(d.max()) - 2 * lr) / scale,
            "unresolved_share": float(loose.double().mean())}


def parallel_errors(got, ref, logits, ref_logits, names, lr) -> dict:
    """A parallel run (its gathered state, and ``logits`` of the rows
    ``ref_logits`` holds) against the one-process step on the same global
    batch: the loss, logits and BN running statistics relative to the
    reference's largest, and :func:`_param_errors`."""
    row = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
           "logits": compare(logits, ref_logits)[1],
           "bn_stats": max(compare(got["model"][k], v)[1]
                           for k, v in ref["model"].items()
                           if "running" in k)}
    row.update(_param_errors(got, ref, names, lr))
    return row


def parallel_failed(row: dict, dtype: str) -> bool:
    """Beyond ``PARALLEL_TOL`` of ``dtype``; in f32 also the gradients
    beyond ``PARALLEL_GRAD_TOL`` or more than 5% of them unresolved."""
    bad = max(row[k] for k in ("loss", "logits", "bn_stats", "params",
                               "params_beyond_2lr")) > PARALLEL_TOL[dtype]
    if dtype == "float32":
        bad |= (row["grads"] > PARALLEL_GRAD_TOL
                or row["unresolved_share"] > 0.05)
    return bad


def _rank_lines(stdout: str) -> list:
    """The result lines of a ``torchrun`` job of the CLI: the JSON lines
    that carry every rank's launches (rank 0 prints them)."""
    return [json.loads(x) for x in stdout.splitlines()
            if x.startswith("{") and "kernel_launches_by_rank" in x]


def cards_cli(started, root, train_base, pack, n, serve):
    """(b) The CLI under ``torchrun --nproc-per-node=n``, one card a rank,
    a generator for :func:`parallel_phase`: ``started`` (the ZeRO-1 and
    FSDP2 trains of one epoch over dp``n``) is awaited; each must print
    one result line (rank 0 alone) and write one metrics record an epoch,
    with exact launches on every rank. Then, at once, ``eval`` of the
    ZeRO-1 checkpoint over dp``n`` (its test metrics those the train
    printed) and a ``--resume`` of the FSDP2 run to a second epoch (which
    must take up from epoch 0); each run's last checkpoint is served on
    one card (``serve``). → (record, faults, every rank's launches of
    every job)."""
    yield from until_done(started)
    runs, faults, record, launches = started.result(), [], {}, []
    steps = LOOP_SPLITS["train"] // 16
    evals = LOOP_SPLITS["valid"] // 16
    tests = LOOP_SPLITS["test"] // 16

    def held(label, stdout, want):
        lines = _rank_lines(stdout)
        if len(lines) != 1:
            faults.append(f"{label}: {len(lines)} result lines, not rank "
                          "0's one")
            return None
        by_rank = lines[0]["kernel_launches_by_rank"]
        launches.extend(by_rank)
        if len(by_rank) != n or any(
                r != {"quadrant": want, "fusion_head": want,
                      "channel_stats": 0, "affine_relu": 0}
                for r in by_rank):
            faults.append(f"{label}: launches {by_rank}, want {want} on "
                          f"each of {n} ranks")
        return lines[0]

    for form in runs:
        line = held(f"train {form}", runs[form][0],
                    {"training": steps, "inference": evals + tests})
        epochs = [r["epoch"] for r in epoch_records(
            os.path.join(root, f"{form}{n}"))]
        if epochs != [0]:
            faults.append(f"train {form}: epoch records {epochs}")
        record[form] = {"test": line and line["test"],
                        "seconds": runs[form][1]}
    fsdp_run = os.path.join(root, f"fsdp{n}")
    later = POOL.submit(finish, {
        "eval": start_torchrun(n, [
            "-m", "surya_tpu_torch", "eval",
            os.path.join(root, f"zero1{n}", "ckpt", "0.pt"), "--preset",
            "quadtree-fusion", f"--data.packed_dir={pack}",
            f"--mesh.data={n}"]),
        "resume": start_torchrun(n, [
            *train_base, "--train.epochs=2", "--out", fsdp_run,
            "--train.fsdp=true", f"--mesh.data={n}", "--resume"])},
        timeout=600)
    yield from until_done(later)
    runs = later.result()
    ev = held("eval zero1", runs["eval"][0],
              {"training": 0, "inference": tests})
    test = record["zero1"]["test"]
    if ev is not None and test is not None and not (
            ev["count"] == test["count"] == LOOP_SPLITS["test"]
            and abs(ev["accuracy"] - test["accuracy"]) <= 1 / ev["count"]
            and abs(ev["loss"] - test["loss"]) <= 1e-2 * test["loss"]):
        faults.append(f"eval zero1 {ev} against the train's {test}")
    record["zero1"].update(
        eval=ev and {k: ev[k] for k in ("loss", "accuracy", "count")},
        eval_seconds=runs["eval"][1],
        served=serve("zero1", os.path.join(root, f"zero1{n}", "ckpt")))
    resumed = held("resume fsdp", runs["resume"][0],
                   {"training": steps, "inference": evals + tests})
    with open(os.path.join(fsdp_run, "metrics.jsonl")) as f:
        resumes = [r for r in map(json.loads, f)
                   if r.get("event") == "resume"]
    epochs = [r["epoch"] for r in epoch_records(fsdp_run)]
    if [r["from_epoch"] for r in resumes] != [0] or epochs != [0, 1]:
        faults.append(f"resume fsdp: {resumes}, epoch records {epochs}")
    record["fsdp"].update(
        resumed_test=resumed and resumed["test"],
        resume_seconds=runs["resume"][1],
        served=serve("fsdp", os.path.join(fsdp_run, "ckpt")))
    return record, faults, launches


def parallel_phase(quadrant, fusion_head, card):
    """The port's parallel path. (a) The CLI as a user runs it under
    ``torchrun --nproc-per-node=1`` (one NCCL rank): ``train --preset
    quadtree-fusion`` for one epoch of the loop phase's synthetic pack with
    ``--train.zero1=true`` and with ``--train.fsdp=true`` (both at once),
    each child's kernel launches counted, each final checkpoint served by a
    one-device ``Predictor``. (b) Two ranks on the card over gloo with
    CUDA tensors: the dp2 step (bf16, global batch 256, dropout 0.5; and
    f32 at batch 16) against the one-process step on the global batch
    with the same generators (loss, logits, BN statistics, parameters),
    then model=2 with every kernel call held against its plain version.
    (c) One NCCL rank: the DP step against the plain one, bytes
    all-reduced, the global-batch BN's cost and fsdp's peak memory. With
    N ≥ 2 cards, over min(4, N) of them: the CLI under ``torchrun``
    (:func:`cards_cli`), the forms of ``PARALLEL_CARD_FORMS`` and
    ``Predictor`` over the cards
    (:func:`parallel_card_child`), and every kernel launched from here on
    each card but the current one (:func:`card_guard`); on one card a
    line names what was left out. A side-by-side phase
    (:func:`side_by_side`): the CLI runs and (b) run at once with the
    others; (c) and the card children, which are timed, alone at the end.
    → the kernel launches of (a), (b) and every rank of the cards' jobs."""
    import shutil
    import tempfile

    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
    from surya_tpu_torch.data.packed import pack_arrays
    from surya_tpu_torch.infer.serve import Predictor
    from surya_tpu_torch.models import get_model
    from surya_tpu_torch.ops.cuda import stem_bn
    from surya_tpu_torch.train.steps import trainable_mask

    t_phase = time.perf_counter()
    worlds = card_worlds()
    root = tempfile.mkdtemp(prefix="surya_parallel_")
    try:
        pack = os.path.join(root, "pack")
        pack_arrays(pack, synthetic_splits(LOOP_SPLITS), CLASS_NAMES)
        train_base = ["-m", "surya_tpu_torch", "train", "--preset",
                      "quadtree-fusion", f"--data.packed_dir={pack}"]
        train = [*train_base, "--train.epochs=1"]
        forms = ("zero1", "fsdp")
        cli = POOL.submit(finish, {f: start_torchrun(
            1, [*train, "--out", os.path.join(root, f), f"--train.{f}=true"])
            for f in forms}, timeout=400)
        gdir = os.path.join(root, "gloo")
        os.makedirs(gdir)
        gloo = POOL.submit(finish, {"gloo": start_torchrun(
            2, [os.path.abspath(__file__), "--parallel-gloo", gdir])},
            timeout=400)
        ncards = max(worlds, default=1)
        cards_started = worlds and POOL.submit(finish, {f: start_torchrun(
            ncards, [*train, "--out", os.path.join(root, f"{f}{ncards}"),
                     f"--train.{f}=true", f"--mesh.data={ncards}"])
            for f in forms}, timeout=600)
        yield
        refs = {name: parallel_step(PARALLEL_RUNS[name])
                for name in ("dp2_bf16", "dp2_f32")}
        yield from until_done(cli, gloo)
        cli, gloo_s = cli.result(), gloo.result()["gloo"][1]
        steps = LOOP_SPLITS["train"] // 16
        want = {"training": steps,
                "inference": (LOOP_SPLITS["valid"] + LOOP_SPLITS["test"])
                // 16}
        cfg = parallel_config(parallel_spec("bfloat16", 0, {}))
        rng = np.random.default_rng(7)
        images = rng.integers(0, 256, (128, 224, 224, 3), np.uint8)
        feats = rng.normal(size=(128, 47)).astype(np.float32)

        def serve(form, ckpt):
            sd = load_checkpoint_variables(ckpt)
            _, probs = Predictor(cfg.model, sd, batch_size=64,
                                 param_dtype=torch.bfloat16,
                                 input_dtype="uint8").predict(images, feats)
            if not (probs.shape == (128, 8) and np.isfinite(probs).all()
                    and np.allclose(probs.sum(1), 1.0, atol=1e-3)):
                raise AssertionError(f"{form}: checkpoint serves badly")
            return True

        served, cli_launches = {}, {}
        for form in forms:
            summary = last_json(cli[form][0])
            got = summary["kernel_launches"]
            if got["quadrant"] != want or got["fusion_head"] != want:
                raise AssertionError(f"{form}: launches {got} != {want}")
            cli_launches[form] = got
            serve(form, os.path.join(root, form, "ckpt"))
            served[form] = {"test": summary["test"],
                            "seconds": cli[form][1]}

        ranks = [torch.load(os.path.join(gdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        names = [n for n, t in trainable_mask(
            get_model(cfg.model, image_size=64), cfg.model.name,
            cfg.model.freeze_backbone).items() if t]
        held, errs = None, {}
        for name in PARALLEL_RUNS:
            dtype = PARALLEL_RUNS[name]["dtype"]
            ref = refs["dp2_f32" if dtype == "float32" else "dp2_bf16"]
            got = ranks[0][name]
            logits = (torch.cat([ranks[0][name]["logits"],
                                 ranks[1][name]["logits"]])
                      if name.startswith("dp2") else got["logits"])
            row = parallel_errors(got, ref, logits, ref["logits"], names,
                                  cfg.train.lr)
            row["launches"] = got["launches"]
            row["bytes"] = got["bytes"]
            errs[name] = row
            if parallel_failed(row, dtype):
                raise AssertionError(f"{name} vs one process: {row}")
            if got["held"] is not None:
                held = got["held"]
        if held is None:
            raise AssertionError("the model=2 run held no kernel call")
        cards_rec, faults, card_launches = {}, [], []
        if worlds:
            cards_rec["cli"], faults, card_launches = yield from cards_cli(
                cards_started, root, train_base, pack, ncards, serve)

        yield SOLO
        nfile = os.path.join(root, "nccl.json")
        finish({"nccl": start_torchrun(1, [os.path.abspath(__file__),
                                           "--parallel-nccl", nfile])},
               timeout=300)
        with open(nfile) as f:
            nccl = json.load(f)
        for world in worlds:
            cfile = os.path.join(root, f"cards{world}.json")
            proc = start_torchrun(world, [os.path.abspath(__file__),
                                          "--parallel-cards", cfile])
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if not os.path.exists(cfile):
                faults.append(f"{world} cards: exit {proc.returncode}\n"
                              f"{stdout[-3000:]}\n{stderr[-6000:]}")
                continue
            with open(cfile) as f:
                cards_rec[f"world{world}"] = rec = json.load(f)
            faults += [f"{world} cards: {name}" for name in rec["failed"]]
            card_launches += rec["launches_by_rank"]
        if worlds:
            cards_rec["guard"] = card_guard(quadrant, fusion_head, stem_bn)
            faults += cards_rec["guard"]["failed"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "parallel", "cli": served, "cli_launches": cli_launches,
          "gloo_two_ranks": errs, "gloo_seconds": gloo_s,
          "tp2_held": held, "nccl_one_rank": nccl, "seconds": seconds,
          **card})
    run_forms = [f for f, (w, _, _) in PARALLEL_CARD_FORMS.items()
                 if w in worlds]
    emit({"phase": "parallel_cards", "cards": torch.cuda.device_count(),
          "worlds": worlds, "forms_run": run_forms,
          "left_out": [f for f in PARALLEL_CARD_FORMS if f not in run_forms]
          + ([] if worlds else ["cli_torchrun", "predictor_over_cards",
                                "device_guard"]),
          "why_left_out": "NCCL takes one card a rank: a form of W ranks "
                          "needs W cards",
          **cards_rec, "faults": faults, **card})
    if faults:
        raise AssertionError(f"parallel over cards: {faults}")
    # the four model forms' launches on this path: both CLI children and
    # every gloo run on rank 0 (the head's dropout forward outside a
    # gradient counts as its inference launch), and every rank of the
    # cards' CLI jobs and NCCL children
    total = {"quadrant": 0, "quadrant_train": 0, "fusion_head": 0,
             "fusion_head_train": 0}
    for form in forms:
        for kname in ("quadrant", "fusion_head"):
            total[kname] += cli_launches[form][kname]["inference"]
            total[f"{kname}_train"] += cli_launches[form][kname]["training"]
    for name in PARALLEL_RUNS:
        got = ranks[0][name]["launches"]
        for kname in ("quadrant", "fusion_head"):
            total[kname] += got[kname] - got[f"{kname}_train"]
            total[f"{kname}_train"] += got[f"{kname}_train"]
    for got in card_launches:
        for kname in ("quadrant", "fusion_head"):
            if isinstance(got[kname], dict):   # the CLI's form
                total[kname] += got[kname]["inference"]
                total[f"{kname}_train"] += got[kname]["training"]
            else:
                total[kname] += got[kname]
                total[f"{kname}_train"] += got[f"{kname}_train"]
    return total


# ---------------------------------------------------------------------------
# fact_parallel: ring attention over 'seq', the GPipe FACT over 'pipe' and
# expert parallelism over 'expert' (parallel/{ring_attention,pipeline,moe}.py)
# ---------------------------------------------------------------------------

# the `fact` preset at its published widths (ViT-B/16 at 224 px, frozen;
# fusion d 768, 8 heads, FFN 3072, 4 layers; T 4, so 9 tokens) and
# FACT-MoE at scripts/fact_moe_run.py's settings (4 experts, top-2,
# capacity 2.0)
FACT_WIDTH = dict(num_classes=8, seq_len=4, num_features=47, embed_dim=768,
                  num_layers=4, num_heads=8, vit_depth=12, vit_heads=12,
                  image_size=224, freeze_backbone=True)
FACT_MOE = dict(moe_experts=4, moe_top_k=2)
FACT_BATCH, FACT_MICRO, FACT_TIME_BATCH = 8, 4, 32
FACT_TOL = 1e-4      # f32 with TF32 off: logits (relative to the largest)
                     # and gradients (relative L2)
FACT_DROP_SEED = 7
# name → (mesh axes, form, MoE, train-mode dropout seed): the two gloo ranks
FACT_GLOO_RUNS = {"sp2": ({"seq": 2}, "sp", False, None),
                  "pp2": ({"pipe": 2}, "pp", False, None),
                  "pp2_train": ({"pipe": 2}, "pp", False, FACT_DROP_SEED),
                  "dp2_train": ({"pipe": 1, "data": 2}, "pp", False,
                                FACT_DROP_SEED),
                  "ep2": ({"expert": 2}, "ep", True, FACT_DROP_SEED)}


def launch_counts() -> dict:
    """The six hand-kernel forms' launches in this process so far."""
    from surya_tpu_torch.ops.cuda import fusion_head, quadrant, stem_bn

    return {**read_launches(quadrant, fusion_head), **stem_bn.launches}


def fact_build(mesh=None, form="plain", moe=False, dtype=torch.float32):
    """FACT (or FACT-MoE) at full width from seed 0 on the card, dropout 0.1,
    the ViT frozen as the train step freezes it: ``sp`` with ``cp_mesh``,
    ``ep`` with ``moe_mesh``, ``pp`` holding only its stage's layers,
    ``ring`` with every fusion attention ring attention over the mesh."""
    from surya_tpu_torch.models.common import seeded
    from surya_tpu_torch.models.temporal.fact import FactModel
    from surya_tpu_torch.parallel.pipeline import keep_stage_layers
    from surya_tpu_torch.parallel.ring_attention import make_attention_fn

    kw = dict(FACT_WIDTH, dtype=dtype, dropout=0.1,
              **(FACT_MOE if moe else {}))
    if form == "sp":
        kw["cp_mesh"] = mesh
    if form == "ep":
        kw["moe_mesh"] = mesh
    model = seeded(lambda: FactModel(**kw), 0, "cuda")
    model.vit_backbone.requires_grad_(False)
    if form == "pp":
        keep_stage_layers(model, "fusion", model.num_layers, mesh)
    if form == "ring":   # ring attention at an axis of size 1
        for i in range(model.num_layers):
            getattr(model, f"fusion{i}").attn.attention_fn = \
                make_attention_fn(mesh)
    return model


def fact_batch(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, 4, 224, 224, 3), scale=0.5)
                             .astype(np.float32)).cuda(),
            torch.from_numpy(rng.normal(size=(n, 4, 47)).astype(
                np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 8, n)).cuda())


def fact_pass(model, batch, form="plain", mesh=None, train_seed=None,
              micro=FACT_MICRO, keep=True):
    """One forward and backward of the cross-entropy (plus the MoE's aux
    term) → logits, loss, aux, the bytes each collective moved in the two,
    and every gradient in the single-device form (split leaves and pipeline
    stages gathered; averaged over 'data' where the batch splits over
    it). ``loop``: the pipelined train mode written out on one process,
    the seed drawn before the embed as ``fact_apply_pipelined`` draws it,
    then ``layer(act, fold_in(seed, i, j))`` for each microbatch j and
    global layer i."""
    from surya_tpu_torch.core import mesh as cmesh
    from surya_tpu_torch.core.prng import fold_in
    from surya_tpu_torch.models.losses import cross_entropy
    from surya_tpu_torch.models.temporal.fact import fact_apply_pipelined
    from surya_tpu_torch.parallel.moe import MoEFFN
    from surya_tpu_torch.parallel.pipeline import gather_stages
    from surya_tpu_torch.parallel.zero import full_gradients

    images, feats, labels = batch
    model.train(train_seed is not None)
    model.zero_grad(set_to_none=True)
    gen = (None if train_seed is None
           else torch.Generator("cuda").manual_seed(train_seed))
    rows = None
    before = dict(cmesh.collective_bytes)
    if form == "pp":
        dp = mesh is not None and mesh.shape["data"] > 1
        logits = fact_apply_pipelined(
            model, images, feats, mesh, num_microbatches=micro,
            batch_spec="data" if dp else None, generator=gen)
        if dp:
            rows = mesh.row_shard(labels.shape[0], micro)
            labels = rows.take(labels)
    elif form == "loop":
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        outs = []
        for j, act in enumerate(model.embed(images, feats, gen).chunk(micro)):
            for i in range(model.num_layers):
                act = getattr(model, f"fusion{i}")(
                    act, fold_in(seed, i, j, device=act.device))
            outs.append(act)
        logits = model.head(torch.cat(outs))
    else:
        logits = model(images, feats, gen)
    aux = sum((m.aux_loss for m in model.modules()
               if isinstance(m, MoEFFN) and m.aux_loss is not None),
              torch.zeros((), device=logits.device))
    loss = cross_entropy(logits.float(), labels) + aux
    loss.backward()
    if not keep:
        return None
    moved = {k: cmesh.collective_bytes[k] - before[k] for k in before}
    if rows is not None:
        for p in model.parameters():
            if p.grad is not None:
                cmesh.all_reduce_(p.grad, mesh.group("data")).div_(
                    rows.ranks)
    grads = full_gradients(model)
    if form == "pp" and mesh is not None:
        grads = gather_stages(grads, "fusion", model.num_layers, mesh)
    return {"logits": logits.detach().float().cpu(),
            "rows": None if rows is None else rows.spans,
            "loss": float(loss.detach()), "aux": float(aux.detach()),
            "bytes": moved,
            "grads": {k: v.float().cpu() for k, v in grads.items()}}


def fact_errors(got, want) -> dict:
    """Logits relative to the largest, the gradients' relative L2 over every
    parameter and over the fusion layers', the aux term's difference."""
    ref = (want["logits"] if got["rows"] is None else torch.cat(
        [want["logits"][a:b] for a, b in got["rows"]]))
    names = sorted(want["grads"])
    if sorted(got["grads"]) != names:
        raise AssertionError("gradient names differ: "
                             f"{set(got['grads']) ^ set(names)}")
    fusion = [n for n in names if n.startswith("fusion")]

    def flat(run, keys):
        return torch.cat([run["grads"][k].reshape(-1) for k in keys])

    return {"logits": compare(got["logits"], ref)[1],
            "grads": rel_l2(flat(got, names), flat(want, names)),
            "fusion_grads": rel_l2(flat(got, fusion), flat(want, fusion)),
            "aux": abs(got["aux"] - want["aux"])}


def fact_failed(errs: dict) -> bool:
    return max(errs["logits"], errs["grads"], errs["fusion_grads"],
               errs["aux"]) > FACT_TOL


def expert_bytes(model) -> int:
    from surya_tpu_torch.parallel.moe import EXPERT_LEAVES

    return sum(p.numel() * p.element_size() for n, p in
               model.named_parameters()
               if n.rpartition(".")[2] in EXPERT_LEAVES)


def _fact_child_setup(backend: str):
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if backend == "gloo":   # two ranks on the one card
        torch.cuda.set_device(0)
        dist.init_process_group("gloo")
    else:
        from surya_tpu_torch.core.mesh import maybe_initialize_distributed

        maybe_initialize_distributed()
    return dist


def fact_gloo_child(out_dir: str) -> None:
    """One of two ranks on the one card over gloo with CUDA tensors: each of
    ``FACT_GLOO_RUNS`` → ``rank<r>.pt`` in ``out_dir``."""
    from surya_tpu_torch.core import mesh as cmesh

    dist = _fact_child_setup("gloo")
    batch = fact_batch(FACT_BATCH)
    out, before = {}, launch_counts()
    for name, (axes, form, moe, seed) in FACT_GLOO_RUNS.items():
        mesh = cmesh.create_mesh(axes, "cuda")
        model = fact_build(mesh, form, moe)
        out[name] = fact_pass(model, batch, form, mesh, seed)
        out[name]["expert_bytes"] = expert_bytes(model)
        del model
        torch.cuda.empty_cache()
        dist.barrier()
    out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


def _fact_ms(fn, reps=5, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
    return statistics.median(ms)


def fact_nccl_child(out_file: str) -> None:
    """NCCL ranks, one card each. At one rank: ring attention, the pipeline
    and EP at axis size 1 against the plain model, and the batch-32 bf16
    forward + backward (train mode, dropout 0.1) plain against pipelined at
    M 4, in turns. At N ≥ 2 ranks: sp N, pp N at M 8, ep N and pp2×dp2
    (N = 4) against the plain model on each rank's card, with each form's
    forward + backward time, bytes by collective kind and peak memory."""
    from surya_tpu_torch.core import mesh as cmesh

    dist = _fact_child_setup("nccl")
    world = dist.get_world_size()
    batch = fact_batch(FACT_BATCH)
    before, refs = launch_counts(), {}
    for moe, seed in ((False, None), (True, FACT_DROP_SEED)):
        model = fact_build(moe=moe)
        refs[moe] = fact_pass(model, batch, train_seed=seed)
        del model
    if world == 1:
        mesh = cmesh.create_mesh({"seq": 1, "pipe": 1, "expert": 1}, "cuda")
        runs = {"ring1": ("ring", False, None), "pp1": ("pp", False, None),
                "ep1": ("ep", True, FACT_DROP_SEED)}
    else:
        runs = {f"sp{world}": ({"seq": world}, "sp", False, None, 4),
                f"pp{world}": ({"pipe": world}, "pp", False, None, 8),
                f"ep{world}": ({"expert": world}, "ep", True,
                               FACT_DROP_SEED, 4)}
        if world == 4:
            runs["pp2dp2"] = ({"pipe": 2, "data": 2}, "pp", False, None, 4)
    out = {"backend": dist.get_backend(), "world": world, "forms": {}}
    for name, run in runs.items():
        if world == 1:
            (form, moe, seed), micro = run, FACT_MICRO
        else:
            axes, form, moe, seed, micro = run
            mesh = cmesh.create_mesh(axes, "cuda")
        model = fact_build(mesh, form, moe)
        got = fact_pass(model, batch, form, mesh, seed, micro)
        row = {**fact_errors(got, refs[moe]), "bytes": got["bytes"]}
        if world > 1:   # nothing may hold the model past this form
            torch.cuda.reset_peak_memory_stats()
            row["fwd_bwd_ms"] = _fact_ms(lambda: fact_pass(
                model, batch, form, mesh, seed, micro, keep=False))
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            row["expert_bytes"] = expert_bytes(model)
        out["forms"][name] = row
        del model
        torch.cuda.empty_cache()
    if world > 1:   # the plain models' time and peak on the same cards
        for moe, seed in ((False, None), (True, FACT_DROP_SEED)):
            model = fact_build(moe=moe)
            torch.cuda.reset_peak_memory_stats()
            ms = _fact_ms(lambda: fact_pass(model, batch, train_seed=seed,
                                            keep=False))
            out["forms"]["plain_moe" if moe else "plain"] = {
                "fwd_bwd_ms": ms,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "expert_bytes": expert_bytes(model)}
            del model
            torch.cuda.empty_cache()
    else:   # what the tick loop costs at one stage
        big = fact_batch(FACT_TIME_BATCH, seed=6)
        model = fact_build(dtype=torch.bfloat16)
        ms = {"plain": [], "pipelined": []}
        for _ in range(3):   # in turns
            for name, form in (("plain", "plain"), ("pipelined", "pp")):
                ms[name].append(_fact_ms(lambda f=form: fact_pass(
                    model, big, f, mesh, FACT_DROP_SEED, keep=False)))
        out["fwd_bwd_ms_batch32_bf16"] = {
            k: statistics.median(v) for k, v in ms.items()}
    mine = {k: v - before[k] for k, v in launch_counts().items()}
    every = [None] * world
    dist.all_gather_object(every, mine)
    out["launches"] = {k: sum(r[k] for r in every) for k in mine}
    if dist.get_rank() == 0:
        with open(out_file, "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def fact_parallel_phase(card) -> dict:
    """FACT's parallel variants on the card. (1) Two ranks on the one card
    over gloo with CUDA tensors (``torchrun --nproc-per-node=2``): sp2
    (``FactModel(cp_mesh=)``, 9 tokens padded to 10), pp2
    (``fact_apply_pipelined`` at M 4, eval, and train mode with dropout 0.1)
    and ep2 (FACT-MoE, ``moe_mesh``), each held to this process's plain
    model at f32 with TF32 off: logits, every gradient, the aux term, and
    half the expert bytes a rank. Train mode with dropout 0.1, at pp2 and
    over dp2 (pipe 1, data 2), is held to the schedule written out as a
    plain loop (``fact_pass(form="loop")``), whose logits must differ from
    eval's. (2) One NCCL rank: the same code at axis size 1, and the tick
    loop's cost. (3) With two or more cards, the NCCL forms over min(4,
    count) of them. A side-by-side phase (:func:`side_by_side`): (1) runs
    with the others, (2) and (3), which are timed, alone at the end. → the
    hand kernels' launches of the path in this process (while it builds
    the references) and in every rank (FACT runs none)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="surya_fact_parallel_")
    try:
        gdir = os.path.join(root, "gloo")
        os.makedirs(gdir)
        child = POOL.submit(finish, {"gloo": start_torchrun(
            2, [os.path.abspath(__file__), "--fact-gloo", gdir])},
            timeout=400)
        yield
        before = launch_counts()
        batch = fact_batch(FACT_BATCH)   # the references, meanwhile
        refs = {}
        for name, (form, moe, seed) in {
                "plain": ("plain", False, None),
                "written_out_train": ("loop", False, FACT_DROP_SEED),
                "plain_moe_train": ("plain", True, FACT_DROP_SEED)}.items():
            model = fact_build(moe=moe)
            refs[name] = fact_pass(model, batch, form, None, seed)
            whole = expert_bytes(model)
            del model
            torch.cuda.empty_cache()
        here = {k: v - before[k] for k, v in launch_counts().items()}
        yield from until_done(child)
        child.result()
        ranks = [torch.load(os.path.join(gdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        gloo = {}
        for name in FACT_GLOO_RUNS:
            want = refs[{"pp2_train": "written_out_train",
                         "dp2_train": "written_out_train",
                         "ep2": "plain_moe_train"}.get(name, "plain")]
            for r, got in enumerate(ranks):
                errs = fact_errors(got[name], want)
                errs["bytes"] = got[name]["bytes"]
                if name == "ep2":
                    errs["expert_bytes"] = got[name]["expert_bytes"]
                    errs["expert_bytes_unsharded"] = whole
                    if 2 * got[name]["expert_bytes"] != whole:
                        raise AssertionError(f"ep2 rank {r} holds "
                                             f"{errs['expert_bytes']} of "
                                             f"{whole} expert bytes")
                gloo[f"{name}_rank{r}"] = errs
                if fact_failed(errs):
                    raise AssertionError(f"{name} rank {r} vs one process: "
                                         f"{errs}")
        dropped = compare(refs["written_out_train"]["logits"],
                          refs["plain"]["logits"])[1]
        if dropped <= FACT_TOL:
            raise AssertionError(f"train-mode logits within {dropped} of "
                                 "eval's: dropout did not act")
        yield SOLO
        runs = {}
        for n in sorted({1, min(4, torch.cuda.device_count())}):
            nfile = os.path.join(root, f"nccl{n}.json")
            finish({f"nccl{n}": start_torchrun(n, [
                os.path.abspath(__file__), "--fact-nccl", nfile])},
                timeout=400)
            with open(nfile) as f:
                runs[n] = json.load(f)
            for name, row in runs[n]["forms"].items():
                if "logits" in row and fact_failed(row):
                    raise AssertionError(f"NCCL {name}: {row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    children = [r["launches"] for r in ranks] + [
        r["launches"] for r in runs.values()]
    launches = {k: v + sum(c[k] for c in children) for k, v in here.items()}
    emit({"phase": "fact_parallel", "gloo_two_ranks": gloo,
          "train_vs_eval_logits": dropped,
          "nccl": {str(k): v for k, v in runs.items()},
          "hand_kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase, **card})
    return launches


# ---------------------------------------------------------------------------
# the bench command and the replay accuracy run
# ---------------------------------------------------------------------------

BENCH_STEPS = 20   # bench.py's default
# (label, BENCH_* environment, metric, batch, the launches the command
# implies: an untimed pass and three timed windows of BENCH_STEPS steps,
# each step one launch of each kernel the model runs, in the step's form)
BENCH_RUNS = [
    ("quadtree_train", {}, "quadtree_train_images_per_sec_per_chip", 256,
     {"quadrant": "training", "fusion_head": "training"}),
    ("quadtree_infer", {"BENCH_MODE": "infer"},
     "quadtree_infer_images_per_sec_per_chip", 256,
     {"quadrant": "inference", "fusion_head": "inference"}),
    ("quadtree-3d_train", {"BENCH_MODEL": "quadtree-3d"},
     "quadtree-3d_train_clips_per_sec_per_chip", 8,
     {"fusion_head": "training"}),
]
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "batch_size",
              "baseline_device", "caveat")
# the replay run: the flagship's published recipe on the replay set; a path
# that learns nothing scores chance (0.125); JAX's image-only ablation
# scores 0.50 and its lowest flagship seed 0.895
REPLAY_MIN_ACCURACY = 0.80
REPLAY_CAM_IMAGES = 64


def bench_phase(card, train_step_ms):
    """``python -m surya_tpu_torch bench`` as three children, one after the
    other: ``quadtree`` train at its defaults (batch 256, 20 steps), the
    same in infer mode, and ``BENCH_MODEL=quadtree-3d``. Each prints one
    line with ``bench.py``'s keys, a positive rate, the card, and exactly
    the launches the command implies. → launches per kernel form."""
    t0 = time.perf_counter()
    env0 = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    rows = []
    totals = dict.fromkeys(("quadrant", "quadrant_train", "fusion_head",
                            "fusion_head_train"), 0)
    for label, env, metric, batch, forms in BENCH_RUNS:
        t1 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "surya_tpu_torch",
                              "bench"], cwd=REPO, env={**env0, **env},
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, (label, res.stdout[-2000:],
                                     res.stderr[-4000:])
        lines = res.stdout.strip().splitlines()
        assert len(lines) == 1, (label, lines)
        line = json.loads(lines[0])
        assert all(k in line for k in BENCH_KEYS), (label, line)
        assert line["metric"] == metric and line["value"] > 0, line
        assert line["batch_size"] == batch, line
        assert line["device"] == card["nvidia_smi"], line
        n = 4 * BENCH_STEPS
        want = {k: {"training": 0, "inference": 0}
                for k in ("quadrant", "fusion_head")}
        for k, form in forms.items():
            want[k][form] = n
        assert line["kernel_launches"] == {
            **want, "channel_stats": 0, "affine_relu": 0}, (label, line)
        for k in ("quadrant", "fusion_head"):
            totals[k] += want[k]["inference"]
            totals[k + "_train"] += want[k]["training"]
        rows.append({"run": label, "env": env, "line": line,
                     "child_s": time.perf_counter() - t1})
    train = rows[0]["line"]["value"]
    emit({"phase": "bench", "steps": BENCH_STEPS, "runs": rows,
          "train_images_per_s": train,
          "train_phase_step_ms": train_step_ms,
          "train_phase_images_per_s": TRAIN_BATCH / train_step_ms * 1e3,
          "launches": totals, "seconds": time.perf_counter() - t0, **card})
    return totals


def replay_data(root):
    """The replay campaign's ``data`` phase at full width (1,280 JPEGs, 848
    windows, the three packs) in a child, ``python -m
    surya_tpu_torch.bench.replay --phase data``, under ``root``. Host work
    only, so it runs while the kernels build and are checked. → (its
    record, seconds)."""
    made = finish({"data": start_child([
        sys.executable, "-m", "surya_tpu_torch.bench.replay", "--phase",
        "data", "--root", os.path.join(root, "data"), "--out",
        os.path.join(root, "out")])}, timeout=600)
    stdout, seconds = made["data"]
    print(stdout, end="", file=sys.stderr, flush=True)   # the packs' lines
    return last_json(stdout), seconds


def replay_phase(card, root, data, data_s):
    """The replay accuracy campaign's seed 0 of ``quadtree-fusion``
    (``surya_tpu_torch.bench.replay``) on the set :func:`replay_data`
    wrote under ``root``: the published recipe through the CLI's
    ``train`` in a child of the campaign's own ``--phase spatial --rows
    quadtree-fusion --seeds 1`` (10 epochs of 48 steps at batch 16, early
    stop, best reload). Its test accuracy must reach
    :data:`REPLAY_MIN_ACCURACY`; its launches are counted exactly from its
    epochs. Then Grad-CAM on the best checkpoint, card vs CPU end to end
    at f32, on the first test images and on ``spatial_cam``'s
    random-normal draw. A side-by-side phase (:func:`side_by_side`): it
    checks results and times nothing. → launches per kernel form."""
    import shutil

    from surya_tpu_torch.bench import replay
    from surya_tpu_torch.core.checkpoint import load_checkpoint_variables
    from surya_tpu_torch.core.config import get_preset

    t0 = time.perf_counter()
    try:
        data_root, out = os.path.join(root, "data"), os.path.join(root, "out")
        name, preset, run_dir, ov = next(replay.jobs_for("spatial",
                                                         data_root, 1, out))
        trained = POOL.submit(finish, {"train": start_child([
            sys.executable, "-m", "surya_tpu_torch.bench.replay", "--phase",
            "spatial", "--root", data_root, "--seeds", "1", "--out", out,
            "--rows", name])}, timeout=900)
        yield from until_done(trained)
        print(trained.result()["train"][0], end="", file=sys.stderr,
              flush=True)   # the row's result line
        result = replay.load_result(os.path.join(run_dir, "result.json"))
        assert "test" in result, result
        accuracy = result["test"]["accuracy"]
        epochs = epoch_records(run_dir)
        batches = {s: n // 16 for s, n in data["images"].items()}
        want = {"training": sum(r["steps"] for r in epochs),
                "inference": (len(epochs) + 1) * batches["test"]}
        assert batches["valid"] == batches["test"], batches
        assert all(r["steps"] == batches["train"] for r in epochs), epochs
        launches = result["kernel_launches"]
        assert launches == {"quadrant": want, "fusion_head": want,
                            "channel_stats": 0, "affine_relu": 0}, launches
        assert accuracy >= REPLAY_MIN_ACCURACY, result

        t1 = time.perf_counter()
        cfg = get_preset(preset).override(ov)
        state = load_checkpoint_variables(replay.best_checkpoint(run_dir))
        images, feats = replay.test_split_inputs(cfg, REPLAY_CAM_IMAGES)
        rng = np.random.default_rng(2)
        normal = (rng.normal(size=(CAM_BATCH, 224, 224, 3)).astype(
                      np.float32),
                  rng.normal(size=(CAM_BATCH, 47)).astype(np.float32))
        cams = {"test_split": replay.cam_errors(cfg.model, state, images,
                                                feats),
                "normal_b4": replay.cam_errors(cfg.model, state, *normal)}
        # layer3's backward crosses layer4, whose ReLU masks move with the
        # trunk's rounding (ROADMAP §C): reported, not asserted, as in
        # spatial_cam; trained weights did not close it
        for inputs in cams.values():
            assert inputs["layer4"]["within_tol"], cams
            for target in ("layer3", "layer4"):
                assert inputs[target]["preds_equal"], cams
        emit({"phase": "replay", "preset": preset, "seed": 0,
              "test": result["test"], "best_epoch": result["best_epoch"],
              "epochs": len(epochs), "min_accuracy": REPLAY_MIN_ACCURACY,
              "train_wall_s": result["wall_seconds"],
              "epoch_time_s": [r["epoch_time_s"] for r in epochs],
              "val_accuracy": [r["val_accuracy"] for r in epochs],
              "launches": launches, "data_s": data_s,
              "data": {k: data[k] for k in ("images", "windows", "decoder",
                                            "pixel_error", "write_s",
                                            "pack_s")},
              "cam": {"images": REPLAY_CAM_IMAGES, **cams,
                      "seconds": time.perf_counter() - t1},
              "seconds": time.perf_counter() - t0, **card})
        return {"quadrant": want["inference"], "quadrant_train":
                want["training"], "fusion_head": want["inference"],
                "fusion_head_train": want["training"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import shutil
    import tempfile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_info()
    name = torch.cuda.get_device_name(0)
    card = {"card": name, "nvidia_smi": smi}
    emit({"phase": "card", "nvidia_smi": smi, "clocks": clocks(),
          "torch": torch.__version__,
          "cuda": torch.version.cuda, **card})

    # the replay set is written and packed by a child while the kernels
    # build and are checked: host work only, awaited before anything is
    # timed
    replay_root = tempfile.mkdtemp(prefix="surya_replay_")
    replay_set = POOL.submit(replay_data, replay_root)
    try:
        return run_phases(card, replay_root, replay_set)
    finally:
        stop_children()
        shutil.rmtree(replay_root, ignore_errors=True)


def run_phases(card, replay_root, replay_set) -> int:
    """Every phase in turn, then the ``kernels`` line and the result
    line. The phases that only check results through children run side by
    side at the end; each stage that times runs alone."""
    from surya_tpu_torch.ops.cuda import KERNELS, _build
    from surya_tpu_torch.ops.cuda import fusion_head, quadrant, stem_bn

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    emit({"phase": "build", "kernels": list(KERNELS),
          "seconds": time.perf_counter() - t0})
    hgmma = hgmma_counts()

    checks = check_kernels(quadrant, fusion_head)
    quadrant_train = check_quadrant_train(quadrant)
    head_train = check_head_train(fusion_head)
    check_stem_bn(stem_bn)
    predictor, images, feats, serve_launches = serve_phase(
        quadrant, fusion_head, card)
    t0 = time.perf_counter()
    replay_set.result()
    emit({"phase": "replay_data_wait", "seconds": time.perf_counter() - t0})
    times = time_phase(quadrant, fusion_head, card, hgmma)
    forward_split(predictor, images, feats, card)
    serve_throughput(predictor, images, feats, card)
    del predictor
    train_launches, train_step_ms = train_phase(quadrant, fusion_head, card)
    train_f32_parity(card)
    torch.cuda.empty_cache()
    bench_launches = bench_phase(card, train_step_ms)
    augment = augment_phase(card)
    torch.cuda.empty_cache()
    loop = loop_phase(card, augment)
    next(loop)   # the traced train, alone; the rest runs side by side
    stem_launches, stem_times = stem_probe(stem_bn, card)
    times.update(stem_times)
    torch.cuda.empty_cache()
    spatial_launches, _ = spatial_phase(quadrant, fusion_head, card)
    torch.cuda.empty_cache()
    temporal_launches, _ = temporal_phase(quadrant, fusion_head, stem_bn,
                                          card)
    torch.cuda.empty_cache()
    pose_launches = pose_phase(quadrant, fusion_head, card)
    torch.cuda.empty_cache()
    generate_launches = generate_phase(quadrant, fusion_head, card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the longest children first; the phases that pack in this process
    # before starting theirs last
    lane = side_by_side({
        "replay": replay_phase(card, replay_root, *replay_set.result()),
        "fact_parallel": fact_parallel_phase(card),
        "loop": loop,
        "temporal_cli": temporal_cli(card),
        "spatial_cli": spatial_cli(card),
        "export": export_phase(quadrant, fusion_head, card),
        "parallel": parallel_phase(quadrant, fusion_head, card)})
    emit({"phase": "side_by_side", "phases": list(lane),
          "seconds": time.perf_counter() - t0, **card})
    # FACT runs no hand kernel: its launches are reported, none is expected
    loop_launches, replay_launches = lane["loop"], lane["replay"]
    export_launches, parallel_launches = lane["export"], lane["parallel"]
    for k, v in lane["spatial_cli"].items():
        spatial_launches[k] += v
    if min(spatial_launches.values()) < 1:
        raise AssertionError(f"a kernel form was never launched on the "
                             f"spatial path: {spatial_launches}")
    for k, v in lane["temporal_cli"].items():
        temporal_launches[k] = temporal_launches.get(k, 0) + v
    if (temporal_launches["quadrant"] or temporal_launches["quadrant_train"]
            or temporal_launches["channel_stats"]
            or temporal_launches["affine_relu"]):
        raise AssertionError(f"the temporal path launched a kernel it does "
                             f"not run: {temporal_launches}")
    if min(temporal_launches["fusion_head"],
           temporal_launches["fusion_head_train"]) < 1:
        raise AssertionError(f"a head form was never launched on the "
                             f"temporal path: {temporal_launches}")
    if min(parallel_launches.values()) < 1:
        raise AssertionError(f"a kernel form was never launched on the "
                             f"parallel path: {parallel_launches}")

    smi, name = card["nvidia_smi"], card["card"]
    # name → (source, replaces, launches on its path, max |kernel - plain|
    # at the shape that path gives it, bf16)
    q_flag, h_flag = tuple(QUADRANT_SHAPES[0]), tuple(HEAD_SHAPES[0])
    q_train, h_train = QUADRANT_TRAIN_SHAPES[-1], HEAD_TRAIN_SHAPES[-1]
    q_at, h_at = ("surya_tpu/ops/pallas/quadrant.py:78",
                  "surya_tpu/ops/pallas/fusion_head.py:47")
    table = {
        "quadrant": ("quadrant", q_at, serve_launches["quadrant"],
                     checks[("quadrant", q_flag, "bfloat16")]),
        "fusion_head": ("fusion_head", h_at, serve_launches["fusion_head"],
                        checks[("fusion_head", h_flag, "bfloat16")]),
        "quadrant_train": ("quadrant", q_at, train_launches["quadrant"],
                           quadrant_train[(q_train, "bfloat16")]),
        "fusion_head_train": ("fusion_head", h_at,
                              train_launches["fusion_head"],
                              head_train[(h_train, "bfloat16")]),
        "channel_stats": ("stem_bn", "surya_tpu/ops/pallas/stem_bn.py:54",
                          stem_launches["channel_stats"],
                          stem_times["channel_stats"]),
        "affine_relu": ("stem_bn", "surya_tpu/ops/pallas/stem_bn.py:71",
                        stem_launches["affine_relu"],
                        stem_times["affine_relu"])}
    # launches on every path: serve, train, stem probe, spatial, temporal
    # and generate in this process, the loop's (and the spatial and
    # temporal CLI runs') in the CLI children
    paths = {
        "quadrant": {"serve": serve_launches["quadrant"],
                     "loop": loop_launches["quadrant"]["inference"],
                     "spatial": spatial_launches["quadrant"],
                     "temporal": temporal_launches["quadrant"],
                     "pose": pose_launches["quadrant"],
                     "export": export_launches["quadrant"],
                     "parallel": parallel_launches["quadrant"],
                     "bench": bench_launches["quadrant"],
                     "replay": replay_launches["quadrant"]},
        "fusion_head": {"serve": serve_launches["fusion_head"],
                        "loop": loop_launches["fusion_head"]["inference"],
                        "spatial": spatial_launches["fusion_head"],
                        "temporal": temporal_launches["fusion_head"],
                        "pose": pose_launches["fusion_head"],
                        "export": export_launches["fusion_head"],
                        "parallel": parallel_launches["fusion_head"],
                        "bench": bench_launches["fusion_head"],
                        "replay": replay_launches["fusion_head"]},
        "quadrant_train": {"train": train_launches["quadrant"],
                           "loop": loop_launches["quadrant"]["training"],
                           "spatial": spatial_launches["quadrant_train"],
                           "temporal": temporal_launches["quadrant_train"],
                           "parallel": parallel_launches["quadrant_train"],
                           "bench": bench_launches["quadrant_train"],
                           "replay": replay_launches["quadrant_train"]},
        "fusion_head_train": {
            "train": train_launches["fusion_head"],
            "loop": loop_launches["fusion_head"]["training"],
            "spatial": spatial_launches["fusion_head_train"],
            "temporal": temporal_launches["fusion_head_train"],
            "generate": generate_launches["fusion_head_train"],
            "parallel": parallel_launches["fusion_head_train"],
            "bench": bench_launches["fusion_head_train"],
            "replay": replay_launches["fusion_head_train"]},
        "channel_stats": {"stem_probe": stem_launches["channel_stats"],
                          "loop": loop_launches["channel_stats"],
                          "temporal": temporal_launches["channel_stats"],
                          "bench": 0, "replay": 0},
        "affine_relu": {"stem_probe": stem_launches["affine_relu"],
                        "loop": loop_launches["affine_relu"],
                        "temporal": temporal_launches["affine_relu"],
                        "bench": 0, "replay": 0}}
    kernels = []
    for kname, (source, replaces, launches, check) in table.items():
        if launches < 1:
            raise AssertionError(f"{kname} was never launched on its path")
        t = times[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"surya_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": launches,
            "launches_by_path": paths[kname],
            "max_abs_err": check["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-artifact"]:   # the export phase's child
        emit(serve_artifact(json.loads(sys.argv[2])))
        sys.exit(0)
    if sys.argv[1:2] == ["--parallel-gloo"]:   # the parallel phase's ranks
        parallel_gloo_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--parallel-nccl"]:
        parallel_nccl_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--parallel-cards"]:   # one NCCL rank a card
        parallel_card_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--fact-gloo"]:   # the fact_parallel phase's ranks
        fact_gloo_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--fact-nccl"]:
        fact_nccl_child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
