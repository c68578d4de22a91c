"""Smoke run of the PyTorch port (``surya_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``surya_tpu_torch/csrc`` and
holds each kernel, in its inference and its training form (outputs and
gradients), against its plain PyTorch version on the card. Then it drives
three paths, with every kernel's launch count set to 0 just before and
read just after:

- **serve**: the flagship ``quadtree-fusion`` model (resnet18 trunk,
  224 px, 8 classes, random weights from seed 0, bf16 weights, uint8 wire,
  batch 64) over HTTP through ``PredictionServer``/``Predictor``;
- **train**: the same preset through ``create_train_state`` /
  ``make_train_step`` at batch 256, bf16 over f32 parameters, dropout 0.5,
  a fixed batch from seed 0, then an eval step; and one f32 step on the
  card against the same step on the CPU;
- **stem_probe**: a train-mode stem forward (cuDNN conv 7x7/2 on
  (256, 224, 224, 3) bf16, then the two stem-BN kernels) against
  ``F.batch_norm`` + ReLU on the same map.

It times kernels, serving and the train step with CUDA events. One JSON
line per phase; then the card's name and power limit as ``nvidia-smi``
reports them, the ``kernels`` line, and the result line
``{"ok": true, "device": {...}}`` last. Any failed check raises, and the
script exits non-zero without a result line. It needs a CUDA device and
the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
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

QUADRANT_SHAPES = [(64, 14, 256, 128), (3, 28, 32, 16), (8, 8, 16, 8),
                   (4, 14, 1024, 128)]  # last: a resnet50 trunk's layer3
HEAD_SHAPES = [(64, 5376, 2688, 8), (5, 256, 128, 3)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel - plain| / max |plain|


def emit(obj) -> None:
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
    bf16-rounded inputs, to 2e-2 relative."""
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
            want = quadrant.quadrant_process_plain(
                *(a.float() for a in args))
            ok_shape = got.shape == want.shape and got.dtype == dtype
        else:
            args = head_inputs(*shape, dtype)
            got = fusion_head.fusion_head(*args)
            want = fusion_head.fusion_head_plain(*(a.float() for a in args))
            ok_shape = got.shape == want.shape and got.dtype == torch.float32
        torch.cuda.synchronize()
        err, rel = compare(got, want)
        dname = str(dtype).removeprefix("torch.")
        ok = ok_shape and rel <= TOL[dname] and bool(
            torch.isfinite(got.float()).all())
        row = {"phase": "check", "kernel": name, "shape": list(shape),
               "dtype": dname, "max_abs_err": err, "max_rel_err": rel,
               "tol": TOL[dname], "ok": ok}
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

def time_ms(fn, flush=None, reps=20):
    """Median device time of ``fn`` over ``reps`` launches, each timed by
    CUDA events after a write of ``flush`` that evicts the 50 MB L2, as
    the serving path (trunk between heads) leaves it cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_phase(quadrant, fusion_head, card):
    from surya_tpu_torch.ops.quadtree import quadrant_split

    bw, bf16_peak = PEAK_BYTES_S, PEAK_BF16_FLOP_S
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bf = torch.bfloat16
    rows = {}

    b, h, cin, cout = QUADRANT_SHAPES[0]
    fmap, kernel, bias = quadrant_inputs(b, h, cin, cout, bf)
    hp = h // 4
    q = quadrant_split(fmap).permute(0, 3, 1, 2)           # channels_last
    w_oihw = kernel.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bias_bf = bias.to(bf)
    nbytes = (fmap.numel() * 2 + kernel.numel() * 2 + bias.numel() * 4
              + b * 4 * hp * hp * cout * 2)
    flops = 2 * b * 4 * (2 * hp) ** 2 * 9 * cin * cout     # pooled outputs
    rows["quadrant"] = {
        "ms": time_ms(lambda: quadrant.quadrant_process(
            fmap, kernel, bias), flush),
        "plain_ms": time_ms(lambda: quadrant.quadrant_process_plain(
            fmap, kernel, bias), flush),
        "library_ms": time_ms(lambda: F.max_pool2d(F.relu(F.conv2d(
            q, w_oihw, bias_bf, padding=1)), 2, 2), flush),
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(nbytes / bw, flops / bf16_peak) * 1e3,
        "bound_by": "bytes" if nbytes / bw > flops / bf16_peak
        else "operations"}

    b, d, hdim, c = HEAD_SHAPES[0]
    x, w1, b1, w2, b2 = head_inputs(b, d, hdim, c, bf)
    b1_bf, b2_bf = b1.to(bf), b2.to(bf)
    nbytes = ((x.numel() + w1.numel() + w2.numel()) * 2
              + (b1.numel() + b2.numel() + b * c) * 4)
    flops = 2 * b * hdim * (d + c)
    rows["fusion_head"] = {
        "ms": time_ms(lambda: fusion_head.fusion_head(
            x, w1, b1, w2, b2), flush),
        "plain_ms": time_ms(lambda: fusion_head.fusion_head_plain(
            x, w1, b1, w2, b2), flush),
        "library_ms": time_ms(lambda: torch.addmm(
            b2_bf, torch.relu(torch.addmm(b1_bf, x, w1.t())), w2.t()),
            flush),
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(nbytes / bw, flops / bf16_peak) * 1e3,
        "bound_by": "bytes" if nbytes / bw > flops / bf16_peak
        else "operations"}
    shapes = {"quadrant": QUADRANT_SHAPES[0], "fusion_head": HEAD_SHAPES[0]}

    # the training forms at the train step's batch: all hq x hq conv
    # outputs and the act map; dropout and the h output
    b = TRAIN_BATCH
    _, h, cin, cout = QUADRANT_SHAPES[0]
    fmap, kernel, bias = quadrant_inputs(b, h, cin, cout, bf)
    q = quadrant_split(fmap).permute(0, 3, 1, 2)
    nbytes = (fmap.numel() * 2 + kernel.numel() * 2 + bias.numel() * 4
              + b * 4 * hp * hp * cout * 2 + b * h * h * cout * 2)
    flops = 2 * b * h * h * 9 * cin * cout                 # every position

    def library_quadrant_train():
        act = F.relu(F.conv2d(q, w_oihw, bias_bf, padding=1))
        return F.max_pool2d(act, 2, 2), act

    shapes["quadrant_train"] = (b, h, cin, cout)
    rows["quadrant_train"] = {
        "ms": time_ms(lambda: quadrant.quadrant_process_with_act(
            fmap, kernel, bias), flush),
        "plain_ms": time_ms(lambda: quadrant.quadrant_process_plain(
            fmap, kernel, bias, with_act=True), flush),
        "library_ms": time_ms(library_quadrant_train, flush),
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(nbytes / bw, flops / bf16_peak) * 1e3,
        "bound_by": "bytes" if nbytes / bw > flops / bf16_peak
        else "operations"}

    _, d, hdim, c = HEAD_SHAPES[0]
    x, w1, b1, w2, b2 = head_inputs(b, d, hdim, c, bf)
    b1_bf, b2_bf = b1.to(bf), b2.to(bf)
    seed = torch.tensor([1234], dtype=torch.int64, device="cuda")
    keep = torch.rand(b, hdim, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)) >= 0.5
    nbytes = ((x.numel() + w1.numel() + w2.numel() + b * hdim) * 2
              + (b1.numel() + b2.numel() + b * c) * 4 + 8)
    flops = 2 * b * hdim * (d + c)
    shapes["fusion_head_train"] = (b, d, hdim, c)
    rows["fusion_head_train"] = {
        "ms": time_ms(lambda: fusion_head.fusion_head_with_h(
            x, w1, b1, w2, b2, rate=0.5, seed=seed), flush),
        "plain_ms": time_ms(lambda: fusion_head.fusion_head_plain(
            x, w1, b1, w2, b2, 0.5, keep, with_h=True), flush),
        # a yardstick only: F.dropout draws from the global generator
        "library_ms": time_ms(lambda: torch.addmm(b2_bf, F.dropout(
            torch.relu(torch.addmm(b1_bf, x, w1.t())), 0.5, True), w2.t()),
            flush),
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(nbytes / bw, flops / bf16_peak) * 1e3,
        "bound_by": "bytes" if nbytes / bw > flops / bf16_peak
        else "operations"}
    after = clocks()
    for name, row in rows.items():
        emit({"phase": "time", "kernel": name, "dtype": "bfloat16",
              "clocks_after": after, "shape": list(shapes[name]), **row,
              **card})
    return rows


def forward_split(predictor, images, feats, card):
    """Device time of one batch-64 forward and of its trunk, beside the
    host-clock time per chunk of ``Predictor.predict``."""
    model = predictor.model
    with torch.inference_mode():
        x = torch.from_numpy(images[:64]).cuda().float() / 255.0
        f = torch.from_numpy(feats[:64]).cuda()
        fwd = time_ms(lambda: model(x, f))
        trunk = time_ms(lambda: model.trunk(
            x, upto="layer4", capture=("layer3",)))
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
# CUDA-core body, (2, 30, ..) 15x15 quadrants on the tensor-core body
QUADRANT_TRAIN_SHAPES = [(16, 14, 256, 128), (3, 28, 32, 16), (2, 6, 4, 2),
                         (2, 30, 16, 16), (TRAIN_BATCH, 14, 256, 128)]
HEAD_TRAIN_SHAPES = [(64, 256, 512, 8), (8, 64, 32, 8), (70, 264, 40, 5),
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
            want_out, want_act = quadrant.quadrant_process_plain(
                fmap.float(), k32, bias, with_act=True)
            torch.cuda.synchronize()
            err, rel = compare(out, want_out)
            act_err, act_rel = compare(act, want_act)
            row = {"phase": "check", "kernel": "quadrant_train",
                   "shape": list(shape), "dtype": dname, "max_abs_err": err,
                   "max_rel_err": rel, "act_max_rel_err": act_rel,
                   "tol": TOL[dname]}
            ok = (out.dtype == dtype and act.dtype == dtype
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
            _, h_same = fusion_head.fusion_head_with_h(
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
                   "other_seed_other_mask": not torch.equal(h, h_diff),
                   "max_abs_err": err, "max_rel_err": rel,
                   "h_max_rel_err": h_rel, "tol": tol}
            ok = (0.4 < frac < 0.6 and kept_rel <= tol and logit_rel <= tol
                  and mask_ok and row["same_seed_same_mask"]
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
    eval step with padded rows."""
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
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from surya_tpu_torch.ops.cuda import KERNELS, _build
    from surya_tpu_torch.ops.cuda import fusion_head, quadrant, stem_bn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_info()
    name = torch.cuda.get_device_name(0)
    card = {"card": name, "nvidia_smi": smi}
    emit({"phase": "card", "nvidia_smi": smi, "clocks": clocks(),
          "torch": torch.__version__,
          "cuda": torch.version.cuda, **card})

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    emit({"phase": "build", "kernels": list(KERNELS),
          "seconds": time.perf_counter() - t0})

    checks = check_kernels(quadrant, fusion_head)
    quadrant_train = check_quadrant_train(quadrant)
    head_train = check_head_train(fusion_head)
    check_stem_bn(stem_bn)
    predictor, images, feats, serve_launches = serve_phase(
        quadrant, fusion_head, card)
    times = time_phase(quadrant, fusion_head, card)
    forward_split(predictor, images, feats, card)
    serve_throughput(predictor, images, feats, card)
    del predictor
    train_launches = train_phase(quadrant, fusion_head, card)
    train_f32_parity(card)
    torch.cuda.empty_cache()
    stem_launches, stem_times = stem_probe(stem_bn, card)
    times.update(stem_times)

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
    kernels = []
    for kname, (source, replaces, launches, check) in table.items():
        if launches < 1:
            raise AssertionError(f"{kname} was never launched on its path")
        t = times[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"surya_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": check["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
