"""Smoke run of the PyTorch port (``surya_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``surya_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, serves the
flagship ``quadtree-fusion`` model (resnet18 trunk, 224 px, 8 classes,
random weights from seed 0, bf16 weights, uint8 wire, batch 64) over
HTTP through ``PredictionServer``/``Predictor``, checks that those
requests launched both kernels, and times kernels and serving with CUDA
events. One JSON line per phase; then the card's name and power limit as
``nvidia-smi`` reports them, the ``kernels`` line, and the result line
``{"ok": true, "device": {...}}`` last. Any failed check raises, and the
script exits non-zero without a result line. It needs a CUDA device and
the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

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
    after = clocks()
    for name, row in rows.items():
        emit({"phase": "time", "kernel": name, "dtype": "bfloat16",
              "clocks_after": after,
              "shape": list(QUADRANT_SHAPES[0] if name == "quadrant"
                            else HEAD_SHAPES[0]), **row, **card})
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from surya_tpu_torch.ops.cuda import KERNELS, _build
    from surya_tpu_torch.ops.cuda import fusion_head, quadrant

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
    predictor, images, feats, launches = serve_phase(
        quadrant, fusion_head, card)
    times = time_phase(quadrant, fusion_head, card)
    forward_split(predictor, images, feats, card)
    serve_throughput(predictor, images, feats, card)

    flagship = {"quadrant": ("quadrant", QUADRANT_SHAPES[0]),
                "fusion_head": ("fusion_head", HEAD_SHAPES[0])}
    replaces = {"quadrant": "surya_tpu/ops/pallas/quadrant.py:78",
                "fusion_head": "surya_tpu/ops/pallas/fusion_head.py:47"}
    kernels = []
    for kname in KERNELS:
        check = checks[(*flagship[kname][:1], tuple(flagship[kname][1]),
                        "bfloat16")]
        t = times[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"surya_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces[kname], "launches": launches[kname],
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
