"""The benchmark of ``surya_tpu_torch`` on NVIDIA H100 cards.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it finds the cell in ``BENCHMARK.json``, its
configuration, traffic and driver by name, sets up (counted in
``setup_s``), measures for ``--seconds``, profiles a short slice after
the window with ``--trace 1``, checks the timed path's outputs against the
plain reference in ``reference/``, and prints one JSON line last. The
numbers compared go to standard error as its last lines, and into the
line under ``checks``. It exits non-zero with no result when the machine
lacks the cards the cell asks for, or when a JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]
# every compile cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"

import harness as H  # noqa: E402


class Record:
    """What a per-layer metric reads: the traced slice and the window."""

    def __init__(self, run, out: dict):
        self.run, self.out = run, out
        self.trace = out["trace"]
        self.window = out["window"]
        self.model = out["model"]
        self.image_size = out["image_size"]
        self.training = out["training"]
        self.call_batch = out["call_batch"]
        self.chips = run.cell.chips
        self.traffic = run.cell.traffic

    @property
    def slice_steps(self) -> int:
        return self.trace.steps

    def mfu(self) -> float:
        import counts

        flops = self.out["flops_per_image"] * self.window["images"]
        return 100.0 * flops / self.window["seconds"] / (
            counts.PEAK_BF16_FLOPS * self.chips)

    def idle(self) -> float:
        return self.trace.idle_share()

    def roofline(self, ops: tuple, count) -> float | None:
        """100 × (least seconds of the calls' work) / (device seconds
        attributed to the operator ``ops``); None without a call."""
        import counts

        match = ops.__contains__
        calls = self.trace.calls(match)
        us = self.trace.device_us(under=match)
        if not calls or us <= 0:
            return None
        work = count(self.model, self.image_size, self.call_batch,
                     self.training, self.traffic["param_dtype"])
        return 100.0 * calls * counts.bound_s(work) / (us * 1e-6)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = H.Cell(a.workload)
    try:
        H.require_cards(cell.chips)
    except H.NoCard as e:
        print(f"h100bench: {e}", file=sys.stderr)
        return 3
    run = H.Run(cell, a.seed, a.seconds, bool(a.trace), "cuda", STARTED)
    out = cell.driver().execute(run)
    line = finish(run, out)
    print(f"h100bench: {cell.name} seed {a.seed} on {H.power_limit()}",
          file=sys.stderr)
    print("h100bench: set-up phases (s since start) " + " ".join(
        f"{k}={v:.3f}" for k, v in run.phases.items()), file=sys.stderr)
    bad = H.forbidden_modules()
    if bad:
        print(f"h100bench: loaded {bad}, which a run may not load",
              file=sys.stderr)
        return 4
    for name, value in run.readings.items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(line, flush=True)
    return 0


def finish(run, out: dict) -> str:
    """The result line of a run."""
    cell = run.cell
    device = H.device_info(cell.chips, out["peak"]) if run.device != "cpu" \
        else {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}
    metrics, breakdown = {}, None
    if not run.trace:
        names = cell.traffic["metrics"]
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": out[names[m["name"]]],
                                  "unit": m["unit"]}
    else:
        rec = Record(run, out)
        for m in cell.per_layer():
            value = cell.metric_reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out["trace"]
        device["busy_s"] = tr.busy_us() * 1e-6
        device["window_s"] = tr.window_us() * 1e-6
        breakdown = {"device_ops": tr.top_ops(10),
                     "idle_gaps": tr.idle_gaps(10)}
    return H.result_line(run, out["attempted"], out["failed"], metrics,
                         device, breakdown)


if __name__ == "__main__":
    sys.exit(main())
