"""What every cell shares: finding a cell's files by name, the streams
drawn from ``--seed``, the weights made from it on the device, the
result line, and the guards of a run (the card, the JAX packages).

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: its
configuration is ``configs/<config>.json`` and its traffic
``traffic/<traffic>.json``, which names its driver module
``drivers/<driver>.py``; each per-layer metric is
``layer_metrics/<name>.py``. Nothing here names a cell, a configuration
or a metric, so a later cell is new files and new entries.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent          # h100bench/
ROOT = HERE.parent                              # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"
# top-level modules that may never be loaded by a run (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "surya_tpu")


class NoCard(RuntimeError):
    """The machine lacks the cards a cell asks for."""


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, name: str, bench: dict | None = None,
                 base: Path = HERE):
        bench = load_json(BENCHMARK) if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        self.name, self.base, self.bench = name, base, bench
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(base / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(base / "traffic" / f"{self.entry['traffic']}.json")
        self.driver_path = base / "drivers" / f"{self.traffic['driver']}.py"

    def driver(self):
        return load_module(self.driver_path, f"h100bench_driver_{self.traffic['driver']}")

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def metric_reader(self, name: str):
        return load_module(self.base / "layer_metrics" / f"{name}.py",
                           "h100bench_metric_" + name.replace(".", "_")
                           .replace("-", "_"))


# ---------------------------------------------------------------------------
# Streams from the seed
# ---------------------------------------------------------------------------

def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed that is a fixed function of ``--seed`` and ``names``
    (integers or strings): each stream of a run draws from its own."""
    h = hashlib.sha256(repr((int(seed),) + tuple(names)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *names):
    """A generator on ``device`` seeded with ``seed`` itself, or with the
    stream ``names`` of it."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *names) if names else seed)
    return g


def make_weights(shapes: dict, seed: int, device, fan_in) -> dict:
    """Every leaf of ``shapes`` ({name: shape}) as an f32 tensor on
    ``device``, its weights drawn from ``seed`` in one normal draw (scaled
    by 1/√fan-in). Biases start at 0; BN scales and running variances at 1,
    shifts and running means at 0."""
    import torch

    names = list(shapes)
    weights = [n for n in names if fan_in(n, shapes[n]) is not None]
    total = sum(math.prod(shapes[n]) for n in weights)
    normal = torch.randn(total, generator=generator(device, seed, "weights"),
                         device=device)
    out, at = {}, 0
    for n in names:
        shape = shapes[n]
        k = math.prod(shape)
        if n in weights:
            out[n] = normal[at:at + k].view(shape) / math.sqrt(
                fan_in(n, shape))
            at += k
        elif n.rpartition(".")[2] in ("weight", "running_var") and (
                n.rpartition(".")[0] + ".running_mean" in shapes):
            out[n] = torch.ones(shape, device=device)
        else:
            out[n] = torch.zeros(shape, device=device)
    return out


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

class Run:
    """The state of one run: its arguments, its start, its device."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", started: float | None = None,
                 small: dict | None = None):
        self.cell, self.seed, self.seconds, self.trace = (cell, int(seed),
                                                          float(seconds), trace)
        self.device = device
        self.started = time.perf_counter() if started is None else started
        # smaller sizes for the CPU tests; a benchmark run has none
        self.small = small or {}
        self.checks: list = []     # (name, value, limit)
        self.readings: dict = {}   # numbers read and not compared
        self.phases: dict = {}     # set-up phase → seconds since start
        self.tmp = Path(os.environ.get("TMPDIR") or "/tmp")

    def mark(self, phase: str) -> None:
        """Note the end of a set-up phase (printed on standard error)."""
        self.phases[phase] = time.perf_counter() - self.started

    def size(self, key: str, default):
        return self.small.get(key, default)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    def judge(self, numbers: dict) -> None:
        """Compare each number that the cell's ``limits/<cell>.json``
        gives a limit; keep the others as readings."""
        limits = load_json(self.cell.base / "limits" /
                           f"{self.cell.name}.json")
        for name, value in numbers.items():
            if name in limits:
                self.check(name, value, limits[name])
            else:
                self.readings[name] = float(value)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} cards, the cell asks "
                     f"for {chips}")


def forbidden_modules() -> list:
    """The forbidden top-level packages that this process has loaded."""
    top = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def device_info(chips: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "unknown"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result_line(run: Run, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown: dict | None = None) -> str:
    out = {"correct": run.correct, "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return json.dumps(out)
