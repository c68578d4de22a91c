"""The traced slice: ``torch.profiler`` (CPU + CUDA) over a few steps or
requests after the measured window, read back from its chrome trace.

A kernel is attributed to a host range (an operator, or a range the
benchmark opened with ``record_function``) when the runtime call that
launched it lies inside that range on the same thread; CUPTI's
correlation id links the call to the kernel. That attribution holds for
the kernels the program launches through ``ctypes`` too.
"""

from __future__ import annotations

import bisect
import json
import os
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
STEP = "h100bench.step"     # the range around each step or request


def profiled(body, tmp: Path, device: str) -> "Trace":
    """Run ``body()`` under the profiler, wait for the device, and read
    the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        body()
        if device != "cpu":
            torch.cuda.synchronize()
    path = tmp / f"h100bench-trace-{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return Trace(events)


def union(intervals) -> list:
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Times in microseconds, as the chrome trace keeps them."""

    def __init__(self, events: list):
        self.device, self.launch, self.host = [], [], []
        for e in events:
            cat, ph = e.get("cat", ""), e.get("ph")
            if ph != "X":
                continue
            args = e.get("args", {})
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((e["name"], ts, dur, args.get("correlation"),
                                    cat, args.get("device", 0)))
            elif cat in LAUNCH_CATS:
                self.launch.append((ts, e.get("tid"), args.get("correlation")))
            elif cat in HOST_CATS:
                self.host.append((e["name"], ts, dur, e.get("tid")))
        self.launch.sort()
        steps = [h for h in self.host if h[0] == STEP]
        self.steps = len(steps)
        self.main_tid = steps[0][3] if steps else None
        end = max([h[1] + h[2] for h in steps]
                  + [d[1] + d[2] for d in self.device], default=0.0)
        self.start = min((h[1] for h in steps), default=0.0)
        self.end = end

    # -- attribution --------------------------------------------------------

    def ranges(self, match) -> list:
        return [h for h in self.host if match(h[0])]

    def correlations_under(self, match) -> set:
        """Correlation ids of the runtime calls inside the host ranges
        whose name satisfies ``match``."""
        times = [x[0] for x in self.launch]
        out = set()
        for _, ts, dur, tid in self.ranges(match):
            lo = bisect.bisect_left(times, ts)
            hi = bisect.bisect_right(times, ts + dur)
            out.update(c for t, tt, c in self.launch[lo:hi] if tt == tid)
        return out

    def device_us(self, kernels=None, under=None, cats=DEVICE_CATS) -> float:
        """Device time of the kernels whose name satisfies ``kernels`` or
        that were launched under a host range satisfying ``under``."""
        corr = self.correlations_under(under) if under else set()
        return sum(d[2] for d in self.device if d[4] in cats and (
            (kernels is not None and kernels(d[0])) or d[3] in corr))

    def calls(self, match) -> int:
        """Host ranges satisfying ``match`` that no other such range on
        their thread contains (an operator recorded at two levels counts
        once)."""
        n, ends = 0, {}
        for _, ts, dur, tid in sorted(self.ranges(match), key=lambda h: h[1]):
            if ts >= ends.get(tid, float("-inf")):
                n += 1
                ends[tid] = ts + dur
        return n

    def host_us(self, match) -> float:
        return sum(h[2] for h in self.ranges(match))

    # -- the device's timeline ---------------------------------------------

    def busy(self) -> list:
        return union((d[1], d[1] + d[2]) for d in self.device
                     if self.start <= d[1] <= self.end)

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def window_us(self) -> float:
        return self.end - self.start

    def idle_share(self) -> float:
        """% of the slice in which the device ran nothing."""
        return 100.0 * (1.0 - self.busy_us() / self.window_us())

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for d in self.device:
            total[d[0][:160]] = total.get(d[0][:160], 0.0) + d[2]
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us * 1e-6] for name, us in ranked]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest idle gaps of the device inside the slice, each
        named by what the main thread was doing at its middle: the
        benchmark's range, then the innermost operator."""
        busy = self.busy()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        main = [h for h in self.host if h[3] == self.main_tid]
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            inside = sorted((h for h in main if h[1] <= mid <= h[1] + h[2]),
                            key=lambda h: h[1])
            ours = [h[0] for h in inside if h[0].startswith("h100bench.")]
            ops = [h[0] for h in inside if not h[0].startswith("h100bench.")]
            label = " > ".join((ours[-1:] or ["outside a step"]) + ops[-1:])
            out.append([label[:160], (b - a) * 1e-6])
        return out

