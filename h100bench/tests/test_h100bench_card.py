"""Each cell run on its cards for a short window, through ``run.py``: the
result line's keys and ``correct``. Marked ``cuda``; each test looks for
the cards it needs when it runs and skips without them.

    python -m pytest h100bench/tests -m cuda     # on a machine with cards
"""

import json
import subprocess
import sys

import pytest

import harness as H

BENCH = json.loads(H.BENCHMARK.read_text())


def _cards() -> int:
    try:
        import torch
    except ImportError:
        return 0
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cell, trace):
    if _cards() < cell["chips"]:
        pytest.skip(f"needs {cell['chips']} CUDA cards")
    out = subprocess.run(
        [sys.executable, str(H.HERE / "run.py"), "--workload", cell["name"],
         "--seed", str(2 ** 31 + 17), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, timeout=1200,
        cwd=H.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == cell["chips"]
    assert list(line)[-1] == "checks"
    names = set(line["metrics"])
    if trace:
        assert line["device"]["busy_s"] > 0
        assert names and all(
            m["name"] in {p["name"] for p in BENCH["per_layer"]}
            for m in ({"name": n} for n in names))
    else:
        assert "setup_s" in names and len(names) >= 2
