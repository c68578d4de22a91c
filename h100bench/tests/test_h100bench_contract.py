"""BENCHMARK.json keeps to its schema: shapes, characters and lengths, every
cell finds its files by name, each configuration file states what the
program runs, and nothing the benchmark reaches loads a JAX package."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import harness as H

BENCH = json.loads(H.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert (H.ROOT / BENCH["command"][1]).is_file()
    assert len(H.BENCHMARK.read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200, entry
                    assert "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for group, keys in allowed.items():
        for entry in BENCH[group]:
            assert set(entry) <= keys, entry
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(name):
    cell = H.Cell(name, BENCH)
    assert cell.driver_path.is_file()
    assert hasattr(cell.driver(), "execute")
    assert (H.HERE / "limits" / f"{name}.json").is_file()
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(cell.traffic["metrics"]) == e2e
    layer = cell.per_layer()
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert hasattr(cell.metric_reader(m["name"]), "read")


def test_every_metric_reader_and_config_is_used():
    used = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (H.HERE / "layer_metrics").glob("*.py")}
    assert files == used
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        path = H.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("h100bench/")
        assert path.stem == c["name"]
        assert H.load_json(path)["reduced"] == c["reduced"] == []


def test_run_seconds_fit_the_check():
    n = 24   # the most cells a benchmark may hold
    total = ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90
             + 1200)
    assert total <= 43200


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_the_program(config):
    """The model section the reference reads is the preset the program
    runs, at the published widths."""
    import counts
    from surya_tpu_torch.core.config import get_preset

    spec = H.load_json(H.HERE / "configs" / f"{config}.json")
    cfg = get_preset(spec["preset"]).override(spec["overrides"])
    m = spec["model"]
    assert cfg.model.backbone == m["backbone"]
    assert cfg.model.num_classes == m["classes"] == m["head"][2]
    assert cfg.model.compute_dtype == m["compute_dtype"]
    assert cfg.data.image_size == m["image_size"]
    assert cfg.train.lr == spec["train"]["lr"]
    assert cfg.train.weight_decay == spec["train"]["weight_decay"]
    assert cfg.train.grad_clip == spec["train"]["grad_clip"]
    assert cfg.train.label_smoothing == spec["train"]["label_smoothing"]
    assert cfg.train.nan_guard == spec["train"]["nan_guard"]
    assert counts.head_in(m, m["image_size"]) == m["head"][0]
    d = cfg.data
    a = spec["augment"]
    assert (d.rrc_scale_min, d.hflip_prob, d.rotation_deg) == (
        a["scale_min"], a["hflip_prob"], a["rotation_deg"])
    assert [d.jitter_brightness, d.jitter_contrast, d.jitter_saturation,
            d.jitter_hue] == a["jitter"]
    assert [d.blur_sigma_min, d.blur_sigma_max] == a["blur_sigma"]
    assert (cfg.model.dropout or 0.5) == m["dropout"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_in_the_sources():
    for path in H.HERE.rglob("*.py"):
        assert not _imports(path) & set(H.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (H.HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "numpy", "torch"}, (
            path, _imports(path))


def test_nothing_a_run_reaches_loads_jax(tmp_path):
    """Every cell driven on the CPU in a fresh process, with every reader
    of its metrics: no JAX package by whole top-level name."""
    code = f"""
import os, sys
sys.path[:0] = [{str(H.HERE)!r}, {str(H.ROOT)!r}]
os.environ["TMPDIR"] = {str(tmp_path)!r}
import torch
torch.set_num_threads(2)
sys.path.insert(0, {str(H.HERE / "tests")!r})
from conftest import SMALL
import harness as H
import run as R
for name in {CELLS!r}:
    cell = H.Cell(name)
    for trace in (False, True):
        r = H.Run(cell, 3, 0.2, trace, "cpu", small=SMALL)
        R.finish(r, cell.driver().execute(r))
print("LOADED", H.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_run_without_a_card_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, str(H.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=H.ROOT)
    try:
        import torch

        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if has_card:
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert "{" not in out.stdout
