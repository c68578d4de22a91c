"""The traffic generator: the training pack repeats for a seed, every seed
draws a pack of the same sizes, and a later cell needs only new files."""

import json
import shutil

import numpy as np

import harness as H

CELL = "quadtree-fusion.train-b256"


def _pack(small_run, out, seed):
    run = small_run(CELL, seed)
    arrays = run.cell.driver().make_pack(run, out)
    files = {p.relative_to(out): p.read_bytes()
             for p in sorted(out.rglob("*")) if p.is_file()}
    return arrays, files


def test_pack_repeats_for_a_seed(small_run, tmp_path):
    big = 2 ** 31 + 12345
    a, fa = _pack(small_run, tmp_path / "a", big)
    b, fb = _pack(small_run, tmp_path / "b", big)
    c, fc = _pack(small_run, tmp_path / "c", big + 1)
    assert fa == fb
    np.testing.assert_array_equal(a["features"], b["features"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert fa != fc
    assert not np.array_equal(a["labels"], c["labels"])


def test_every_seed_draws_the_same_sizes(small_run, tmp_path):
    share = H.Cell(CELL).traffic["feature_nan_share"]
    sizes = set()
    for seed in (0, 7, 2 ** 32 + 5):
        arrays, files = _pack(small_run, tmp_path / str(seed), seed)
        f, y = arrays["features"], arrays["labels"]
        assert f.shape == (32, 47) and y.shape == (32,)
        assert 0 < np.isnan(f).mean() < 3 * share
        assert 0 <= y.min() and y.max() < 8
        sizes.add(tuple((k, len(v)) for k, v in files.items()
                        if not k.suffix == ".json"))
    assert len(sizes) == 1


def test_a_new_cell_is_new_files_only(tmp_path, small_run):
    """A copy of the benchmark gains a traffic mix, its limits and a cell
    by new files and one new entry; nothing that was there changes, and
    the cell runs."""
    base = tmp_path / "h100bench"
    shutil.copytree(H.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    traffic = H.load_json(base / "traffic" / "train-b256.json")
    traffic["batch"] = 128
    (base / "traffic" / "train-b128.json").write_text(json.dumps(traffic))
    (base / "limits" / "quadtree-fusion.train-b128.json").write_text(
        (base / "limits" / f"{CELL}.json").read_text())
    bench = H.load_json(H.BENCHMARK)
    bench["workloads"].append({"name": "quadtree-fusion.train-b128",
                               "config": "quadtree-fusion",
                               "traffic": "train-b128", "chips": 1,
                               "why": "batch 128"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("quadtree-fusion.train-b128")
    for p, data in before.items():
        assert p.read_bytes() == data
    cell = H.Cell("quadtree-fusion.train-b128", bench, base)
    run = small_run(None, cell=cell)
    out = cell.driver().execute(run)
    assert out["attempted"] > 0 and run.correct
