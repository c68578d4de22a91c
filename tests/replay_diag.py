"""Replay rows trained through either package's CLI, so that the port's
training is held against JAX's own loop off the TPU, on one pack.

    python tests/replay_diag.py --side jax|port --preset experiment-fusion \\
        --seeds 0,1,2 [--epochs 15] [--root build/replay224] \\
        [--out runs/torch_replay/diag] [--set data.augment=false --tag noaug]
        [--device card] [--init-from DIR [--jax-masks]]

``--root`` is the replay set that ``python -m surya_tpu_torch.bench.replay
--phase data`` writes (byte-equal packs from either CLI). Each run goes to
``OUT/<side>_<where>/<preset>_s<seed>/`` (``<preset>-<epochs>ep-<tag>`` with
``--epochs`` and ``--tag``; ``--set`` adds config overrides, and needs
``--tag``): the CLI's ``config.json`` and ``metrics.jsonl``, and a
``result.json`` in the campaign's layout (``bench.replay.run_job``'s) with
the card, or the host in place of one. ``--side jax`` runs ``python -m
surya_tpu train`` with ``JAX_PLATFORMS=cpu`` (``jax_cpu``); ``--side port``
runs ``python -m surya_tpu_torch train --device cpu`` (``port_cpu``), or on
the card with ``--device card`` (``port_card``). A run with a test result
is skipped. Every run is at f32.

``--side jax --save-inits DIR`` writes JAX's initial variables of each seed,
as its loop makes them, to ``DIR/<preset>_s<seed>.npz``, and JAX's
fused-head dropout masks of every step to ``DIR/<preset>_s<seed>_masks.npz``
(``flax`` ``Dropout`` under ``classifier`` on the step's ``dropout`` key,
the draw JAX's replay made with ``use_pallas: false``). ``--side port
--init-from DIR`` starts the port's CLI run from those weights (the side
gains ``_jaxinit``), so the two loops differ only in their draws and
arithmetic; with ``--jax-masks`` the head also drops JAX's units (the
plain head, ``_jaxdraws``), so only the arithmetic differs. That needs a
model whose only random draw per step is its fused head, such as
``ji-3dcnn``: any other dropout draw raises.

    python tests/replay_diag.py --coupled ji-3dcnn --epochs 1

runs arm (a) of ``tests/test_torch_loop_coupled.py`` on the full replay
set on the CPU: JAX's ``train_and_evaluate`` with its dropout masks
captured, then the port's fed JAX's augmentation parameters and masks,
both from JAX's initial weights; prints both loss curves as one JSON
object.

    python tests/replay_diag.py --curves experiment-fusion [--epochs 8 --tag bf16]

prints, as one JSON object, the row's per-epoch train and validation
losses, seed by seed and their mean, from JAX's TPU runs
(``runs/reference_replay``), the port's card runs (``runs/torch_replay``)
and the runs under ``OUT`` (``--epochs``/``--tag`` name a variant).

    python tests/replay_diag.py --mask-law --seeds 0,1,...,39

trains ``ji-3dcnn`` on the coupled test's arm (b) pack inside the port,
each seed from JAX's initial weights twice, with JAX's head masks and
with the port's own, and prints the loss gaps (:func:`mask_law`).

    python tests/replay_diag.py --table

writes :func:`vs_jax_cpu` of the runs under ``OUT`` into the campaign's
``table.json`` (beside ``OUT``) as its ``vs_jax_cpu`` block.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import platform
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from surya_tpu_torch.bench.replay import (  # noqa: E402
    JAX_REPLAY,
    T4,
    TEMPORAL_PRESETS,
    _last_json,
    bands,
    card_record,
    load_result,
    overlap,
)

INIT_ENV = "REPLAY_DIAG_INIT"    # the .npz a ``--init-from`` child loads
MASKS_ENV = "REPLAY_DIAG_MASKS"  # the head masks a ``--jax-masks`` child uses
REFERENCE = ("jax_cpu", "jax_tpu")   # what every other side is paired with


def host_record() -> dict:
    model = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"card": None, "nvidia_smi": None,
            "host": f"{model}, {os.cpu_count()} logical CPUs"}


def data_overrides(preset: str, root: str) -> dict:
    if preset in TEMPORAL_PRESETS:
        t = 4 if preset in T4 else 5
        return {"data.seq_root": f"{root}/temporal",
                "data.packed_dir": f"{root}/temporal_packed_t{t}"}
    return {"data.data_root": f"{root}/spatial",
            "data.packed_dir": f"{root}/spatial_packed"}


def save_jax_inits(preset: str, seeds, overrides: dict, out_dir: str):
    """JAX's initial variables of each seed, as ``train_and_evaluate``
    makes them (``create_train_state`` on the first batch's transform),
    as ``/``-keyed ``.npz`` files (``core.checkpoint.load_params``), and
    the fused head's dropout mask of every step of every epoch."""
    import jax

    from surya_tpu.__main__ import _build_data
    from surya_tpu.core.config import get_preset
    from surya_tpu.core.prng import PRNG
    from surya_tpu.models import get_model
    from surya_tpu.train.steps import create_train_state

    os.makedirs(out_dir, exist_ok=True)
    for seed in seeds:
        cfg = get_preset(preset).override(
            {**overrides, "train.seed": str(seed)})
        data, prng, model = _build_data(cfg), PRNG(seed), get_model(cfg.model)
        sample = data.device_transform(
            "train", prng.named(0, "augment"),
            next(iter(data.train_batches(0))))
        state, _ = create_train_state(model, cfg, prng.named(0, "init"),
                                      sample)
        flat = {}
        for col in ("params", "batch_stats"):
            for path, v in jax.tree_util.tree_flatten_with_path(
                    getattr(state, col))[0]:
                flat["/".join([col] + [p.key for p in path])] = np.asarray(v)
        np.savez(os.path.join(out_dir, f"{preset}_s{seed}.npz"), **flat)
        hidden = flat["params/classifier/fc1/kernel"].shape[1]
        steps = cfg.train.epochs * sum(1 for _ in data.train_batches(1))
        keep = head_masks(prng, steps, cfg.data.batch_size, hidden,
                          model.dropout)
        np.savez(os.path.join(out_dir, f"{preset}_s{seed}_masks.npz"),
                 bits=np.packbits(keep, axis=-1), units=hidden,
                 seed=seed, rate=model.dropout)


def head_masks(prng, steps: int, rows: int, units: int, rate: float):
    """(steps, rows, units) bool: the units flax's ``Dropout`` keeps under
    a top-level ``classifier`` on each step's ``dropout`` key. The
    ``rngs`` stream folds in the module path only, so a two-module stand-in
    with the same names draws the model's mask."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    class Classifier(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dropout(rate, deterministic=False)(x)

    class Model(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Classifier(name="classifier")(x)

    ones = jnp.ones((rows, units))
    draw = jax.jit(lambda key: Model().apply({}, ones,
                                              rngs={"dropout": key}) != 0)
    return np.stack([np.asarray(draw(prng.named(s, "dropout")))
                     for s in range(steps)])


def _use_jax_masks(path: str, mp):
    """Patch (``mp.setattr``) the port's fused head to drop the units in
    ``path`` (the plain head, by the step the dropout generator was seeded
    for), and any other dropout draw to raise."""
    import torch

    from surya_tpu_torch.core.prng import PRNG
    from surya_tpu_torch.models import common
    from surya_tpu_torch.ops.cuda.fusion_head import fusion_head_plain

    saved = np.load(path)
    units = int(saved["units"])
    keep = np.unpackbits(saved["bits"], axis=-1, count=units).astype(bool)
    prng, rate = PRNG(int(saved["seed"])), float(saved["rate"])
    step_of = {prng.seed_of(s, "dropout"): s for s in range(len(keep))}
    draw = common.dropout_generator

    def forward(self, x, generator=None):
        if draw(generator, self.dropout, self.training) is None:
            return fusion_head_plain(x.to(self.dtype), self.fc1.weight,
                                     self.fc1.bias, self.fc2.weight,
                                     self.fc2.bias)
        assert self.dropout == rate
        mask = torch.from_numpy(keep[step_of[generator.initial_seed()]])
        return fusion_head_plain(x.to(self.dtype), self.fc1.weight,
                                 self.fc1.bias, self.fc2.weight,
                                 self.fc2.bias, rate, mask.to(x.device))

    def no_other_draw(generator, rate, training):
        if draw(generator, rate, training) is not None:
            raise RuntimeError("--jax-masks covers the fused head only")

    mp.setattr(common.FusionClassifier, "forward", forward)
    mp.setattr(common, "dropout_generator", no_other_draw)


def _from_init(path: str, mp):
    """Patch the port's loop to build its model from the variables in
    ``path``."""
    from surya_tpu_torch.core.checkpoint import load_params
    from surya_tpu_torch.train import loop

    build = loop.get_model

    def get_model(cfg, image_size=224, seed=0):
        model = build(cfg, image_size=image_size, seed=seed)
        model.load_state_dict(load_params(path), strict=True)
        return model

    mp.setattr(loop, "get_model", get_model)


def train_from_init(argv) -> int:
    """``python tests/replay_diag.py train ...``: the port's CLI ``train``
    whose model starts from the variables in ``$REPLAY_DIAG_INIT`` (and
    whose head drops the units in ``$REPLAY_DIAG_MASKS``, if set)."""
    import pytest

    from surya_tpu_torch.__main__ import main as cli

    mp = pytest.MonkeyPatch()
    _from_init(os.environ[INIT_ENV], mp)
    if os.environ.get(MASKS_ENV):
        _use_jax_masks(os.environ[MASKS_ENV], mp)
    return cli(["train", *argv])


def mask_law(seeds) -> dict:
    """The head's draws inside the port: ``ji-3dcnn`` on the coupled
    test's arm (b) pack (``JI_COUNTS``, ``JI_RUN``), each seed from JAX's
    initial weights and order, once with JAX's head masks (JAX's loop to
    float error, as arm (a) shows) and once with the port's Philox masks.
    → per seed the (train, val) loss gap averaged over the epochs
    (Philox − JAX's masks), its mean and standard error over all seeds
    and over blocks of 8."""
    import pathlib
    import tempfile

    import pytest

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_loop_coupled as arm

    from surya_tpu_torch.core.metrics import MetricsLogger
    from surya_tpu_torch.data.packed import PackedSequenceSource
    from surya_tpu_torch.train import loop

    root = arm.write_ji_pack(pathlib.Path(tempfile.mkdtemp()))
    gaps = []
    for seed in seeds:
        cfg, _ = arm._configs("ji-3dcnn", root, seed, **arm.JI_RUN)
        ov = {"data.seq_root": cfg.data.seq_root,
              "data.packed_dir": cfg.data.packed_dir,
              "data.image_size": str(cfg.data.image_size),
              "data.batch_size": str(cfg.data.batch_size),
              "train.epochs": str(cfg.train.epochs),
              "model.compute_dtype": "float32"}
        save_jax_inits("ji-3dcnn", [seed], ov, str(root))
        stem = str(root / f"ji-3dcnn_s{seed}")
        losses = []
        for jax_masks in (True, False):
            with pytest.MonkeyPatch.context() as mp:
                _from_init(stem + ".npz", mp)
                if jax_masks:
                    _use_jax_masks(stem + "_masks.npz", mp)
                got = loop.train_and_evaluate(
                    cfg, PackedSequenceSource(cfg.data, seed=seed),
                    logger=MetricsLogger(echo=False), checkpoints=False,
                    device="cpu")
            losses.append(arm._losses(got))
        gaps.append((losses[1] - losses[0]).mean(0).tolist())
        print(json.dumps({"seed": seed, "gap": gaps[-1]}), flush=True)
    g = np.array(gaps)

    def summary(x):
        return {"mean": x.mean(0).tolist(),
                "se": (x.std(0, ddof=1) / np.sqrt(len(x))).tolist()}

    return {"seeds": list(seeds), "gaps": gaps, "all": summary(g),
            "blocks_of_8": [summary(g[i:i + 8])
                            for i in range(0, len(g) - 7, 8)]}


def run_cli(launcher: list, name: str, preset: str, out_dir: str,
            overrides: dict, device=None, card=None) -> dict:
    """One run: ``python <launcher> train`` in a child → the
    ``result.json`` written in ``bench.replay.run_job``'s layout, or an
    error row."""
    os.makedirs(out_dir, exist_ok=True)
    args = [sys.executable, *launcher, "train", "--preset", preset,
            "--out", out_dir, *[f"--{k}={v}" for k, v in overrides.items()]]
    if device is not None:
        args += ["--device", device]
    t0 = time.time()
    proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True)
    wall = time.time() - t0
    seed = int(overrides["train.seed"])
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"exit {proc.returncode}")
        summary = _last_json(proc.stdout)
    except (RuntimeError, ValueError) as e:
        result = {"preset": name, "base_preset": preset, "seed": seed,
                  "error": f"{e}: {proc.stderr[-1500:]}", **card}
    else:
        result = {"best_epoch": summary["best_epoch"],
                  "best_metric": summary["best_metric"],
                  "test": summary["test"], "preset": name,
                  "base_preset": preset,
                  "overrides": {k: v for k, v in overrides.items()
                                if not k.startswith("data.")},
                  "seed": seed, "wall_seconds": round(wall, 1),
                  "runner": f"tests/replay_diag.py: python "
                            f"{' '.join(launcher)} train in a child per run",
                  "kernel_launches": summary.get("kernel_launches"),
                  **card}
        with open(os.path.join(out_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(card) + "\n")
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"run": out_dir, **result}), flush=True)
    return result


def coupled(preset: str, root: str, epochs: int, extra: dict) -> dict:
    """Arm (a) of ``test_torch_loop_coupled.py`` on the replay set, with
    the config overrides ``extra``."""
    import pytest

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_loop_coupled as arm

    from surya_tpu.core.config import get_preset as jax_preset
    from surya_tpu.core.mesh import single_device_mesh
    from surya_tpu_torch.core.config import get_preset

    ov = {**data_overrides(preset, root), "model.compute_dtype": "float32",
          "train.epochs": str(epochs), "train.seed": "0",
          "train.early_stop_patience": "0", "train.checkpoint_dir": "unused",
          **extra}
    cfg = get_preset(preset).override(ov)
    ref = jax_preset(preset).override(ov)
    pdata, jdata = arm._sources(cfg, ref, 0)
    with pytest.MonkeyPatch.context() as mp:
        got, want, masks = arm.run_coupled(cfg, ref, pdata, jdata,
                                           single_device_mesh(), mp)
    return {"preset": preset, "steps": len(masks),
            "port": arm._losses(got).tolist(),
            "jax": arm._losses(want).tolist()}


def curves(metrics_jsonl: str) -> list:
    """[(train_loss, val_loss)] by epoch from a loop's metrics.jsonl."""
    rows = {}
    with open(metrics_jsonl) as f:
        for line in f:
            r = json.loads(line)
            if "train_loss" in r:
                rows[r["epoch"]] = (r["train_loss"], r["val_loss"])
    return [rows[e] for e in sorted(rows)]


def compare(preset: str, out: str, name: str) -> dict:
    """Per source: each seed's (train, val) loss by epoch, and the mean
    over the seeds that reached the epoch."""
    runs = os.path.join(REPO, "runs")
    group = "temporal" if preset in TEMPORAL_PRESETS else "spatial"
    sources = {
        "jax_tpu": os.path.join(runs, "reference_replay", group,
                                f"{preset}_s*"),
        "port_card": os.path.join(runs, "torch_replay", group,
                                  f"{preset}_s*")}
    for side in sorted(os.listdir(out)) if os.path.isdir(out) else ():
        sources[f"diag/{side}"] = os.path.join(out, side, f"{name}_s*")
    table = {}
    for src, pattern in sources.items():
        seeds = {os.path.basename(d).rsplit("_s", 1)[1]: curves(
            os.path.join(d, "metrics.jsonl"))
            for d in sorted(glob.glob(pattern))
            if os.path.exists(os.path.join(d, "metrics.jsonl"))}
        if not seeds:
            continue
        longest = max(len(c) for c in seeds.values())
        mean = [np.mean([c[e] for c in seeds.values() if len(c) > e],
                        axis=0).round(4).tolist() for e in range(longest)]
        table[src] = {"seeds": seeds, "mean": mean}
    return table


# --- the vs_jax_cpu block of table.json ---------------------------------------

def _band(b: dict | None) -> dict | None:
    if b is None:
        return None
    return {"mean": b["mean"], "std": b["std"], "accs": b["accs"],
            "interval": [b["mean"] - b["std"], b["mean"] + b["std"]]}


def _mean_se(x) -> dict:
    """Mean and standard error (one, ddof 1) of the per-seed gaps."""
    x = np.asarray(x, dtype=float)
    se = float(x.std(ddof=1) / np.sqrt(len(x))) if len(x) > 1 else None
    return {"mean": float(x.mean()), "se": se}


def variant(row: str) -> str:
    """A row's name without its epoch cut: a cut run's epochs are the
    first epochs of the whole run (the learning rate follows the history
    alone)."""
    return re.sub(r"-\d+ep(?=-|$)", "", row)


def _runs(results: list) -> dict:
    """seed → (row, test accuracy, [(train, val)] by epoch); of two runs
    of one seed, the longer."""
    out = {}
    for path, r in results:
        m = os.path.join(os.path.dirname(path), "metrics.jsonl")
        if os.path.exists(m):
            run = (r["preset"], r["test"]["accuracy"], curves(m))
            if len(run[2]) > len(out.get(r["seed"], (0, 0, ()))[2]):
                out[int(r["seed"])] = run
    return out


def paired(ref: dict, side: dict) -> dict | None:
    """``side`` − ``ref`` seed by seed, at the seeds both ran: the test
    accuracy gaps of the seeds that trained the same row (the same cut)
    and, per epoch both reached, the mean train and validation loss gaps
    with their standard error. Only ``_jaxinit``/``_jaxdraws`` sides
    share JAX's initial weights; elsewhere a seed pairs the epoch order
    alone."""
    seeds = sorted(set(ref) & set(side))
    if not seeds:
        return None
    out = {"seeds": seeds}
    same = [s for s in seeds if ref[s][0] == side[s][0]]
    if same:
        gaps = [side[s][1] - ref[s][1] for s in same]
        out["test_accuracy"] = {"seeds": same, "gaps": gaps,
                                **_mean_se(gaps)}
    epochs = min(min(len(ref[s][2]), len(side[s][2])) for s in seeds)
    for i, key in enumerate(("train_loss", "val_loss")):
        per = [_mean_se([side[s][2][e][i] - ref[s][2][e][i] for s in seeds])
               for e in range(epochs)]
        out[key] = {"mean_gap": [round(p["mean"], 5) for p in per],
                    "se": [None if p["se"] is None else round(p["se"], 5)
                           for p in per]}
    return out


def vs_jax_cpu(diag: str, jax_tpu: dict, port_campaign: dict,
               jax_runs: str = JAX_REPLAY) -> dict:
    """Per row trained under ``diag/<side>/<row>_s<seed>/`` (``jax_cpu``:
    JAX's own CLI on a host CPU; ``port_cpu``, ``port_card``; ``_jaxinit``
    from JAX's initial weights, ``_jaxdraws`` also with JAX's head masks),
    all at f32:

    - ``bands``: each side's test-accuracy band beside JAX's TPU band and
      the port's campaign band, and whether each overlaps JAX's TPU band
      (JAX's CPU band also the port's). A row cut short (``<row>-15ep``)
      has neither reference band.
    - ``paired``: per :func:`variant`, every other side against
      ``jax_cpu`` and against JAX's TPU runs of the same preset and seeds
      (``jax_runs``), and a ``_jaxinit`` side against its ``_jaxdraws``
      side (the port's draws against JAX's), by :func:`paired`.
    """
    sides, sources = {}, set()
    for path in sorted(glob.glob(os.path.join(diag, "*", "*",
                                              "result.json"))):
        r = load_result(path)
        if r and "test" in r:
            sides.setdefault(path.split(os.sep)[-3], []).append((path, r))
            sources.add(r.get("host") or r.get("nvidia_smi"))
    rows = {}
    for side, results in sorted(sides.items()):
        for name, b in bands([r for _, r in results]).items():
            tpu, card = jax_tpu.get(name), port_campaign.get(name)
            row = rows.setdefault(name, {"jax_tpu": _band(tpu),
                                         "port_campaign": _band(card)})
            row[side] = _band(b)
            row[f"{side}_overlaps_jax_tpu"] = (
                None if tpu is None else overlap(b, tpu))
            if side == "jax_cpu":
                row["jax_cpu_overlaps_port_campaign"] = (
                    None if card is None else overlap(b, card))
    pairs = {}
    for side, results in sides.items():
        for path, r in results:
            pairs.setdefault(variant(r["preset"]), {"base": r[
                "base_preset"]})
    for var, block in sorted(pairs.items()):
        by_side = {side: _runs([(p, r) for p, r in results
                                if variant(r["preset"]) == var])
                   for side, results in sides.items()}
        tpu = [(p, {**r, "preset": block["base"]}) for p in glob.glob(
            os.path.join(jax_runs, "*", f"{block['base']}_s*",
                         "result.json"))
               if "test" in (r := load_result(p) or {})]
        by_side["jax_tpu"] = _runs(tpu)
        for ref in REFERENCE:
            for side, runs in sorted(by_side.items()):
                if side in (ref, "jax_tpu"):
                    continue
                p = paired(by_side[ref], runs)
                if p:
                    block[f"{side} - {ref}"] = p
        for side in sorted(by_side):   # the port's draws against JAX's
            draws = side.replace("_jaxinit", "_jaxdraws")
            if side.endswith("_jaxinit") and draws in by_side:
                p = paired(by_side[draws], by_side[side])
                if p:
                    block[f"{side} - {draws}"] = p
    return {"sources": sorted(x for x in sources if x),
            "bands": dict(sorted(rows.items())),
            "paired": {v: b for v, b in sorted(pairs.items()) if len(b) > 1}}


def write_table_block(out: str) -> dict:
    """Add :func:`vs_jax_cpu` of ``out`` to the campaign's ``table.json``
    beside ``out``."""
    path = os.path.join(os.path.dirname(os.path.abspath(out)), "table.json")
    with open(path) as f:
        table = json.load(f)
    jax_table = load_result(os.path.join(JAX_REPLAY, "table.json")) or {}
    table["vs_jax_cpu"] = vs_jax_cpu(out, jax_table.get("bands", {}),
                                     table.get("bands", {}))
    with open(path, "w") as f:
        json.dump(table, f, indent=2)
    return table["vs_jax_cpu"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tests/replay_diag.py")
    ap.add_argument("--side", choices=("jax", "port"))
    ap.add_argument("--preset")
    ap.add_argument("--curves", metavar="PRESET",
                    help="print the row's loss curves instead of training")
    ap.add_argument("--coupled", metavar="PRESET",
                    help="arm (a) of the coupled test on the replay set")
    ap.add_argument("--table", action="store_true",
                    help="write table.json's vs_jax_cpu block")
    ap.add_argument("--mask-law", action="store_true",
                    help="the port's head masks against JAX's, --seeds")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the preset's epochs (the run is "
                         "named <preset>-<N>ep)")
    ap.add_argument("--set", action="append", default=[],
                    help="a config override k=v (repeatable)")
    ap.add_argument("--tag", default="", help="names the --set variant")
    ap.add_argument("--device", choices=("cpu", "card"), default="cpu",
                    help="where the port trains")
    ap.add_argument("--save-inits", metavar="DIR",
                    help="(jax) write each seed's initial variables and "
                         "head masks")
    ap.add_argument("--init-from", metavar="DIR",
                    help="(port) start from JAX's initial variables")
    ap.add_argument("--jax-masks", action="store_true",
                    help="(port, with --init-from) drop JAX's head units")
    ap.add_argument("--root", default=os.path.join(REPO, "build",
                                                   "replay224"))
    ap.add_argument("--out", default=os.path.join(
        REPO, "runs", "torch_replay", "diag"))
    args = ap.parse_args(argv)
    name = ((args.preset or args.curves or "")
            + (f"-{args.epochs}ep" if args.epochs else "")
            + (f"-{args.tag}" if args.tag else ""))
    if args.curves:
        print(json.dumps(compare(args.curves, args.out, name)))
        return 0
    if args.table:
        print(json.dumps(write_table_block(args.out)))
        return 0
    if args.mask_law:
        os.environ["JAX_PLATFORMS"] = "cpu"
        print(json.dumps(mask_law([int(s) for s in args.seeds.split(",")])))
        return 0
    if args.coupled:
        os.environ["JAX_PLATFORMS"] = "cpu"
        print(json.dumps(coupled(args.coupled, os.path.abspath(args.root),
                                 args.epochs or 1,
                                 dict(kv.split("=", 1) for kv in args.set))))
        return 0
    if not (args.side and args.preset):
        ap.error("--side and --preset, --coupled, --curves or --table")
    if args.set and not args.tag:
        ap.error("--set needs --tag")
    if args.jax_masks and not args.init_from:
        ap.error("--jax-masks needs --init-from")
    if args.side == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
    root = os.path.abspath(args.root)
    seeds = [int(s) for s in args.seeds.split(",")]
    base = {**data_overrides(args.preset, root),
            "model.compute_dtype": "float32"}
    if args.epochs:
        base["train.epochs"] = str(args.epochs)
    base.update(kv.split("=", 1) for kv in args.set)
    if args.save_inits:
        save_jax_inits(args.preset, seeds, base, args.save_inits)
        return 0
    on_card = args.side == "port" and args.device == "card"
    side = (f"{args.side}_{'card' if on_card else 'cpu'}"
            + ("_jaxdraws" if args.jax_masks
               else "_jaxinit" if args.init_from else ""))
    card = card_record() if on_card else host_record()
    launcher = ["-m", {"jax": "surya_tpu", "port": "surya_tpu_torch"}[
        args.side]]
    if args.init_from:
        launcher = [os.path.abspath(__file__)]
    failed = False
    for seed in seeds:
        out_dir = os.path.join(args.out, side, f"{name}_s{seed}")
        if "test" in (load_result(os.path.join(out_dir, "result.json"))
                      or {}):
            continue
        if args.init_from:
            stem = os.path.abspath(os.path.join(
                args.init_from, f"{args.preset}_s{seed}"))
            os.environ[INIT_ENV] = stem + ".npz"
            os.environ[MASKS_ENV] = stem + "_masks.npz" if args.jax_masks \
                else ""
        res = run_cli(launcher, name, args.preset, out_dir,
                      {**base, "train.seed": str(seed)},
                      device="cpu" if args.side == "port" and not on_card
                      else None, card=card)
        failed |= "test" not in res
    return int(failed)


if __name__ == "__main__":
    if sys.argv[1:2] == ["train"]:
        sys.exit(train_from_init(sys.argv[2:]))
    sys.exit(main())
