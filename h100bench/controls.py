"""The readings that a cell's limits are set from: the program's numbers on
a dozen seeds or more, and, on a few seeds, the control's and the planted
faults' numbers, all at the cell's own sizes. The benchmark's runs do not
run this.

    python3 h100bench/controls.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --out <file.json>

- Training cells: each seed's set-up drives the program through the
  checked steps (no measured window); the reference follows them. The
  control is the reference put in the program's place, computed one
  precision below what the configuration states: float8 e4m3 operands for
  the bfloat16 model, bfloat16 for the float32 input transform. The
  fault: half of each batch left out, the mean taken over the rest (the
  reference in the program's place). A step that leaves the state as it
  was reads 1 by the change and gradient measures and needs no run.
"""

import argparse
import gc
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
os.environ["TRITON_CACHE_DIR"] = str(HERE.parent / "build" / "triton")

import harness as H  # noqa: E402


def _free(device):
    import torch

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def train_readings(run, controls: bool) -> dict:
    import torch

    from reference import train as RT

    D = run.cell.driver()
    prog, checked, weights, means, pack, size = D.setup(run)
    prog.close()
    import shutil

    shutil.rmtree(pack, ignore_errors=True)
    del prog
    _free(run.device)
    ref = D.reference_readings(run, checked, weights, means, size)
    out = {"program": RT.compare(checked, ref)}
    if controls:
        ctrl = D.reference_readings(run, checked, weights, means, size,
                                    precision="fp8",
                                    aug_dtype=torch.bfloat16)
        out["control"] = RT.compare(ctrl, ref)
        half = len(checked["batches"][0][2]) // 2
        fault = D.reference_readings(run, checked, weights, means, size,
                                     rows=half)
        out["half_batch"] = RT.compare(fault, ref)
    return out


def plant(fault: str, set_attr=setattr) -> None:
    """Plant a fault under the program's train step, in this process:
    ``unchanged`` (a step that returns its state as it was, its loss read
    from an eval-mode forward, which moves no BN statistic) or
    ``half_batch`` (half of each batch left out, the mean taken over the
    rest), or ``bn_backward`` (the trunk's train-mode BatchNorm with a
    backward that takes the batch statistics for constants: its forward
    and running statistics as they were, its gradient without the terms
    through the batch mean and variance). ``set_attr``: how to set a
    module's attribute (a test's ``monkeypatch.setattr`` undoes it)."""
    import torch
    from surya_tpu_torch.train import steps

    if fault == "bn_backward":
        _plant_bn_backward(set_attr)
        return
    if fault not in ("unchanged", "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    make = steps.make_train_step

    def broken(model, *args, **kwargs):
        step = make(model, *args, **kwargs)

        def half(state, batch, generator=None):
            n = batch[2].shape[0] // 2
            return step(state, tuple(x[:n] for x in batch), generator)

        def unchanged(state, batch, generator=None):
            model.eval()
            with torch.no_grad():
                logits = model(batch[0], batch[1]).float()
            loss = torch.nn.functional.cross_entropy(
                logits, torch.as_tensor(batch[2]).to(logits.device).long())
            return state, {"loss": loss, "accuracy": loss * 0}

        return half if fault == "half_batch" else unchanged

    set_attr(steps, "make_train_step", broken)


def _plant_bn_backward(set_attr) -> None:
    import types

    import torch
    import torch.nn.functional as F
    from surya_tpu_torch.models.backbones import resnet

    def batch_norm(x, mean, var, weight, bias, training, momentum, eps):
        if not training:
            return F.batch_norm(x, mean, var, weight, bias, False, momentum,
                                eps)
        with torch.no_grad():   # fills mean and var as the program expects
            F.batch_norm(x, mean, var, weight, bias, True, momentum, eps)
        n = x.numel() // x.shape[1]
        return F.batch_norm(x, mean.clone(), var * ((n - 1) / n), weight,
                            bias, False, 0.0, eps)

    def constant_stats(x, weight, bias, mean, var, count, eps, group):
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    functional = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                          if not k.startswith("__")})
    functional.batch_norm = batch_norm
    set_attr(resnet, "F", functional)             # the fused card path
    set_attr(resnet, "_GlobalBatchNorm",          # the CPU path
             types.SimpleNamespace(apply=constant_stats))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    cell = H.Cell(a.workload)
    H.require_cards(cell.chips)
    rows = []
    for i in range(a.seeds):
        seed = a.first_seed + 7919 * i
        run = H.Run(cell, seed, 0.0, False, "cuda")
        controls = i < a.control_seeds
        r = train_readings(run, controls)
        r["seed"] = seed
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {}
    for key in ("program", "control", "half_batch"):
        got = [r[key] for r in rows if key in r]
        if got:
            summary[key] = {n: {"min": min(g[n] for g in got),
                                "max": max(g[n] for g in got)}
                            for n in got[0]}
    summary["card"] = H.power_limit()
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"rows": rows,
                                           "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
