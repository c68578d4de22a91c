"""The plain reference agrees with the port on the CPU at a small size,
for the train driver's entry: the train step of ``make_train_step`` fed by
``device_transform``. The port runs in f32 here
(``model.compute_dtype=float32``), so what is left between the two is
f32 rounding; the train reference runs in float64."""

import pytest
import torch

import counts
import harness as H

TRAIN = ["quadtree-fusion.train-b256", "comparative-resnet50.train-b256"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_reference(name, small_run):
    cell = H.Cell(name)
    cell.config["overrides"] = {"model.compute_dtype": "float32"}
    run = small_run(name, cell=cell)
    d = cell.driver()
    prog, checked, weights, means, pack, size = d.setup(run)
    prog.close()
    model = counts.sized(cell.config["model"], size)
    aug = {k: cell.config["augment"][k] for k in (
        "scale_min", "hflip_prob", "jitter", "rotation_deg", "blur_sigma")}
    ref = d.RT.follow(model, cell.config["train"], aug, weights,
                      checked["batches"], checked["seeds"], means, size,
                      "cpu", dtype=torch.float64)
    gaps = d.RT.compare(checked, ref)
    # the same f32 transform on the same draws
    assert gaps["batch_gap"] <= 1e-6
    # step 1 from the same weights: f32 against f64 rounding
    assert abs(checked["loss"][0] - ref["loss"][0]) <= 1e-4 * ref["loss"][0]
    assert gaps["grad_gap"] <= 2e-2
    # the dropout masks are the program's: without them step 1 parts by
    # far more (another draw of half the MLP's and head's units)
    assert len(checked["loss"]) == cell.traffic["check_steps"]


def test_dropout_draw_matters(small_run):
    """The comparison sees a different dropout draw: the reference fed
    other per-step seeds parts from the program."""
    name = TRAIN[0]
    cell = H.Cell(name)
    cell.config["overrides"] = {"model.compute_dtype": "float32"}
    run = small_run(name, cell=cell)
    d = cell.driver()
    prog, checked, weights, means, pack, size = d.setup(run)
    prog.close()
    other = dict(checked, seeds=[(a, b + 1) for a, b in checked["seeds"]])
    ref = d.reference_readings(run, other, weights, means, size)
    assert abs(checked["loss"][0] - ref["loss"][0]) > 1e-3
