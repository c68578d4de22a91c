"""The comparison that decides ``correct`` fails what it has to fail.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU, with the cell's own limits (``limits/<cell>.json``): a
sound run comes out correct; the control (the reference put in the
program's place one precision below the configuration's) and each fault
the cell can have, planted under the timed path, come out not correct.
Training runs at 128 px and batch 16, a size at which sound runs read
inside the limits set from the card's full-size readings and the control
outside them."""

import pytest

import controls
import harness as H

TRAIN = ["quadtree-fusion.train-b256", "comparative-resnet50.train-b256"]
TRAIN_SIZE = {"batch": 16, "frames": 48, "staging": 144, "image_size": 128}


@pytest.fixture
def train_run(small_run):
    def make(name, seed=5):
        run = small_run(name, seed)
        run.small = dict(TRAIN_SIZE)
        return run

    return make


@pytest.mark.parametrize("name", TRAIN)
def test_sound_train_run_is_correct(name, train_run):
    run = train_run(name)
    run.cell.driver().execute(run)
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "bn_backward"])
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_is_not_correct(name, fault, train_run, monkeypatch):
    """A step that returns its state unchanged, one that leaves half of
    each batch out, and a trunk BatchNorm whose backward takes the batch
    statistics for constants, planted under the timed path."""
    run = train_run(name)
    controls.plant(fault, monkeypatch.setattr)
    run.cell.driver().execute(run)
    assert not run.correct
    if fault == "unchanged":
        got = {n: v for n, v, _ in run.checks}
        assert got["change_gap"] >= 0.99      # nothing moved


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_is_not_correct(name, train_run):
    """float8 operands for the bf16 model and a bf16 transform, in the
    program's place, fail the limits the program passes."""
    run = train_run(name)
    readings = controls.train_readings(run, controls=True)
    run.judge(readings["program"])
    assert run.correct, run.checks
    run.checks = []
    run.judge(readings["control"])
    assert not run.correct
    run.checks = []
    run.judge(readings["half_batch"])
    assert not run.correct


def test_limits_have_readings_files():
    for cell in TRAIN:
        lim = H.load_json(H.HERE / "limits" / f"{cell}.json")
        assert lim and all(v > 0 for v in lim.values())
