"""CPU tests of the benchmark: ``python -m pytest h100bench/tests -q``.

They import the benchmark's modules as ``run.py`` does (its folder and the
checkout on ``sys.path``) and drive the drivers on the CPU at small sizes
through ``harness.Run(..., device="cpu", small=SMALL)``. Tests marked
``cuda`` run a cell on a card and skip without one."""

import os
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

# small sizes for the CPU: batch 8 at 64 px from a 72-px staging pack
SMALL = {"batch": 8, "frames": 32, "staging": 72, "image_size": 64}


@pytest.fixture
def small_run(tmp_path, monkeypatch):
    """``small_run(cell_name, seed)`` → a CPU ``Run`` at SMALL sizes, its
    temporary files under ``tmp_path``."""
    import torch

    import harness as H

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    def make(name, seed=5, cell=None, seconds=0.5, trace=False):
        cell = cell or H.Cell(name)
        return H.Run(cell, seed, seconds, trace, "cpu", small=SMALL)

    yield make
    torch.set_num_threads(before)

