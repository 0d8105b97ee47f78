"""``correct`` comes out false when the timed path is broken underneath (CPU, small sizes).

Each run drives everything a benchmark run drives but the look for a card,
at the sizes of :mod:`benchmark.tests.tiny`, with a fault planted in the
program under the entry: a member's bits altered where they are made, half
of every chunk of tiles left out, half of every training batch left out, a
gradient altered before Keras Adam gets it, and a step that leaves the
parameters as they were.  Each is held to the cell's committed limits.
"""
from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

FAULTS = [
    ("ensemble5.masks-1024", "fault:alter"),
    ("ensemble5.masks-1024", "fault:half"),
    ("res34.train-512-b8", "fault:half"),
    ("res34.train-512-b8", "fault:alter"),
    ("res34.train-512-b8", "fault:frozen"),
]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    result = run.run_cell(tiny.cell(name), 2**31 + 3, 0.05, False, torch.device("cpu"), variant=fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", ["ensemble5.masks-1024", "res34.train-512-b8"])
def test_the_program_in_f32_is_correct(name):
    result = run.run_cell(tiny.cell(name, compute_dtype="float32"), 2**31 + 4, 0.05, False, torch.device("cpu"))
    assert result["correct"] is True, result["checks"]
