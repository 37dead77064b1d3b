"""On the card: a short run of each cell comes out correct, and the
control at the cell's own size does not.  Marked ``cuda``; skips without
a card (decided inside the fixture)."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import check, control, harness, spec

from .helpers import CELLS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(card, name):
    cell = spec.load_cell(spec.load_benchmark(), name)
    rec = harness.measure(cell, 2**31 + 77, 1.0, True, card, time.time())
    assert rec["correct"], rec["checks"]
    assert rec["slice"] is not None and rec["slice"].device_ops
    assert rec["route"]["route"] == "int8"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_at_full_size_on_the_card(card, name):
    cell = spec.load_cell(spec.load_benchmark(), name)
    src, dst = harness.geometry(cell.traffic)
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    low = control.control_readings(cell, ref, 5, card)
    assert not check.judge(low, cell.limits)[0], low
