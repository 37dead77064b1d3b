"""The check refuses a broken timed path and the control, and passes the
port as it is.  Each run skips the look for a card and drives the rest of
a run (set-up, the window, the check) on the CPU, at a small size, through
the port's plain versions of its kernels."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import check, control, harness, spec

from .helpers import CELLS, small_cell

SCALE = 32


def flip_one_value(fn):
    """An answer altered where it is produced: one value of each frame
    gets its top bit flipped."""
    def broken(x):
        y = fn(x).clone()
        y.view(-1)[y.numel() // 3] ^= 0x80
        return y
    return broken


def off_by_one(fn):
    """Every value one step high, as a rounding that always rounds up."""
    def broken(x):
        return (fn(x).to(torch.int16) + 1).clamp(0, 255).to(torch.uint8)
    return broken


def half_left_out(fn):
    """Half of each request's frames never resized: every second call
    hands back the output of the call before."""
    last = {}

    def broken(x):
        n = last.get("n", 0)
        last["n"] = n + 1
        if n % 2 and "y" in last:
            return last["y"]
        last["y"] = fn(x)
        return last["y"]
    return broken


def unchanged(fn):
    """A step that leaves its state as it was: every call returns the
    first output."""
    first = {}

    def broken(x):
        if "y" not in first:
            first["y"] = fn(x)
        return first["y"]
    return broken


def fails_sometimes(fn):
    """Every fifth call raises, as a launch that fails."""
    count = {"n": 0}

    def broken(x):
        count["n"] += 1
        if count["n"] % 5 == 0:
            raise RuntimeError("launch failed")
        return fn(x)
    return broken


def run(name, fault=None, seed=7):
    cell, _ = small_cell(name)
    return harness.measure(
        cell, seed, 0.3, False, torch.device("cpu"), time.time(), scale=SCALE, fault=fault
    )


@pytest.mark.parametrize("name", CELLS)
def test_the_port_as_it_is_comes_out_correct(name):
    rec = run(name)
    assert rec["correct"], rec["checks"]
    assert rec["checked_frames"] >= spec.load_cell(spec.load_benchmark(), name).traffic["frames_per_request"]


@pytest.mark.parametrize("fault", [flip_one_value, off_by_one, half_left_out, unchanged, fails_sometimes])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_comes_out_not_correct(name, fault):
    rec = run(name, fault)
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name):
    """The reference in bfloat16 in the program's place fails the check;
    the port on the same frames passes it."""
    cell, (src, dst) = small_cell(name, SCALE)
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    low = control.control_readings(cell, ref, 11, torch.device("cpu"), SCALE)
    assert not check.judge(low, cell.limits)[0], low
    fn = spec.program(cell.config["resizer"]).make(cell.config, src, dst, torch.device("cpu"))
    sound = control.program_readings(cell, fn, ref, 11, torch.device("cpu"), SCALE)
    assert check.judge(sound, cell.limits)[0], sound
