"""The measurement path needs the card: without one it fails and prints
no result, and it never reports a CPU time under a device metric."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import spec

from .helpers import CELLS


def result_lines(stdout: str) -> list:
    found = []
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and ("metrics" in obj or "correct" in obj):
            found.append(obj)
    return found


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_without_a_card_fails_with_no_result(no_card, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "3",
         "--seconds", "1", "--trace", trace],
        cwd=spec.REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert result_lines(out.stdout) == []


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    ``paths`` (no program), a run fails and prints no result."""
    bench = spec.load_benchmark()
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    for p in bench["paths"]:
        shutil.copytree(spec.REPO / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload", CELLS[1], "--seed", "4",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert result_lines(out.stdout) == []


def test_rehearsal_prints_no_device_metric():
    bench = spec.load_benchmark()
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    out = subprocess.run(
        [sys.executable, "portbench/rehearse.py", "--workload", CELLS[0], "--seconds", "0.2",
         "--scale", "32", "--trace", "1"],
        cwd=spec.REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["rehearsal"] == "cpu" and "metrics" not in line and "device" not in line
    assert not names & set(line)
    assert set(line["readers_empty"]) == {"kernel_roofline_pct", "device_idle_pct"}
