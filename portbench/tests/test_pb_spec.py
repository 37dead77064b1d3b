"""The harness finds each part of a cell by name, also a part added in
another directory, with no edit to a file that is there."""

from __future__ import annotations

import json
import shutil

from portbench import check, harness, spec

from .helpers import CELLS


def test_benchmark_parts_are_found_by_name():
    bench = spec.load_benchmark()
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for name in CELLS:
        cell = spec.load_cell(bench, name)
        assert cell.chips == 1
        ref = spec.reference(cell.config["resizer"]).build(cell.config, *harness.geometry(cell.traffic, 32))
        assert set(check.judged(ref.errdiff is not None)) <= set(cell.limits or ())
        assert cell.traffic["loop"] == "closed"
        assert spec.program(cell.config["resizer"]).make
        assert spec.reference(cell.config["resizer"]).build
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            reader = spec.metric_reader(m["name"])
            assert callable(reader.read)
            if group == "per_layer":
                assert reader.LAYER == m["layer"]
                assert reader.MOVES == m["moves"]
                assert set(m["workloads"]) <= set(CELLS)


def test_metrics_for_a_cell():
    bench = spec.load_benchmark()
    assert [m["name"] for m in spec.metrics_for(bench, CELLS[0], False)] == [
        "mpix_per_s", "request_ms_p95", "setup_s",
    ]
    assert [m["name"] for m in spec.metrics_for(bench, CELLS[1], True)] == [
        "plan_s", "dispatch_us", "kernel_roofline_pct", "device_idle_pct",
    ]
    bench["per_layer"].append({"name": "other", "workloads": ["elsewhere"]})
    assert "other" not in [m["name"] for m in spec.metrics_for(bench, CELLS[0], True)]


def test_parts_added_in_another_directory(tmp_path):
    """A new configuration, mix, limits and metric reader, written as new
    files beside copies of the benchmark's, make a new cell."""
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    cfg = json.loads((spec.REPO / bench["configs"][0]["file"]).read_text())
    (base / "configs" / "avir_def_u8_gray.json").write_text(json.dumps({**cfg, "channels": 1}))
    (base / "traffic" / "tiny_down.json").write_text(json.dumps({
        "src": [64, 48], "dst": [32, 24], "frames_per_request": 2, "pool_frames": 3,
        "loop": "closed", "clients": 1, "check_requests": 1, "who": "a test",
    }))
    (base / "limits").mkdir(exist_ok=True)
    (base / "limits" / "avir_def_u8_gray.tiny_down.json").write_text(json.dumps(
        {"excess_lsb": {"limit": 0.5}, "mismatch_ppm": {"limit": 1e6}, "bad_frames": {"limit": 0}}
    ))
    (base / "metrics" / "frames_done.py").write_text(
        'LAYER = "device function and K1 host call"\nMOVES = "mpix_per_s"\n\n'
        "def read(rec):\n    return sum(r.frames for r in rec['requests'])\n"
    )
    bench["configs"].append({"name": "avir_def_u8_gray", "file": "portbench/configs/avir_def_u8_gray.json"})
    bench["workloads"].append({"name": "avir_def_u8_gray.tiny_down", "config": "avir_def_u8_gray",
                               "traffic": "tiny_down", "chips": 1, "why": "a test"})
    cell = spec.load_cell(bench, "avir_def_u8_gray.tiny_down", root=tmp_path, base=base)
    assert cell.config["channels"] == 1 and cell.traffic["src"] == [64, 48]
    assert cell.limits["bad_frames"]["limit"] == 0
    reader = spec.metric_reader("frames_done", base=base)

    class R:
        frames = 2

    assert reader.read({"requests": [R(), R()]}) == 4
