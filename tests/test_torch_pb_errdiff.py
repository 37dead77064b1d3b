"""The error-diffused AVIR configuration of the benchmark and its video
cell: the port's CPU path (K1 split hv's and K4's plain versions, and the
unfused route the small cut takes by itself) within the cell's limits of
the float64 reference, the bfloat16 and the rounded controls outside
them, the cell found by name, a rehearsal, the split and K4 spans, their
parts in ``span_split.py`` and the diffusion's two readers.  On the CPU at
the segment cut by 15 (128x72 -> 256x144); one case on the card (``cuda``
marker) runs the cell's own size."""

from __future__ import annotations

import dataclasses
import json
import time

import pytest
import torch

import span_split
from avir_tpu_torch.models import runtime
from avir_tpu_torch.ops.cuda import fused_split, wavefront
from avir_tpu_torch.utils import trace
from avir_tpu_torch.utils.trace import Span
from portbench import check, control, diffusion, harness, spec, tracing

CELL = "avir_def_u8_rgb_errdiff.video_segment_up"
CONFIG = "avir_def_u8_rgb_errdiff"
SCALE = 15  # 1920x1080 -> 3840x2160 at 128x72 -> 256x144
SEEDS = (2**31 + 3, 2**31 + 977, 4_000_000_007)
PER_LAYER = ["plan_s", "dispatch_us", "kernel_roofline_pct", "device_idle_pct",
             "diffusion_roofline_pct", "diffusion_ns_per_step"]


def small(frames: int = 2):
    """The cell with ``frames`` frames a request and a pool of as many, one
    request checked, and its geometry cut by SCALE."""
    cell = spec.load_cell(spec.load_benchmark(), CELL)
    cell = dataclasses.replace(cell, traffic={
        **cell.traffic, "frames_per_request": frames, "pool_frames": frames, "check_requests": 1,
    })
    return cell, harness.geometry(cell.traffic, SCALE)


def make(cell, src, dst, route, monkeypatch, device="cpu"):
    """The cell's device function; with ``route`` "split", the fused split
    route that the cell's own size takes (a cut this small is unfused by
    ``choose_fused``'s rule 4)."""
    if route == "split":
        monkeypatch.setattr(runtime, "choose_fused", lambda *a, **k: (True, "hv"))
    prog = spec.program(cell.config["resizer"])
    fn = prog.make(cell.config, src, dst, torch.device(device))
    return fn, prog.route(fn)


def test_the_cells_own_size_takes_the_split_route_in_hv():
    """At 1920x1080 -> 3840x2160 the configuration's "auto" runs K1 split
    hv to float32 and then K4: no operand is run, only built."""
    cell = spec.load_cell(spec.load_benchmark(), CELL)
    src, dst = harness.geometry(cell.traffic)
    fn, how = make(cell, src, dst, None, None)
    assert how == {"route": "split", "order": "hv", "launch_key": "fused_split_hv"}
    assert fn.run.ops.out_dtype == torch.float32


@pytest.mark.parametrize("route", ["split", "unfused"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_is_within_the_cells_limits(route, seed, monkeypatch):
    cell, (src, dst) = small()
    fn, how = make(cell, src, dst, route, monkeypatch)
    assert how["route"] == route and how["order"] == "hv"
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    assert ref.errdiff is not None and ref.order == "hv"
    pool = control.cell_pool(cell, seed, torch.device("cpu"), SCALE)
    readings = check.Readings()
    outs = [fn(x) for x in pool]
    readings.add_all(outs, ref, (ref.forward(x) for x in pool))
    correct, checks = check.judge(readings.result(), cell.limits)
    assert correct, checks
    assert list(checks) == ["excess_lsb", "diffusion_miss_ppm", "bad_frames"]
    assert readings.frames == 2 and checks["diffusion_miss_ppm"]["value"] > 0


@pytest.mark.parametrize("rounded", [False, True])
def test_both_controls_are_not_correct(rounded):
    """The reference computed in bfloat16 and then diffused, and the float64
    frame rounded with no diffusion, fail the cell's limits: the first by
    both readings, the second by ``diffusion_miss_ppm``."""
    cell, (src, dst) = small()
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    got = control.control_readings(cell, ref, SEEDS[0], torch.device("cpu"), SCALE, rounded)
    correct, checks = check.judge(got, cell.limits)
    assert not correct, checks
    assert checks["diffusion_miss_ppm"]["value"] > checks["diffusion_miss_ppm"]["limit"]
    if not rounded:
        assert checks["excess_lsb"]["value"] > checks["excess_lsb"]["limit"]


def test_the_cell_is_found_by_name():
    bench = spec.load_benchmark()
    cell = spec.load_cell(bench, CELL)
    assert (cell.config_name, cell.traffic_name, cell.chips) == (CONFIG, "video_segment_up", 1)
    assert cell.config["dither"] == "errdiff" and cell.config["reduced"] == []
    plain = json.loads((spec.HERE / "configs" / "avir_def_u8_rgb.json").read_text())
    assert set(cell.config) == set(plain)
    assert {k: v for k, v in cell.config.items() if plain[k] != v}.keys() <= {
        "dither", "source", "guarantees", "assumed"}
    assert set(cell.limits) == {"excess_lsb", "diffusion_miss_ppm", "bad_frames"}
    assert cell.limits["bad_frames"]["limit"] == 0
    assert cell.traffic["src"] == [1920, 1080] and cell.traffic["dst"] == [3840, 2160]
    assert (cell.traffic["frames_per_request"], cell.traffic["pool_frames"],
            cell.traffic["check_requests"]) == (60, 40, 2)
    assert [m["name"] for m in spec.metrics_for(bench, CELL, False)] == [
        "mpix_per_s", "request_ms_p95", "setup_s"]
    assert [m["name"] for m in spec.metrics_for(bench, CELL, True)] == PER_LAYER
    for name in PER_LAYER:
        reader = spec.metric_reader(name)
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        assert (reader.LAYER, reader.MOVES) == (entry["layer"], entry["moves"])
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs[CONFIG]["reduced"] == [] and len(configs[CONFIG]["source"]) <= 200
    # No other cell reports either diffusion reading.
    for w in (w for w in bench["workloads"] if w["name"] != CELL):
        names = [m["name"] for m in spec.metrics_for(bench, w["name"], True)]
        assert names == PER_LAYER[:4]


@pytest.mark.parametrize("route", ["split", "unfused"])
def test_a_rehearsal_of_the_cell_on_the_cpu(route, monkeypatch):
    """The whole run (set-up, the window, the check) at the small cut, 2
    frames a request, on the plain versions: correct, on its route, and
    the readers that need no device find their readings."""
    cell, _ = small()
    if route == "split":
        monkeypatch.setattr(runtime, "choose_fused", lambda *a, **k: (True, "hv"))
    rec = harness.measure(cell, SEEDS[1], 0.2, False, torch.device("cpu"), time.time(),
                          scale=SCALE)
    assert rec["correct"], rec["checks"]
    assert rec["route"]["route"] == route and rec["route"]["order"] == "hv"
    assert rec["checked_frames"] == 2 and rec["dst"] == (256, 144)
    for metric in ("mpix_per_s", "request_ms_p95", "setup_s", "plan_s", "dispatch_us"):
        assert spec.metric_reader(metric).read(rec) is not None
    # No traced slice: the device readers have nothing to read.
    for metric in ("diffusion_roofline_pct", "diffusion_ns_per_step", "kernel_roofline_pct"):
        assert spec.metric_reader(metric).read(rec) is None


@pytest.fixture
def tracer():
    trace.disable()
    trace.request(None)
    trace.drain()
    yield trace
    trace.disable()
    trace.request(None)
    trace.drain()


def test_a_traced_frame_holds_split_then_k4(tracer, monkeypatch):
    """On the split route a traced frame is ``frame`` > ``split.call`` and
    then ``frame`` > ``k4.call``, with the request; no launch on the CPU
    (the plain versions run); untraced, nothing is recorded and the bits
    are the same."""
    cell, (src, dst) = small(1)
    fn, _ = make(cell, src, dst, "split", monkeypatch)
    x = control.cell_pool(cell, SEEDS[2], torch.device("cpu"), SCALE)[0]
    want = fn(x)
    assert trace.drain() == ([], 0)
    trace.enable()
    trace.request(7)
    got = fn(x)
    trace.request(None)
    trace.disable()
    spans, dropped = trace.drain()
    assert dropped == 0 and torch.equal(got, want)
    names = [s.name for s in spans if not s.name.startswith("gc.")]
    assert names == ["split.call", "k4.call", "frame"]
    by = {s.name: s for s in spans}
    frame, split, k4 = by["frame"], by["split.call"], by["k4.call"]
    assert frame.parent is None and split.parent == frame.id == k4.parent
    assert frame.request == split.request == k4.request == 7
    assert frame.start_ns <= split.start_ns <= split.end_ns <= k4.start_ns <= k4.end_ns <= frame.end_ns
    assert torch.equal(fn(x), want)
    assert trace.drain() == ([], 0)


def test_span_split_reads_the_split_and_k4_parts():
    """Two frames of one request, in ns: ``frame`` 0-100 > ``split.call``
    5-35 > ``split.launch`` 10-20, then ``k4.call`` 40-90 > ``k4.launch``
    60-80; ``frame`` 100-180 > ``split.call`` 110-130 > ``split.launch``
    112-118, ``k4.call`` 140-170 > ``k4.launch`` 150-160; the previous
    request's sync ends at -10."""

    def span(name, a, b, sid, parent=None, req=2):
        return Span(name, a, b, req, sid, parent, 1)

    spans = [
        span("pb.sync.1", -50, -10, 0, req=1),
        span("pb.dispatch.2", 0, 180, 1),
        span("frame", 0, 100, 2, 1),
        span("split.call", 5, 35, 3, 2), span("split.launch", 10, 20, 4, 3),
        span("k4.call", 40, 90, 5, 2), span("k4.launch", 60, 80, 6, 5),
        span("frame", 100, 180, 7, 1),
        span("split.call", 110, 130, 8, 7), span("split.launch", 112, 118, 9, 8),
        span("k4.call", 140, 170, 10, 7), span("k4.launch", 150, 160, 11, 10),
    ]
    got = span_split.per_frame(spans)
    assert got["frames"] == 2 and got["launches_per_frame"] == 2.0
    # frame self: 100-30-50, 80-20-30; split self: 30-10, 20-6; k4 self: 50-20, 30-10.
    assert got["fn_self_us"] == pytest.approx(50 / 2 * 1e-3)
    assert got["split_prep_us"] == pytest.approx(34 / 2 * 1e-3)
    assert got["split_launch_us"] == pytest.approx(16 / 2 * 1e-3)
    assert got["k4_prep_us"] == pytest.approx(50 / 2 * 1e-3)
    assert got["k4_launch_us"] == pytest.approx(30 / 2 * 1e-3)
    assert got["k1_prep_us"] is None and got["k6_launch_us"] is None
    assert span_split.host_parts(got) == [
        got["fn_self_us"], got["split_prep_us"], got["split_launch_us"],
        got["k4_prep_us"], got["k4_launch_us"],
    ]
    parts = span_split.first_and_later(spans)
    assert parts["first.k4_launch_us"] == pytest.approx(20e-3)
    assert parts["later.split_prep_us"] == pytest.approx(14e-3)
    turn = span_split.turnaround(spans)
    assert turn["turnaround_requests"] == 1
    assert turn["turnaround_us"] == pytest.approx(30e-3)  # -10 to split.launch's end, 20


def made_up_slice(with_k4: bool = True):
    """Two 4K frames: K1 split hv 250 us and K4 2,400 us each, and K4's two
    memsets, on the trace's clock in us."""
    ops = []
    for f in range(2):
        t = f * 3000.0
        ops += [("Memset (Device)", t, 1.0), ("Memset (Device)", t + 2, 1.0),
                ("void fused_split_hv<false, false, unsigned char>(Args)", t + 5, 250.0)]
        if with_k4:
            ops.append(("wavefront(Args)", t + 260, 2400.0))
    spans = [("pb.dispatch.0", 0.0, 100.0), ("pb.sync.0", 100.0, 5900.0)]
    return tracing.TraceSlice(frames=2, device_ops=ops, host_spans=spans)


def test_the_diffusion_readers_on_a_made_up_slice():
    rec = {"cell": CELL, "slice": made_up_slice(), "dst": (3840, 2160), "channels": 3}
    bound = diffusion.bound(rec["dst"], 3, 1)
    assert bound["bound_by"] == "bytes" and bound["bytes"] == 3840 * 2160 * 3 * 5
    assert bound["bound_s"] == pytest.approx(124_416_000 / 3.35e12)  # 37.1 us
    assert bound["ops"] == 10 * 3840 * 2160 * 3
    assert diffusion.steps(rec["dst"]) == 8158
    assert diffusion.seconds_a_frame(rec["slice"]) == pytest.approx(2400e-6)
    roof = spec.metric_reader("diffusion_roofline_pct").read(rec)
    assert roof == pytest.approx(100 * bound["bound_s"] / 2400e-6)  # 1.55%
    pace = spec.metric_reader("diffusion_ns_per_step").read(rec)
    assert pace == pytest.approx(2400e3 / 8158)  # 294 ns
    for sl in (made_up_slice(with_k4=False), None):
        empty = {**rec, "slice": sl}
        for name in ("diffusion_roofline_pct", "diffusion_ns_per_step"):
            assert spec.metric_reader(name).read(empty) is None


@pytest.mark.cuda
def test_the_cell_on_card_launches_split_and_k4_and_passes():
    """1920x1080 -> 3840x2160 u8 RGB with error diffusion on the card: one
    K1 split hv launch and one K4 launch a frame, and the check's readings
    within the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(spec.load_benchmark(), CELL)
    src, dst = harness.geometry(cell.traffic)
    fn, how = make(cell, src, dst, None, None, dev)
    assert how == {"route": "split", "order": "hv", "launch_key": "fused_split_hv"}
    pool = harness.make_pool(SEEDS[0], 3, (src[1], src[0], 3), dev)
    split0, k40 = fused_split.launches["fused_split_hv"], wavefront.launches["wavefront"]
    outs = [fn(x) for x in pool]
    torch.cuda.synchronize()
    assert fused_split.launches["fused_split_hv"] - split0 == len(outs)
    assert wavefront.launches["wavefront"] - k40 == len(outs)
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    readings = check.Readings()
    readings.add_all(outs, ref, (ref.forward(x) for x in pool))
    correct, checks = check.judge(readings.result(), cell.limits)
    assert correct, checks
    assert checks["diffusion_miss_ppm"]["value"] < cell.limits["diffusion_miss_ppm"]["limit"]
