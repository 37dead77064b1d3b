"""Reading a Chrome trace, and the metric readers, on made-up records."""

from __future__ import annotations

import json

import pytest

from portbench import harness, spec, tracing


BASE_NS = 1_700_000_000_000_000_000


def write_trace(path, events):
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE_NS, "traceEvents": events}))


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def host_spans(*spans):
    """(name, start_us, dur_us) on the trace's clock, as HostSpans holds them."""
    h = tracing.HostSpans()
    h.spans = [(n, BASE_NS + int(s * 1000), BASE_NS + int((s + d) * 1000)) for n, s, d in spans]
    return h


@pytest.fixture
def slice_(tmp_path):
    # Two requests of two frames: dispatch 0-10 us, sync 10-100; dispatch
    # 110-120, sync 120-200.  Kernels 5-45, 45-90, 115-150, 150-190 and a
    # memset 190-195; a GPU-side span and a CPU op are not device work.
    events = [
        ev("kernel", "k1", 5, 40),
        ev("kernel", "k1", 45, 45),
        ev("kernel", "k1", 115, 35),
        ev("Kernel", "k2", 150, 40),
        ev("gpu_memset", "Memset", 190, 5),
        ev("gpu_user_annotation", "pb.sync.8", 120, 80),
        ev("cpu_op", "aten::empty", 1, 1),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
    ]
    write_trace(tmp_path / "t.json", events)
    spans = host_spans(("pb.dispatch.7", 0, 10), ("pb.sync.7", 10, 90),
                       ("pb.dispatch.8", 110, 10), ("pb.sync.8", 120, 80))
    return tracing.read_chrome_trace(tmp_path / "t.json", 4, spans)


def test_host_spans_land_on_the_trace_clock(tmp_path):
    spans = tracing.HostSpans()
    with spans("pb.dispatch.3"):
        pass
    (name, a, b), = spans.spans
    assert name == "pb.dispatch.3" and a <= b
    write_trace(tmp_path / "t.json", [])
    sl = tracing.read_chrome_trace(tmp_path / "t.json", 1, spans)
    assert sl.host_spans == [("pb.dispatch.3", (a - BASE_NS) * 1e-3, (b - a) * 1e-3)]


def test_slice_busy_idle_and_breakdown(slice_):
    assert slice_.start_us == 0 and slice_.end_us == 200
    assert slice_.busy_intervals() == [(5, 90), (115, 195)]
    assert slice_.busy_s() == pytest.approx(165e-6)
    assert slice_.device_seconds() == pytest.approx(165e-6)
    assert slice_.seconds_by_op() == [["k1", pytest.approx(120e-6)], ["k2", pytest.approx(40e-6)],
                                     ["Memset", pytest.approx(5e-6)]]
    assert slice_.idle_gaps() == [
        ["between requests", pytest.approx(25e-6)],
        ["dispatch request 7", pytest.approx(5e-6)],
        ["sync request 8", pytest.approx(5e-6)],
    ]


def test_readers_on_a_record(slice_):
    reqs = [harness.Request(k, start=k, dispatched=k + 0.001, done=k + 0.002 + 0.001 * k,
                            frames=4, ok=True) for k in range(20)]
    reqs[3].ok = False
    reqs[5].traced = True
    rec = {"requests": reqs, "src": (1000, 500), "window_s": 10.0, "setup_s": 4.5,
           "plan_s": 1.25, "slice": slice_, "slice_wall_s": 9.99,
           "bound": {"bound_s": 10e-6}}

    def read(name):
        return spec.metric_reader(name).read(rec)

    assert read("mpix_per_s") == pytest.approx(19 * 4 * 0.5 / 10.0)
    # 19 latencies 2..21 ms without k = 3: the 95th percentile by rank is the 19th.
    assert read("request_ms_p95") == pytest.approx(21.0)
    assert read("setup_s") == 4.5 and read("plan_s") == 1.25
    assert read("dispatch_us") == pytest.approx(1000.0 / 4)
    assert read("kernel_roofline_pct") == pytest.approx(100 * 10e-6 / (165e-6 / 4))
    # 18 untraced requests of 4 frames in 10.0 - 9.99 s: 139 us a frame,
    # against 165 / 4 us of device time a frame.
    pace = 0.01 / 72
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 165e-6 / 4 / pace))
    rec["slice"] = tracing.TraceSlice(frames=4, device_ops=[], host_spans=slice_.host_spans)
    assert read("kernel_roofline_pct") is None and read("device_idle_pct") is None
    rec["slice"] = None
    assert read("kernel_roofline_pct") is None and read("device_idle_pct") is None


def test_a_slice_without_spans_is_refused(tmp_path):
    write_trace(tmp_path / "t.json", [ev("kernel", "k1", 5, 40)])
    with pytest.raises(RuntimeError):
        tracing.read_chrome_trace(tmp_path / "t.json", 1, tracing.HostSpans())
