"""The benchmark's trace reading (``portbench/tests/test_pb_tracing.py``),
collected here so that it runs with the rest of ``tests/``; and the
span-split probe's readings (``span_split.py``) on made-up spans and in a
small CPU rehearsal."""

from portbench.tests.test_pb_tracing import *  # noqa: F401,F403

import dataclasses  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

import span_split  # noqa: E402
from avir_tpu_torch.utils.trace import Span  # noqa: E402
from portbench import spec as pb_spec  # noqa: E402
from portbench import tracing as pb_tracing  # noqa: E402


def made_up_spans():
    """Two requests of two frames, in ns: request 1's sync ends at 100, its
    finish runs 100-110; request 2 dispatches from 130, its first launch
    ends at 170.  ``frame`` 130-200 holds ``k1.call`` 140-190, which holds
    ``k1.launch`` 150-170 and a collection 175-180."""

    def span(name, a, b, req, sid, parent=None):
        return Span(name, a, b, req, sid, parent, 1)

    return [
        span("pb.dispatch.1", 0, 60, 1, 1),
        span("frame", 0, 30, 1, 2, 1),
        span("k1.call", 5, 25, 1, 3, 2),
        span("k1.launch", 10, 20, 1, 4, 3),
        span("frame", 30, 60, 1, 5, 1),
        span("k1.call", 35, 55, 1, 6, 5),
        span("k1.launch", 40, 50, 1, 7, 6),
        span("pb.sync.1", 60, 100, 1, 8),
        span("pb.finish.1", 100, 110, 1, 9),
        span("pb.dispatch.2", 130, 260, 2, 10),
        span("frame", 130, 200, 2, 11, 10),
        span("k1.call", 140, 190, 2, 12, 11),
        span("k1.launch", 150, 170, 2, 13, 12),
        span("gc.gen0", 175, 180, 2, 14, 12),
        span("frame", 200, 260, 2, 15, 10),
        span("k1.call", 210, 250, 2, 16, 15),
        span("k1.launch", 220, 240, 2, 17, 16),
        span("pb.sync.2", 260, 300, 2, 18),
    ]


def test_per_frame_self_times():
    got = span_split.per_frame(made_up_spans())
    assert got["frames"] == 4 and got["launches_per_frame"] == 1.0
    # frame self: 30-20, 30-20, 70-50, 60-40 ns; k1.call self: 20-10,
    # 20-10, 50-20-5, 40-20; launches 10, 10, 20, 20.
    assert got["fn_self_us"] == pytest.approx(60 / 4 * 1e-3)
    assert got["k1_prep_us"] == pytest.approx(65 / 4 * 1e-3)
    assert got["k1_launch_us"] == pytest.approx(60 / 4 * 1e-3)
    assert got["gc_us"] == {"gc.gen0": pytest.approx(5e-3)}
    assert got["gc_count"] == {"gc.gen0": 1}
    assert span_split.per_frame([]) == {"frames": 0}


def test_first_frame_and_later_frames():
    got = span_split.first_and_later(made_up_spans())
    # First frames: request 1's (10, 10, 10 ns) and request 2's (20, 25, 20).
    assert got["first.fn_self_us"] == pytest.approx(15e-3)
    assert got["first.k1_prep_us"] == pytest.approx(17.5e-3)
    assert got["first.k1_launch_us"] == pytest.approx(15e-3)
    assert got["later.fn_self_us"] == pytest.approx(15e-3)
    assert got["later.k1_prep_us"] == pytest.approx(15e-3)
    assert got["later.k1_launch_us"] == pytest.approx(15e-3)


def test_turnaround_from_the_sync_to_the_first_launch():
    got = span_split.turnaround(made_up_spans())
    assert got["turnaround_requests"] == 1
    assert got["turnaround_us"] == pytest.approx(70e-3)
    assert got["finish_us"] == pytest.approx(10e-3)
    assert got["to_dispatch_us"] == pytest.approx(20e-3)
    assert got["to_first_launch_us"] == pytest.approx(40e-3)
    # No launch (the CPU's plain versions): no turnaround.
    plain = [s for s in made_up_spans() if s.name != "k1.launch"]
    assert span_split.turnaround(plain) == {"turnaround_requests": 0}


def test_gaps_carry_the_innermost_port_span(slice_):
    # slice_ (portbench/tests/test_pb_tracing.py) idles 0-5 us (dispatch 7),
    # 90-115 (sync 7, then between requests) and 195-200 (sync 8).
    base = BASE_NS  # noqa: F405
    port = [Span("frame", base + 1000, base + 4000, 7, 1, None, 1),
            Span("k1.call", base + 1500, base + 3500, 7, 2, 1, 1),
            Span("gc.gen2", base + 100_000, base + 105_000, None, 3, None, 1)]
    gaps = span_split.named_gaps(slice_, port, base)
    assert gaps == [
        ["between requests / gc.gen2", pytest.approx(25e-6)],
        ["dispatch request 7 / k1.call", pytest.approx(5e-6)],
        ["sync request 8", pytest.approx(5e-6)],
    ]
    assert span_split.gap_totals(gaps) == {
        "between requests / gc.gen2": pytest.approx(25e-6),
        "dispatch / k1.call": pytest.approx(5e-6),
        "sync": pytest.approx(5e-6),
    }
    # The card's last operation of request 7 ends at 90 us, inside its
    # sync (10-100); request 8's at 195, inside its sync (120-200).
    assert span_split.sync_tails_us(slice_) == [pytest.approx(10), pytest.approx(5)]
    assert span_split.innermost([("a", 0, 10), ("b", 2, 8), ("c", 2, 5)], 4) == "c"
    assert span_split.innermost([("a", 0, 10)], 11) is None


@pytest.mark.parametrize("cell", ["avir_def_u8_rgb.photo_album_down",
                                  "lancir_u8_rgb.video_segment_up"])
def test_rehearsal_on_the_cpu(cell):
    """The whole probe at 1/64 size, 4 frames a request, on the plain
    versions: both slices run, every frame of the span slice is spanned,
    and the parts nest."""
    c = pb_spec.load_cell(pb_spec.load_benchmark(), cell)
    c = dataclasses.replace(c, traffic={**c.traffic, "frames_per_request": 4})
    rec = span_split.measure(c, 2**31 + 11, 0.3, torch.device("cpu"), scale=64,
                             trace_frames=8, span_requests=1, alternating_pairs=1)
    per_request = c.traffic["frames_per_request"]
    assert rec["failed"] == 0 and rec["dropped"] == 0
    assert rec["span_requests"] >= 1
    assert rec["span_frames"] == rec["span_requests"] * per_request
    assert rec["plan_build_s"] + rec["operands_s"] <= rec["make_fn_s"] <= rec["plan_s"]
    assert rec["fn_self_us"] + rec["k1_prep_us"] <= rec["dispatch_us_spanned"]
    assert rec["k1_launch_us"] is None and rec["launches_per_frame"] == 0
    assert len(rec["plan_s_tracer_off"]) == len(rec["plan_s_tracer_on"]) == 2
    assert rec["idle_gaps"] and all(" request" in n or n.startswith("between")
                                    for n, _ in rec["idle_gaps"])
    assert rec["device_idle_pct"] is None  # no device operation on the CPU
    alt = rec["alternating"]
    assert len(alt["dispatch_us_off"]) == len(alt["dispatch_us_on"]) == 1
    assert set(rec["span_site_ns"]) == {"bare", "off", "on"}
    assert "first.k1_prep_us" in rec["frame_parts_us"]
    prof = rec["profiler_slice"]
    assert prof["dispatch_us"] > 0 and prof["k1_prep_us"] > 0
    assert prof["k1_launch_us"] is None and prof["sync_tail_us"] is None
    assert pb_tracing.SPAN_PREFIX == "pb."
