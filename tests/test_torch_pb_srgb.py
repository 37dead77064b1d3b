"""The sRGB-gamma AVIR configuration of the benchmark and its video cell
on AVIR: the float64 linear-light reference (``portbench/reference/
avir_srgb.py``) against a NumPy einsum and against upstream's own output,
the port's CPU path through each gamma route against it within the
cell's limits, the bfloat16 control outside them, the cells found by
name, and the ring kernel's spans.  On the CPU at small sizes; one case
on the card (``cuda`` marker) compares the gamma routes at the cell's
own size."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import avir_tpu_torch as at
import span_split
from avir_tpu_torch.models import runtime
from avir_tpu_torch.utils import trace
from avir_tpu_torch.utils.trace import Span
from portbench import check, harness, spec
from portbench.reference import avir as ref_avir
from portbench.reference import avir_srgb
from portbench.tests.helpers import xs128_u8

GOLDEN = Path(__file__).resolve().parent / "golden" / "data"
GAMMA_CELL = "avir_def_srgb_u8_rgb.photo_album_down_8k"
VIDEO_CELL = "avir_def_u8_rgb.video_segment_up"
NEW_CELLS = (GAMMA_CELL, VIDEO_CELL)
# The smallest cut at which the gamma cell's V operator still blocks
# uniformly for the ring kernel (1280x720 -> 320x180); the video cell at
# the same cut is 320x180 -> 640x360.
SCALE = 6
GAMMA_ROUTES = ("ring", "inkernel", "prologue")
ROUTE_KEYS = {"ring": "fused_ring_vh_gamma", "inkernel": "fused_int8_vh_gamma",
              "prologue": "fused_int8_vh_gamma_pre"}
SRGB = json.loads((spec.REPO / "portbench/configs/avir_def_srgb_u8_rgb.json").read_text())


def np_to_linear(s):
    """AVIR's convertSRGB2Lin with pow24_sRGB (avir.h:162-174, 208-220)."""
    t = (s + 0.055) / 1.055
    p = (0.0985766365536824 + 0.839474952656502 * t**2 + 0.363287814061725 * t**3
         - 0.0125559718896615 / (0.12758338921578 + 0.290283465468235 * t)
         - 0.231757513261358 * t - 0.0395365717969074 * t**4)
    return np.where(s <= 0.04045, s / 12.92, p)


def np_to_srgb(s):
    """AVIR's convertLin2SRGB with pow24i_sRGB (avir.h:185-196, 299-310)."""
    x = np.maximum(s, 0.0031308)
    p = (0.000213364515060263 + 0.0149409239419218 * x + 0.433973412731747 * x**0.5
         + x**0.25 * (0.659628181609715 * x**0.125 - 0.0380957908841466
                      - 0.0706476137208521 * x**0.5))
    return np.where(s <= 0.0031308, 12.92 * s, 1.055 * p - 0.055)


@pytest.mark.parametrize(
    "src,dst,channels,alpha",
    [((37, 29), (16, 12), 3, -1), ((23, 17), (41, 30), 3, -1), ((37, 29), (16, 12), 4, 3)],
)
def test_reference_is_a_float64_linear_light_resize(src, dst, channels, alpha):
    """``forward`` equals 255 x to_srgb(sum_a sum_b V[i, a] H[j, b]
    to_linear(x[a, b] / 255)) written out in NumPy, in either pass order,
    the alpha channel scaled only; its operators are the reference's
    operators without gamma (the planner folds no output scale into them
    under gamma, and 255 / 255 without)."""
    cfg = {**SRGB, "channels": channels, "alpha_index": alpha}
    ref = avir_srgb.build(cfg, src, dst)
    plain = ref_avir.build({**cfg, "use_srgb_gamma": False}, src, dst)
    np.testing.assert_array_equal(ref.v, plain.v)
    np.testing.assert_array_equal(ref.h, plain.h)
    assert ref.order == ("vh" if dst[0] * dst[1] <= src[0] * src[1] else "hv")
    x = np.random.default_rng(7).integers(0, 256, (src[1], src[0], channels), dtype=np.uint8)
    s = x / 255.0
    lin = np_to_linear(s)
    if alpha >= 0:
        lin[..., alpha] = s[..., alpha]
    y = np.einsum("ia,jb,abc->ijc", ref.v, ref.h, lin)
    want = np_to_srgb(y)
    if alpha >= 0:
        want[..., alpha] = y[..., alpha]
    got = ref.forward(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), 255.0 * want, rtol=0, atol=1e-9)
    assert ref.finish(torch.tensor([-0.7, 127.5, 254.49, 255.5])).tolist() == [0, 128, 254, 255]


def test_reference_against_upstreams_gamma_output():
    """Against the C++ library's RGBA u8 gamma resize (alpha index 3,
    100x80 -> 180x140, ``a_rgba8gamma``).  Upstream computes in float32,
    which moves a value by ~1e-5 LSB: a value may round the other way
    only where the float64 value lies that close to a midpoint.  So every
    value is within 1 LSB, and each one that differs has its float64
    value within 1e-3 LSB of k + 0.5 (one of the 100,800 values, 1.1e-5
    from it)."""
    entry = json.loads((GOLDEN / "manifest.json").read_text())["a_rgba8gamma"]
    sw, sh, nw, nh, ch = (entry[k] for k in ("sw", "sh", "nw", "nh", "ch"))
    assert entry["gamma"] == 1 and entry["alphaidx"] == 3 and entry["preset"] == "def"
    x = xs128_u8(sw * sh * ch, entry["seed"]).reshape(sh, sw, ch)
    ref = avir_srgb.build({**SRGB, "channels": ch, "alpha_index": 3}, (sw, sh), (nw, nh))
    exact = ref.forward(torch.from_numpy(x)).numpy()
    got = ref.finish(torch.from_numpy(exact)).numpy()
    want = np.load(GOLDEN / "a_rgba8gamma.npy").astype(np.float64)
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    off = diff > 0
    assert off.sum() <= 10
    assert (np.abs(exact[off] - np.floor(exact[off]) - 0.5) < 1e-3).all()


def small_copy(name):
    cell = spec.load_cell(spec.load_benchmark(), name)
    src, dst = harness.geometry(cell.traffic, SCALE)
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    pool = harness.make_pool(2**31 + 23, 2, (src[1], src[0], cell.config["channels"]), "cpu")
    return cell, src, dst, ref, pool


def make_on_route(cell, src, dst, route, monkeypatch, device="cpu"):
    """The cell's device function with ``AVIR_TPU_GAMMA_ROUTE`` set to
    ``route`` (None: unset), and its route."""
    if route is None:
        monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV, raising=False)
    else:
        monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, route)
    prog = spec.program(cell.config["resizer"])
    fn = prog.make(cell.config, src, dst, torch.device(device))
    return fn, prog.route(fn)


def test_gamma_routes_are_bit_equal_and_within_the_limits(monkeypatch):
    """At 1280x720 -> 320x180 the ring, in-kernel and prologue routes give
    the same bits, "auto" takes the in-kernel route, and the readings pass
    the cell's limits."""
    cell, src, dst, ref, pool = small_copy(GAMMA_CELL)
    outs = {}
    for route in (None, *GAMMA_ROUTES):
        fn, how = make_on_route(cell, src, dst, route, monkeypatch)
        assert how["launch_key"] == ROUTE_KEYS[route or "inkernel"]
        outs[route] = [fn(pool[i]) for i in range(pool.shape[0])]
    for route in GAMMA_ROUTES:
        assert all(torch.equal(a, b) for a, b in zip(outs[route], outs[None]))
    readings = check.Readings()
    for i, out in enumerate(outs[None]):
        readings.add(out, ref, ref.forward(pool[i]))
    correct, checks = check.judge(readings.result(), cell.limits)
    assert correct, checks
    assert readings.frames == 2 and checks["mismatch_ppm"]["value"] > 0


@pytest.mark.parametrize("name", NEW_CELLS)
def test_the_bfloat16_control_fails_the_limits_the_port_passes(name, monkeypatch):
    """The reference computed in bfloat16 (its conversions too) is not
    correct by the cell's limits, where the port is."""
    cell, src, dst, ref, pool = small_copy(name)
    fn, _ = make_on_route(cell, src, dst, None, monkeypatch)
    port, low = check.Readings(), check.Readings()
    for i in range(pool.shape[0]):
        exact = ref.forward(pool[i])
        port.add(fn(pool[i]), ref, exact)
        low.add(ref.finish(ref.forward(pool[i], dtype=torch.bfloat16)).to(torch.uint8), ref, exact)
    assert check.judge(port.result(), cell.limits)[0], port.result()
    correct, checks = check.judge(low.result(), cell.limits)
    assert not correct, checks
    assert checks["excess_lsb"]["value"] > checks["excess_lsb"]["limit"]


def test_the_new_cells_are_found_by_name():
    bench = spec.load_benchmark()
    for name in NEW_CELLS:
        cell = spec.load_cell(bench, name)
        assert cell.chips == 1 and cell.limits is not None
        assert cell.traffic["loop"] == "closed" and cell.traffic["clients"] == 1
        assert spec.program(cell.config["resizer"]).make
        assert spec.reference(cell.config["resizer"]).build
        assert [m["name"] for m in spec.metrics_for(bench, name, True)] == [
            "plan_s", "dispatch_us", "kernel_roofline_pct", "device_idle_pct",
        ]
    gamma = spec.load_cell(bench, GAMMA_CELL)
    assert gamma.config_name == "avir_def_srgb_u8_rgb" and gamma.config["use_srgb_gamma"]
    assert spec.reference("avir_srgb") is avir_srgb
    assert gamma.traffic["src"] == [7680, 4320] and gamma.traffic["dst"] == [1920, 1080]
    assert (gamma.traffic["frames_per_request"], gamma.traffic["pool_frames"],
            gamma.traffic["check_requests"]) == (8, 8, 4)
    video = spec.load_cell(bench, VIDEO_CELL)
    assert video.config_name == "avir_def_u8_rgb" and video.traffic_name == "video_segment_up"
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs["avir_def_srgb_u8_rgb"]["reduced"] == [] == SRGB["reduced"]


@pytest.fixture
def tracer():
    trace.disable()
    trace.request(None)
    trace.drain()
    yield trace
    trace.disable()
    trace.request(None)
    trace.drain()


def test_ring_route_spans(tracer, monkeypatch):
    """Under ``AVIR_TPU_GAMMA_ROUTE=ring``, set-up holds
    ``setup.ring_operands`` inside ``setup.operands``; a traced frame on
    the ring route is ``frame`` > ``k6.call``, with no
    ``k6.launch`` on the CPU (the plain version runs); untraced, nothing
    is recorded."""
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "ring")
    (w, h), (nw, nh) = harness.geometry(spec.load_cell(
        spec.load_benchmark(), GAMMA_CELL).traffic, SCALE)
    x = harness.make_pool(5, 1, (h, w, 3), "cpu")[0]
    trace.enable()
    fn = at.make_resize_fn((h, w, 3), np.uint8, nw, nh, use_srgb_gamma=True, device="cpu")
    trace.request(3)
    got = fn(x)
    trace.request(None)
    trace.disable()
    spans, dropped = trace.drain()
    assert dropped == 0 and fn.run.ops.launch_key == "fused_ring_vh_gamma"
    names = {s.name: s for s in spans}
    ops, ring = names["setup.operands"], names["setup.ring_operands"]
    assert ring.parent == ops.id and ops.start_ns <= ring.start_ns <= ring.end_ns <= ops.end_ns
    assert names["setup.operands"].parent == names["setup.make_fn"].id
    frame, call = names["frame"], names["k6.call"]
    assert frame.parent is None and call.parent == frame.id and call.request == frame.request == 3
    assert frame.start_ns <= call.start_ns <= call.end_ns <= frame.end_ns
    assert "k6.launch" not in names and "k1.call" not in names
    assert torch.equal(fn(x), got)
    assert trace.drain() == ([], 0)
    # The inkernel route tries no ring.
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "inkernel")
    trace.enable()
    at.make_resize_fn((h, w, 3), np.uint8, nw, nh, use_srgb_gamma=True, device="cpu")
    trace.disable()
    assert "setup.ring_operands" not in {s.name for s in trace.drain()[0]}


def test_span_split_reads_the_ring_kernels_parts():
    """Two frames of one request on the ring route, in ns: ``frame``
    0-50 > ``k6.call`` 5-45 > ``k6.launch`` 10-30; ``frame`` 50-90 >
    ``k6.call`` 55-85 > ``k6.launch`` 60-70; the previous request's sync
    ends at -20."""

    def span(name, a, b, sid, parent=None, req=2):
        return Span(name, a, b, req, sid, parent, 1)

    spans = [
        span("pb.sync.1", -60, -20, 0, req=1),
        span("pb.dispatch.2", 0, 90, 1),
        span("frame", 0, 50, 2, 1), span("k6.call", 5, 45, 3, 2), span("k6.launch", 10, 30, 4, 3),
        span("frame", 50, 90, 5, 1), span("k6.call", 55, 85, 6, 5), span("k6.launch", 60, 70, 7, 6),
    ]
    got = span_split.per_frame(spans)
    assert got["frames"] == 2 and got["launches_per_frame"] == 1.0
    assert got["fn_self_us"] == pytest.approx(20 / 2 * 1e-3)
    assert got["k6_prep_us"] == pytest.approx(40 / 2 * 1e-3)
    assert got["k6_launch_us"] == pytest.approx(30 / 2 * 1e-3)
    assert got["k1_prep_us"] is None and got["k1_launch_us"] is None
    assert span_split.host_parts(got) == [got["fn_self_us"], got["k6_prep_us"], got["k6_launch_us"]]
    parts = span_split.first_and_later(spans)
    assert parts["first.k6_launch_us"] == pytest.approx(20e-3)
    assert parts["later.k6_prep_us"] == pytest.approx(20e-3)
    turn = span_split.turnaround(spans)
    assert turn["turnaround_requests"] == 1
    assert turn["turnaround_us"] == pytest.approx(50e-3)  # -20 to the first launch's end, 30


@pytest.mark.parametrize("name", NEW_CELLS)
def test_a_rehearsal_of_the_new_cell_on_the_cpu(name):
    """The whole run (set-up, the window, the check) at the small copy, 2
    frames a request, on the plain versions: correct, on the cell's
    route, and the readers that need no device find their readings."""
    cell = spec.load_cell(spec.load_benchmark(), name)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "frames_per_request": 2,
                                              "pool_frames": 2, "check_requests": 1})
    rec = harness.measure(cell, 2**31 + 5, 0.2, False, torch.device("cpu"), time.time(),
                          scale=SCALE)
    assert rec["correct"], rec["checks"]
    assert rec["route"]["launch_key"] == ("fused_int8_vh_gamma" if name == GAMMA_CELL
                                          else "fused_int8_hv")
    assert rec["bound"]["bound_s"] > 0 and rec["checked_frames"] == 2
    for metric in ("mpix_per_s", "setup_s", "plan_s", "dispatch_us"):
        assert spec.metric_reader(metric).read(rec) is not None


@pytest.mark.cuda
def test_gamma_routes_bit_equal_at_the_cells_size_on_card(monkeypatch):
    """7680x4320 -> 1920x1080 u8 RGB with gamma: K6 ("ring"), K1's
    in-kernel linearization ("inkernel", and "auto" with the variable
    unset) and K5's prologue give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(spec.load_benchmark(), GAMMA_CELL)
    src, dst = harness.geometry(cell.traffic)
    pool = harness.make_pool(2**31 + 41, 2, (src[1], src[0], 3), dev)
    outs = {}
    for route in (None, *GAMMA_ROUTES):
        fn, how = make_on_route(cell, src, dst, route, monkeypatch, dev)
        assert how["launch_key"] == ROUTE_KEYS[route or "inkernel"]
        outs[route] = [fn(pool[i]).cpu() for i in range(pool.shape[0])]
        del fn
    for route in GAMMA_ROUTES:
        assert all(torch.equal(a, b) for a, b in zip(outs[route], outs[None])), route
