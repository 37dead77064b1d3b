"""The 16-bit RGBA linear-light AVIR configuration of the benchmark and its
8K cell: the float64 reference (``portbench/reference/avir_srgb16.py``)
against upstream's own 16-bit gamma output and against a NumPy einsum,
its alpha channel against the resize without gamma, the port's CPU path
(K1 split vh gamma's plain version) within the cell's limits, the
bfloat16 control outside them, the cell found by name, a rehearsal, and
K1 split's ``forms`` counter.  On the CPU at the segment cut by 32
(120x68 -> 240x135); one case on the card (``cuda`` marker) runs a frame
at the cell's own size."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

# Before portbench.control, whose import puts the checkout in place of
# this directory at the head of sys.path.
from test_torch_pb_srgb import np_to_linear, np_to_srgb  # isort: skip
from torch_cases import split_tol  # isort: skip

import span_split
from avir_tpu_torch.ops.cuda import fused_split
from portbench import check, control, harness, spec
from portbench.reference import avir_srgb16
from portbench.reference.dense import dense
from portbench.reference.params import preset
from portbench.reference.plan import build_resize_plan

GOLDEN = Path(__file__).resolve().parent / "golden" / "data"
CELL = "avir_def_u16_rgba_srgb.segment_up_8k"
CONFIG = "avir_def_u16_rgba_srgb"
FORM = "vh/s3/s3/gamma/u16->u16"
SCALE = 32  # 3840x2160 -> 7680x4320 at 120x68 -> 240x135
SEEDS = (2**31 + 7, 2**31 + 1013, 4_000_000_019)
PER_LAYER = ["plan_s", "dispatch_us", "kernel_roofline_pct", "device_idle_pct"]
U16 = json.loads((spec.HERE / "configs" / f"{CONFIG}.json").read_text())


def xs128_u16(n: int, seed: int) -> np.ndarray:
    """The golden generator's u16 image fill (``tests/golden/src/gen_golden.cpp``:
    XS128 seeded by ``seed``, 16 draws discarded, the top 16 bits of each)."""
    m = 0xFFFFFFFF
    x = (123456789 ^ (seed * 2654435761)) & m
    y = (362436069 ^ (seed * 0x9E3779B9)) & m
    z = (521288629 + seed) & m
    w = (88675123 ^ (seed << 7)) & m
    out = np.empty(n + 16, dtype=np.uint16)
    for i in range(n + 16):
        t = (x ^ (x << 11)) & m
        x, y, z = y, z, w
        w = (w ^ (w >> 19) ^ t ^ (t >> 8)) & m
        out[i] = w >> 16
    return out[16:]


def u16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32)).to(torch.uint16)


# (golden, values that differ, the largest distance of their float64 value
# from k + 0.5 allowed, in LSB).  Upstream sums and converts in float32;
# the reference computed in float32 here moves a value by up to 0.095 LSB
# (RGBA) and 0.012 LSB (gray) at 16 bits, so a value may round the other
# way where it lies that close to a midpoint: 226 of 76,800 values do,
# the farthest 0.046 from it, and 2 of 1,989 (0.0065).
GOLDENS = [("a_rgba16gamma", 226, 0.05), ("a_gray16gamma", 2, 0.01)]


@pytest.mark.parametrize("name,count,distance", GOLDENS)
def test_reference_against_upstreams_16bit_gamma_output(name, count, distance):
    entry = json.loads((GOLDEN / "manifest.json").read_text())[name]
    sw, sh, nw, nh, ch = (entry[k] for k in ("sw", "sh", "nw", "nh", "ch"))
    assert entry["gamma"] == 1 and entry["bitdepth"] == 16 and entry["preset"] == "def"
    assert entry["tin"] == entry["tout"] == "u16" and entry["dither"] == ""
    x = u16(xs128_u16(sw * sh * ch, entry["seed"]).reshape(sh, sw, ch))
    cfg = {**U16, "channels": ch, "alpha_index": entry["alphaidx"]}
    ref = avir_srgb16.build(cfg, (sw, sh), (nw, nh))
    assert ref.in_mul == 1.0 / 65535.0 and ref.gamma_out_mul == 65535.0 and ref.clamp == 65535.0
    exact = ref.forward(x).numpy()
    got = ref.finish(torch.from_numpy(exact)).numpy()
    want = np.load(GOLDEN / f"{name}.npy").astype(np.float64).reshape(got.shape)
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    off = diff > 0
    assert off.sum() == count
    assert (np.abs(exact[off] - np.floor(exact[off]) - 0.5) < distance).all()
    # The distance lies inside float32's own error at 16 bits.
    f32 = ref.forward(x, dtype=torch.float32).numpy()
    assert np.abs(f32 - exact).max() > distance


@pytest.mark.parametrize(
    "src,dst,channels,alpha",
    [((37, 29), (16, 12), 4, 3), ((23, 17), (41, 30), 4, 3), ((23, 17), (41, 30), 4, 0),
     ((23, 17), (41, 30), 3, -1)],
)
def test_reference_is_a_float64_linear_light_resize(src, dst, channels, alpha):
    """``forward`` equals 65535 x to_srgb(sum_a sum_b V[i, a] H[j, b]
    to_linear(x[a, b] / 65535)) written out in NumPy, in either pass
    order, the alpha channel scaled only; its operators are the 16-bit
    resize's without gamma, and it rounds half up and clamps at 65535."""
    cfg = {**U16, "channels": channels, "alpha_index": alpha}
    ref = avir_srgb16.build(cfg, src, dst)
    plan = _no_gamma_plan(src, dst, channels)
    np.testing.assert_array_equal(ref.v, dense(plan.v.op))
    np.testing.assert_array_equal(ref.h, dense(plan.h.op))
    assert ref.order == ("vh" if dst[0] * dst[1] <= src[0] * src[1] else "hv")
    x = np.random.default_rng(11).integers(0, 65536, (src[1], src[0], channels))
    s = x / 65535.0
    lin = np_to_linear(s)
    if alpha >= 0:
        lin[..., alpha] = s[..., alpha]
    y = np.einsum("ia,jb,abc->ijc", ref.v, ref.h, lin)
    want = np_to_srgb(y)
    if alpha >= 0:
        want[..., alpha] = y[..., alpha]
    got = ref.forward(u16(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), 65535.0 * want, rtol=0, atol=1e-7)
    assert ref.finish(torch.tensor([-0.7, 127.5, 65534.49, 65535.5, 70000.0])).tolist() == [
        0, 128, 65534, 65535, 65535]


def _no_gamma_plan(src, dst, channels):
    """The reference planner's 16-bit plan without gamma."""
    return build_resize_plan(*src, *dst, channels, np.uint16, np.uint16,
                             params=preset("def"), res_bit_depth=16)


@pytest.mark.parametrize("src,dst", [((37, 29), (16, 12)), ((23, 17), (41, 30))])
def test_the_alpha_channel_is_the_resize_without_gamma(src, dst):
    """Alpha (index 3) goes through neither conversion: the reference's
    alpha equals the 16-bit resize without gamma of the alpha plane, and
    the colour channels do not."""
    ref = avir_srgb16.build({**U16, "channels": 4}, src, dst)
    plan = _no_gamma_plan(src, dst, 4)
    v, h = dense(plan.v.op), dense(plan.h.op)
    x = np.random.default_rng(5).integers(0, 65536, (src[1], src[0], 4))
    got = ref.forward(u16(x)).numpy()
    plain = np.einsum("ia,jb,abc->ijc", v, h, x.astype(np.float64))
    np.testing.assert_allclose(got[..., 3], plain[..., 3], rtol=0, atol=1e-7)
    assert np.abs(got[..., :3] - plain[..., :3]).max() > 1.0


def small(frames: int = 2):
    """The cell with ``frames`` frames a request and a pool of as many, one
    request checked, and its geometry cut by SCALE."""
    cell = spec.load_cell(spec.load_benchmark(), CELL)
    cell = dataclasses.replace(cell, traffic={
        **cell.traffic, "frames_per_request": frames, "pool_frames": frames, "check_requests": 1,
    })
    return cell, harness.geometry(cell.traffic, SCALE)


def make(cell, src, dst, device="cpu"):
    prog = spec.program(cell.config["resizer"])
    fn = prog.make(cell.config, src, dst, torch.device(device))
    return fn, prog.route(fn)


ROUTE = {"route": "split", "order": "vh", "launch_key": "fused_split_vh_gamma",
         "mode_v": "split3", "mode_h": "split3", "in_dtype": "uint16", "out_dtype": "uint16",
         "alpha_index": 3, "form": FORM}


def test_the_cells_own_size_takes_k1_split_vh_gamma():
    """At 3840x2160 -> 7680x4320 u16 RGBA the configuration's "auto" runs
    K1 split3/split3 vh gamma, quantizing to u16 in the kernel with the
    alpha bypass: no operand is run, only built."""
    cell = spec.load_cell(spec.load_benchmark(), CELL)
    src, dst = harness.geometry(cell.traffic)
    fn, how = make(cell, src, dst)
    assert how == ROUTE
    ops = fn.run.ops
    assert (ops.rows_in, ops.lanes_in, ops.rows_out, ops.lanes_out) == (2160, 15360, 4320, 30720)
    assert ops.epi.gamma and ops.epi.c == 4 and ops.trunc_bits == 0 and ops.out_max == 65535.0


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_is_within_the_cells_limits(seed):
    """K1 split vh gamma's plain version, on the cell's route at the cut:
    correct by the cell's limits, and off the rounded reference somewhere
    (split3 keeps about 16 bits)."""
    cell, (src, dst) = small()
    fn, how = make(cell, src, dst)
    assert how == ROUTE
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    got = control.program_readings(cell, fn, ref, seed, torch.device("cpu"), SCALE)
    correct, checks = check.judge(got, cell.limits)
    assert correct, checks
    assert list(checks) == ["excess_lsb", "mismatch_ppm", "bad_frames"]
    assert checks["mismatch_ppm"]["value"] > 0


def test_the_bfloat16_control_is_not_correct():
    """The reference computed in bfloat16 (its conversions too) fails the
    cell's limits by both readings."""
    cell, (src, dst) = small()
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    got = control.control_readings(cell, ref, SEEDS[0], torch.device("cpu"), SCALE)
    correct, checks = check.judge(got, cell.limits)
    assert not correct, checks
    for name in ("excess_lsb", "mismatch_ppm"):
        assert checks[name]["value"] > checks[name]["limit"], name


def test_the_cell_is_found_by_name():
    bench = spec.load_benchmark()
    cell = spec.load_cell(bench, CELL)
    assert (cell.config_name, cell.traffic_name, cell.chips) == (CONFIG, "segment_up_8k", 1)
    assert cell.config == U16 and cell.config["reduced"] == []
    assert spec.program("avir_srgb16").make and spec.reference("avir_srgb16") is avir_srgb16
    assert (cell.config["channels"], cell.config["alpha_index"], cell.config["res_bit_depth"]) == (
        4, 3, 16)
    assert set(cell.limits) == {"excess_lsb", "mismatch_ppm", "bad_frames"}
    assert cell.limits["bad_frames"]["limit"] == 0
    assert cell.traffic["src"] == [3840, 2160] and cell.traffic["dst"] == [7680, 4320]
    assert (cell.traffic["frames_per_request"], cell.traffic["pool_frames"],
            cell.traffic["check_requests"], cell.traffic["loop"], cell.traffic["clients"]) == (
        24, 16, 2, "closed", 1)
    assert [m["name"] for m in spec.metrics_for(bench, CELL, False)] == [
        "mpix_per_s", "request_ms_p95", "setup_s"]
    assert [m["name"] for m in spec.metrics_for(bench, CELL, True)] == PER_LAYER
    for name in PER_LAYER:
        reader = spec.metric_reader(name)
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        assert (reader.LAYER, reader.MOVES) == (entry["layer"], entry["moves"])
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs[CONFIG]["reduced"] == [] and len(configs[CONFIG]["source"]) <= 200
    assert configs[CONFIG]["file"] == f"portbench/configs/{CONFIG}.json"


def test_a_rehearsal_of_the_cell_on_the_cpu():
    """The whole run (set-up, the window, the check) at the cut, 2 frames a
    request, on the plain versions: correct, on the cell's route, and the
    readers that need no device find their readings."""
    cell, _ = small()
    rec = harness.measure(cell, SEEDS[1], 0.2, False, torch.device("cpu"), time.time(),
                          scale=SCALE)
    assert rec["correct"], rec["checks"]
    assert rec["route"] == ROUTE
    assert rec["checked_frames"] == 2 and rec["dst"] == (240, 135) and rec["channels"] == 4
    assert rec["bound"]["bound_by"] == "bytes" and rec["bound"]["bound_s"] > 0
    for metric in ("mpix_per_s", "request_ms_p95", "setup_s", "plan_s", "dispatch_us"):
        assert spec.metric_reader(metric).read(rec) is not None
    for metric in ("kernel_roofline_pct", "device_idle_pct"):
        assert spec.metric_reader(metric).read(rec) is None


@pytest.mark.parametrize("order,modes,gamma,tin,tout,key", [
    ("vh", ("split3", "split3"), True, torch.uint16, torch.uint16, "vh/s3/s3/gamma/u16->u16"),
    ("hv", ("split3", "split2"), False, torch.uint8, torch.float32, "hv/s3/s2/linear/u8->f32"),
    ("vh", ("split2", "split3"), False, torch.float32, torch.uint8, "vh/s2/s3/linear/f32->u8"),
])
def test_forms_counts_a_launch_by_instantiation(order, modes, gamma, tin, tout, key, monkeypatch):
    """``fused_split.form`` names the order, each pass's mode (V first),
    gamma and the input and output types; the wrapper counts a launch
    under it beside ``launches`` (the launch stubbed: no card here), and
    the plain version counts nothing."""
    import avir_tpu_torch
    from avir_tpu_torch.ops.banded import block_banded
    from avir_tpu_torch.ops.lanes import lane_block_banded
    from avir_tpu_torch.plan.plan import build_resize_plan as port_plan

    c = 4
    plan = port_plan(24, 16, 40, 30, c, np.uint16, np.uint16,
                     params=avir_tpu_torch.preset("def"), res_bit_depth=16)
    ops = fused_split.prepare_fused_split(
        block_banded(plan.v.op, in_bytes=2), lane_block_banded(plan.h.op, c, in_bytes=2),
        order, *modes, "cpu", out_dtype=tout, gamma=gamma, alpha_index=3 if gamma else -1,
    )
    assert fused_split.form(ops, tin) == key == ops.form_keys[tin]
    x = torch.zeros((ops.rows_in, ops.lanes_in), dtype=tin)
    before, launched = dict(fused_split.forms), dict(fused_split.launches)
    fused_split.apply_fused_split(ops, x)
    assert dict(fused_split.forms) == before and dict(fused_split.launches) == launched

    calls = []
    monkeypatch.setattr(fused_split, "on_cpu", lambda x, device: False)
    monkeypatch.setattr(fused_split.LAUNCH, "launch",
                        lambda x, counts, k, *a, packed=(): calls.append(k) or counts.__setitem__(
                            k, counts[k] + 1))
    monkeypatch.setattr(type(ops), "packed", ())
    fused_split.apply_fused_split(ops, x)
    fused_split.apply_fused_split(ops, x)
    assert calls == [ops.launch_key] * 2
    assert fused_split.forms[key] - before.get(key, 0) == 2
    assert fused_split.launches[ops.launch_key] - launched[ops.launch_key] == 2


def test_span_split_counts_the_slices_launches_by_form(monkeypatch):
    """``span_split.forms_since`` gives the launches counted by form since
    ``forms_now``, by kernel, leaving out forms that took none."""
    from avir_tpu_torch.ops.cuda import fused_kernel, wavefront

    monkeypatch.setattr(fused_split, "forms", fused_split.forms.copy())
    monkeypatch.setattr(fused_kernel, "hv_forms", dict(fused_kernel.hv_forms))
    monkeypatch.setattr(wavefront, "forms", dict(wavefront.forms))
    before = span_split.forms_now()
    assert set(before) == {"split", "hv", "k4"}
    fused_split.forms[FORM] += 3
    fused_split.forms["hv/s3/s3/linear/u8->f32"] += 0
    fused_kernel.hv_forms["runs"] += 1
    assert span_split.forms_since(before) == {"split": {FORM: 3}, "hv": {"runs": 1}, "k4": {}}


def test_span_split_rehearses_the_u16_cell_on_the_cpu():
    """The span-split probe makes the cell's pool in its own input type
    (u16) and runs both slices at 1/64 size, 4 frames a request; on the
    CPU the plain versions launch nothing, so no form is counted."""
    cell = spec.load_cell(spec.load_benchmark(), CELL)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "frames_per_request": 4})
    rec = span_split.measure(cell, 2**31 + 13, 0.3, torch.device("cpu"), scale=64,
                             trace_frames=8, span_requests=1, alternating_pairs=1)
    assert rec["failed"] == 0 and rec["dropped"] == 0
    assert rec["split_prep_us"] > 0 and rec["split_launch_us"] is None
    prof = rec["profiler_slice"]
    assert prof["frames"] == 8 and prof["forms"] == {"split": {}, "hv": {}, "k4": {}}


@pytest.mark.cuda
def test_a_frame_at_the_cells_size_on_card():
    """3840x2160 -> 7680x4320 u16 RGBA in linear light on the card: one
    K1 split vh gamma launch of form vh/s3/s3/gamma/u16->u16, and the
    check's readings within the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(spec.load_benchmark(), CELL)
    src, dst = harness.geometry(cell.traffic)
    fn, how = make(cell, src, dst, dev)
    assert how == ROUTE
    x = harness.make_pool(SEEDS[2], 1, (src[1], src[0], 4), dev, "uint16")[0]
    before = fused_split.forms[FORM]
    out = fn(x)
    torch.cuda.synchronize()
    assert fused_split.forms[FORM] - before == 1
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    readings = check.Readings(torch.uint16)
    readings.add(out, ref, ref.forward(x))
    correct, checks = check.judge(readings.result(), cell.limits)
    assert correct, checks


@pytest.mark.cuda
def test_kernel_within_the_split_gate_at_the_cells_size_on_card():
    """At the cell's own size (15,360 input and 30,720 output lanes, the
    u16 epilogue with the alpha bypass) K1 split vh gamma stays within the
    split gate of its plain version on the same input: the module's
    contract, ~7.5 LSB at 16 bits where gamma-out's slope amplifies the
    float32 difference of the two summation orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(spec.load_benchmark(), CELL)
    src, dst = harness.geometry(cell.traffic)
    fn, _ = make(cell, src, dst, dev)
    ops = fn.run.ops
    x = harness.make_pool(SEEDS[1], 1, (src[1], src[0], 4), dev, "uint16")[0]
    got = fused_split.apply_fused_split(ops, x.reshape(src[1], -1)).double()
    want = fused_split.apply_fused_split_reference(ops, x.reshape(src[1], -1)).double()
    tol = split_tol("u16", float(want.abs().max()), 65535.0, scale=ops.epi.scale, gamma=True)
    assert float((got - want).abs().max()) <= tol
    out = fn(x)
    torch.cuda.synchronize()
    assert torch.equal(got, out.reshape(got.shape).double())
