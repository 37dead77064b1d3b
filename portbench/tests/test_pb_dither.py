"""The check's error-diffusion reading, the pool and the type check for
u16, and the readings of the cells through the check as it was before
the reading came.  On the CPU at small sizes."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, harness, spec
from portbench.reference import avir, errdiff

from .helpers import CELLS, small_cell, xs128_u8
from .test_pb_counts import AVIR

lanes = errdiff.lanes

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden" / "data"
W = errdiff.AVIR_WEIGHTS
FLOYD_STEINBERG = (7 / 16, 3 / 16, 5 / 16, 1 / 16)
# The limit proposed for a dithering cell's diffusion_miss_ppm (PERF.md
# section 2).  Here the port reads 1,020-1,670, upstream's a_dither 0,
# Floyd and Steinberg's weights 9,500-9,970 and the other wrong dithers
# 60,000 and more; on the card, at 1080p -> 4K, the port 2,072-2,082 and
# the controls 168,000 and more.
LIMIT_PPM = 4000.0
SCALE = 16  # the 1080p -> 4K segment at 120x68 -> 240x135
SEGMENT = "avir_def_u8_rgb.video_segment_up"


def errdiff_cell(dither: str = "errdiff"):
    """The AVIR segment cell with ``dither``: the cell a dithering
    configuration will bring."""
    cell = spec.load_cell(spec.load_benchmark(), SEGMENT)
    return dataclasses.replace(cell, config={**cell.config, "dither": dither})


def ppm(out: torch.Tensor, exact: torch.Tensor, step=1.0, clamp=255.0) -> float:
    return 1e6 * errdiff.misses(out, exact, W, step, clamp, check.TOLERANCE) / out.numel()


def row_by_row(x: np.ndarray, weights, step: float, clamp: float) -> np.ndarray:
    """AVIR's rule written out: rows top to bottom, values left to right,
    the sums in ``errdiff.py``'s order."""
    wr, wl, wc, wn = weights
    h, w, b = x.shape
    n = np.zeros((h + 1, w + 2, b))  # row y at y + 1, column x at x + 1
    out = np.empty_like(x)
    for y in range(h):
        for xx in range(w):
            cur = x[y, xx] + wr * n[y + 1, xx]
            cur = cur + wl * n[y, xx + 2]
            cur = cur + wc * n[y, xx + 1]
            cur = cur + wn * n[y, xx]
            z0 = np.floor(cur / step + 0.5) * step
            out[y, xx] = np.clip(z0, 0.0, clamp)
            n[y + 1, xx + 1] = cur - z0
    return out


@pytest.fixture(scope="module")
def segment():
    """Two frames of the segment mix cut by SCALE, their exact float64
    frames [H, W, 6] and the reference."""
    src, dst = harness.geometry(spec.load_json(spec.HERE, "traffic", "video_segment_up"), SCALE)
    ref = avir.build(errdiff_cell().config, src, dst)
    frames = harness.make_pool(2147483659, 2, (src[1], src[0], 3), torch.device("cpu"))
    exact = lanes(torch.stack([ref.forward(x) for x in frames]))
    return src, dst, ref, frames, exact


@pytest.mark.parametrize("step,clamp", [(1.0, 255.0), (1.0, 65535.0), (4.0, 255.0)])
def test_the_walk_is_the_rule_row_by_row(step, clamp):
    """``diffuse`` along diagonals equals the rule run row by row, bit for
    bit, with values past both clamps."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2 * clamp, 1.2 * clamp, (13, 17, 4))
    got = errdiff.diffuse(torch.from_numpy(x), W, step, clamp).numpy()
    np.testing.assert_array_equal(got, row_by_row(x, W, step, clamp))


@pytest.mark.parametrize("step,clamp", [(1.0, 255.0), (1.0, 65535.0), (4.0, 255.0)])
def test_the_reading_is_0_on_the_references_own_diffusion(step, clamp):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-0.3 * clamp, 1.3 * clamp, (40, 57, 6)))
    assert ((x < 0) & (errdiff.diffuse(x, W, step, clamp) == 0)).any()
    assert errdiff.misses(errdiff.diffuse(x, W, step, clamp), x, W, step, clamp, 0.0) == 0


def test_finish_diffuses_each_frame_and_channel_alone():
    ref = avir.build(AVIR, (37, 29), (53, 41))
    assert ref.errdiff is None
    for dither in ("errdiff", "errdiff-device"):
        assert avir.build({**AVIR, "dither": dither}, (37, 29), (53, 41)).errdiff == W
    with pytest.raises(ValueError):
        avir.build({**AVIR, "dither": "floyd"}, (37, 29), (53, 41))
    dref = dataclasses.replace(ref, errdiff=W)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (3, 29, 37, 3), dtype=np.uint8))
    y = torch.stack([ref.forward(f) for f in x])
    both = dref.finish(y)
    for f in range(3):
        assert torch.equal(dref.finish(y[f]), both[f])
        for c in range(3):
            alone = errdiff.diffuse(y[f, :, :, c : c + 1].contiguous(), W, 1.0, 255.0)
            assert torch.equal(alone[..., 0], both[f, :, :, c])
    assert torch.equal(ref.finish(y), torch.floor(y + 0.5).clamp(0, 255))


@pytest.mark.parametrize("dither", ["errdiff", "errdiff-device"])
def test_the_ports_errdiff_is_under_the_limit(segment, dither):
    src, dst, ref, frames, exact = segment
    cell = errdiff_cell(dither)
    fn = spec.program("avir").make(cell.config, src, dst, torch.device("cpu"))
    out = lanes(torch.stack([fn(x) for x in frames]))
    assert out.dtype == torch.uint8
    assert 0 < ppm(out, exact) < LIMIT_PPM


def test_upstreams_own_output_is_under_the_limit():
    """The C++ library's error-diffused u8 output (float32 inside),
    ``tests/golden/data/a_dither.npy``, against the float64 frame of its
    source."""
    entry = json.loads((GOLDEN / "manifest.json").read_text())["a_dither"]
    sw, sh, nw, nh, ch = (entry[k] for k in ("sw", "sh", "nw", "nh", "ch"))
    assert entry["dither"] == "errd" and entry["preset"] == "def"
    x = xs128_u8(sw * sh * ch, entry["seed"]).reshape(sh, sw, ch)
    ref = avir.build({**AVIR, "channels": ch}, (sw, sh), (nw, nh))
    exact = ref.forward(torch.from_numpy(x)).contiguous()
    out = torch.from_numpy(np.load(GOLDEN / "a_dither.npy")).contiguous()
    assert ppm(out, exact) < LIMIT_PPM


def wrong_dithers(ref, frames, exact):
    low = lanes(torch.stack([ref.forward(x, dtype=torch.bfloat16) for x in frames]))
    return {
        "rounded": torch.floor(exact + 0.5).clamp(0, 255),
        "bfloat16": errdiff.diffuse(low, W, 1.0, 255.0),
        "floyd_steinberg": errdiff.diffuse(exact, FLOYD_STEINBERG, 1.0, 255.0),
        "right_to_left": errdiff.diffuse(exact.flip(1).contiguous(), W, 1.0, 255.0).flip(1),
    }


@pytest.mark.parametrize("name", ["rounded", "bfloat16", "floyd_steinberg", "right_to_left"])
def test_a_wrong_dither_is_over_the_limit(segment, name):
    _, _, ref, frames, exact = segment
    out = wrong_dithers(ref, frames, exact)[name].to(torch.uint8).contiguous()
    assert ppm(out, exact) > LIMIT_PPM


LIMITS = {"excess_lsb": {"limit": 0.6}, "diffusion_miss_ppm": {"limit": LIMIT_PPM},
          "bad_frames": {"limit": 0}}


def test_both_controls_come_out_not_correct(monkeypatch, capsys):
    """control.py --dither errdiff: its two controls for a dithering
    reference fail a dithering cell's limits, which the port passes."""
    load_cell = spec.load_cell

    def two_frames(bench, name):
        cell = load_cell(bench, name)
        return dataclasses.replace(
            cell, traffic={**cell.traffic, "frames_per_request": 2, "check_requests": 1}
        )

    monkeypatch.setattr(spec, "load_cell", two_frames)
    argv = ["--workload", SEGMENT, "--seeds", "13", "--control-seeds", "13", "--device", "cpu",
            "--scale", str(SCALE), "--dither", "errdiff"]
    assert control.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["dither"] == "errdiff" and set(line["seconds"]) == {"program", "control", "control_rounded"}
    for side in ("control", "control_rounded"):
        correct, checks = check.judge(line[side], LIMITS)
        assert not correct and list(checks) == ["excess_lsb", "diffusion_miss_ppm", "bad_frames"], line
    assert check.judge(line["program"], LIMITS)[0], line


def test_judge_holds_the_readings_the_reference_decides():
    """A dithered output is held to excess_lsb, diffusion_miss_ppm and
    bad_frames, a rounded one to excess_lsb, mismatch_ppm and bad_frames:
    each needs its reading and its limit, whatever the limits file names."""
    dithered = {"excess_lsb": 0.5, "diffusion_miss_ppm": 10.0, "bad_frames": 0}
    assert check.judge(dithered, LIMITS) == (True, {n: {"value": v, "limit": LIMITS[n]["limit"]}
                                                    for n, v in dithered.items()})
    for name in LIMITS:  # a limit left out, or its name misspelt
        assert not check.judge(dithered, {k: v for k, v in LIMITS.items() if k != name})[0]
        misspelt = {(k + "s" if k == name else k): v for k, v in LIMITS.items()}
        assert not check.judge(dithered, misspelt)[0]
        assert not check.judge({**dithered, name: None}, LIMITS)[0]
    assert not check.judge(dithered, {"bad_frames": {"limit": 0}})[0]
    assert not check.judge(dithered, None)[0]
    rounded = {"excess_lsb": 0.3, "mismatch_ppm": 10.0, "bad_frames": 0}
    limits = {**LIMITS, "mismatch_ppm": {"limit": 100.0}}
    assert list(check.judge(rounded, limits)[1]) == ["excess_lsb", "mismatch_ppm", "bad_frames"]
    assert check.judge(rounded, limits)[0]
    assert not check.judge(rounded, LIMITS)[0]
    # Readings name the reading that the reference decides, frames or none.
    ref = avir.build(AVIR, (11, 9), (7, 5))
    for dref in (ref, dataclasses.replace(ref, errdiff=W)):
        readings = check.Readings()
        readings.add_all([torch.zeros(3, dtype=torch.uint8)], dref, [torch.zeros(5, 7, 3)])
        assert tuple(readings.result()) == check.judged(dref.errdiff is not None)
        assert not check.judge(readings.result(), limits)[0]


# The check as it was before diffusion_miss_ppm: every u8 frame alone, the
# three readings, each held to its limit.
class OldReadings:
    def __init__(self):
        self.excess, self.mismatches, self.values, self.frames, self.bad_frames = float("-inf"), 0, 0, 0, 0

    def add(self, out, ref, exact):
        want = ref.finish(exact)
        if not isinstance(out, torch.Tensor) or out.dtype != torch.uint8 or tuple(out.shape) != tuple(exact.shape):
            self.bad_frames += 1
            return
        got = out.to(exact.device, torch.float64)
        dist = (got - exact.clamp(0.0, ref.clamp)).abs().max().item()
        self.excess = max(self.excess, dist - 0.5)
        self.mismatches += int((got != want).sum().item())
        self.values += got.numel()
        self.frames += 1

    def result(self):
        return {
            "excess_lsb": self.excess if self.frames else None,
            "mismatch_ppm": 1e6 * self.mismatches / self.values if self.values else None,
            "bad_frames": self.bad_frames,
        }


def old_judge(readings, limits):
    checks, correct = {}, True
    for name in ("excess_lsb", "mismatch_ppm", "bad_frames"):
        value, limit = readings.get(name), None if limits is None else limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or value > limit:
            correct = False
    return correct, checks


def off_by_one(fn):
    return lambda x: (fn(x).to(torch.int16) + 1).clamp(0, 255).to(torch.uint8)


@pytest.mark.parametrize("broken", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_the_cells_read_and_judge_as_before(name, broken):
    """At --scale 32, the port's outputs (and a broken path's) give the
    same readings, checks and verdict through the old and the new check."""
    cell, (src, dst) = small_cell(name)
    cpu = torch.device("cpu")
    fn = spec.program(cell.config["resizer"]).make(cell.config, src, dst, cpu)
    fn = off_by_one(fn) if broken else fn
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    pool = control.cell_pool(cell, 17, cpu, 32)
    new, old = check.Readings(), OldReadings()
    for k in range(2):
        frames = [pool[(k * 3 + j) % pool.shape[0]] for j in range(3)]
        outs = [fn(x) for x in frames]
        new.add_all(outs, ref, (ref.forward(x) for x in frames))
        for out, x in zip(outs, frames):
            old.add(out, ref, ref.forward(x))
    result = new.result()
    assert result == old.result()
    assert check.judge(result, cell.limits) == old_judge(old.result(), cell.limits)
    assert check.judge(result, cell.limits)[0] is not broken
    # A frame of the wrong type is a bad frame to both.
    new.add(outs[0].to(torch.int16), ref, ref.forward(frames[0]))
    old.add(outs[0].to(torch.int16), ref, ref.forward(frames[0]))
    assert new.result()["bad_frames"] == old.result()["bad_frames"] == 1


def test_the_u8_pool_has_the_bits_it_had():
    for device_seed in (7, 2**31 + 99):
        gen = torch.Generator()
        gen.manual_seed(device_seed)
        before = torch.randint(0, 256, (3, 5, 6, 3), dtype=torch.uint8, generator=gen)
        assert torch.equal(harness.make_pool(device_seed, 3, (5, 6, 3), torch.device("cpu")), before)


def test_u16_pool_and_type_check():
    pool = harness.make_pool(2**31 + 5, 4, (9, 11, 3), torch.device("cpu"), "uint16")
    assert pool.dtype == torch.uint16 and pool.shape == (4, 9, 11, 3)
    wide = pool.to(torch.int32)
    assert wide.max() > 255 and wide.min() >= 0
    assert torch.equal(pool, harness.make_pool(2**31 + 5, 4, (9, 11, 3), torch.device("cpu"), "uint16"))
    with pytest.raises(ValueError):
        harness.make_pool(1, 1, (2, 2, 1), torch.device("cpu"), "float32")
    # A u16 resize: the u16 operators of the AVIR planner in u16 units.
    ref = avir.build(AVIR, (11, 9), (7, 5))
    ref = dataclasses.replace(ref, clamp=65535.0)
    frames = list(pool[:2])
    exacts = [ref.forward(x) for x in frames]
    good = [ref.finish(e).to(torch.int32).to(torch.uint16) for e in exacts]
    readings = check.Readings(torch.uint16)
    readings.add_all(good, ref, exacts)
    readings.add(good[0].to(torch.uint8), ref, exacts[0])  # the wrong type
    result = readings.result()
    assert result["bad_frames"] == 1 and result["mismatch_ppm"] == 0
    assert -0.5 <= result["excess_lsb"] <= 0.0
    off = [(g.to(torch.int32) + 2).to(torch.uint16) for g in good]
    readings = check.Readings(torch.uint16)
    readings.add_all(off, ref, exacts)
    assert readings.result()["excess_lsb"] >= 1.5


def test_a_u16_cell_runs_its_pool_through_the_check(monkeypatch):
    """harness.measure draws the configuration's in_dtype and checks its
    out_dtype: a u16 configuration on the CPU, through the port."""
    cell, _ = small_cell(CELLS[0])
    config = {**cell.config, "in_dtype": "uint16", "out_dtype": "uint16", "res_bit_depth": 16,
              "precision": "exact"}
    limits = {"excess_lsb": {"limit": 1e9}, "bad_frames": {"limit": 0}}
    cell = dataclasses.replace(cell, config=config, limits=limits,
                               traffic={**cell.traffic, "check_requests": 1})

    class U16Ref:  # the AVIR reference in u16 units (out scale 65535 / 65535)
        @staticmethod
        def build(cfg, src, dst):
            return dataclasses.replace(avir.build(AVIR, src, dst), clamp=65535.0)

    monkeypatch.setattr(spec, "reference", lambda resizer: U16Ref)
    rec = harness.measure(cell, 3, 0.2, False, torch.device("cpu"), time.time(), scale=32)
    assert rec["checks"]["bad_frames"]["value"] == 0, rec["checks"]
    assert rec["checked_frames"] == cell.traffic["frames_per_request"]
