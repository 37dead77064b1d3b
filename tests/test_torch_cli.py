"""The port's imageresize CLI (python -m avir_tpu_torch.cli) against the
JAX package's (avir_tpu/cli.py): each case of tests/test_cli.py runs both
tools on the same PNG and holds the port's output file to the JAX tool's,
byte for byte for PNG (for 16-bit output, which takes the split route,
its pixels within 1 LSB), and to the port's own ``resize`` of the same
input.

The JAX tool runs its TPU route in these tests: its Pallas kernels in interpret
mode (as tests/test_pallas_kernel.py runs them), its VMEM check taken as
true (as the port takes it).  On the CPU alone it would take its XLA
route, whose split-bf16 arithmetic is not the int8 kernel's, and 8-bit
files would differ in about 1% of their pixels by 1 LSB.
"""

import contextlib
import json
from unittest import mock

import numpy as np
import pytest

from avir_tpu import cli as jax_cli
from avir_tpu.models import runtime as jax_runtime
from avir_tpu.ops.pallas import banded_kernel as jax_bk
from avir_tpu.ops.pallas import fused_kernel as jax_fk
from avir_tpu.ops.pallas import lanes_kernel as jax_lk

import avir_tpu_torch
from avir_tpu_torch import cli, native

from conftest import xorshift128_fill


def _write_png(path, arr):
    path.write_bytes(native.png_encode(arr))


@contextlib.contextmanager
def jax_tpu_route():
    """The JAX package's TPU route on the CPU (module docstring)."""

    def interp(orig):
        def call(*a, **kw):
            kw["interpret"] = True
            return orig(*a, **kw)

        return call

    with mock.patch.object(jax_runtime, "_use_pallas", lambda engine: True), \
            mock.patch.object(jax_fk, "fused_viable", lambda *a, **kw: True), \
            mock.patch.object(jax_fk, "apply_fused_pallas", interp(jax_fk.apply_fused_pallas)), \
            mock.patch.object(jax_bk, "apply_blocked_pallas", interp(jax_bk.apply_blocked_pallas)), \
            mock.patch.object(jax_lk, "apply_lanes_pallas", interp(jax_lk.apply_lanes_pallas)):
        yield


def _both(tmp_path, inp, name, *flags):
    """Run both CLIs on ``inp``; return (port output, JAX output) paths."""
    ours, theirs = tmp_path / "torch", tmp_path / "jax"
    ours.mkdir(exist_ok=True)
    theirs.mkdir(exist_ok=True)
    assert cli.main([str(inp), str(ours / name), *flags, "--device", "cpu"]) == 0
    with jax_tpu_route():
        assert jax_cli.main([str(inp), str(theirs / name), *flags]) == 0
    return ours / name, theirs / name


def _same_png(a, b):
    assert a.read_bytes() == b.read_bytes()


@pytest.fixture()
def rgb_png(tmp_path):
    src = xorshift128_fill((48, 64, 3), np.uint8, 101)
    p = tmp_path / "in.png"
    _write_png(p, src)
    return p, src


def test_basic_resize_png(tmp_path, rgb_png):
    inp, src = rgb_png
    ours, theirs = _both(tmp_path, inp, "out.png", "--out-size=32x24")
    got = cli.load_image(str(ours))
    assert got.shape == (24, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, avir_tpu_torch.resize(src, 32, 24, device="cpu"))
    _same_png(ours, theirs)


def test_aspect_auto_axis(tmp_path, rgb_png):
    inp, _ = rgb_png
    ours, theirs = _both(tmp_path, inp, "out.png", "--out-size=32x0")
    assert cli.load_image(str(ours)).shape == (24, 32, 3)
    _same_png(ours, theirs)


def test_lancir_and_preset(tmp_path, rgb_png):
    inp, _ = rgb_png
    ours, theirs = _both(tmp_path, inp, "l.png", "--out-size=20x16", "--lancir")
    assert cli.load_image(str(ours)).shape == (16, 20, 3)
    _same_png(ours, theirs)
    ours, theirs = _both(tmp_path, inp, "u.png", "--out-size=20x16", "--algparams=ultra")
    _same_png(ours, theirs)


def test_lancir_rejects_gamma(tmp_path, rgb_png):
    inp, _ = rgb_png
    with pytest.raises(SystemExit):
        cli.main([str(inp), str(tmp_path / "x.png"), "--out-size=20x16",
                  "--lancir", "--gamma", "--device", "cpu"])


def test_dither_and_1bit(tmp_path, rgb_png):
    inp, _ = rgb_png
    ours, theirs = _both(tmp_path, inp, "d.png", "--out-size=24x16", "--dither")
    _same_png(ours, theirs)
    ours, theirs = _both(tmp_path, inp, "b.png", "--out-size=24x16", "--dither", "--1bit")
    assert set(np.unique(cli.load_image(str(ours)))) <= {0, 255}
    _same_png(ours, theirs)
    with pytest.raises(SystemExit):
        cli.main([str(inp), str(tmp_path / "y.png"), "--out-size=24x16",
                  "--1bit", "--device", "cpu"])


def test_16bit_roundtrip_and_force8(tmp_path):
    src = xorshift128_fill((32, 40, 3), np.uint16, 7)
    inp = tmp_path / "in16.png"
    _write_png(inp, src)
    ours, theirs = _both(tmp_path, inp, "out16.png", "--out-size=20x16")
    got = cli.load_image(str(ours))
    assert got.dtype == np.uint16
    # 16-bit output takes the split route, whose float32 sums run in
    # another order than the TPU kernel's: the split gate, 1 LSB.
    want = cli.load_image(str(theirs))
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    ours, theirs = _both(tmp_path, inp, "out8.png", "--out-size=20x16", "--force-8bit")
    assert cli.load_image(str(ours)).dtype == np.uint8
    _same_png(ours, theirs)


def test_gamma_alpha_zero_flush(tmp_path):
    src = xorshift128_fill((32, 32, 4), np.uint8, 31)
    src[:8, :8, 3] = 0
    inp = tmp_path / "in.png"
    _write_png(inp, src)
    ours, theirs = _both(
        tmp_path, inp, "out.png", "--out-size=16x16", "--gamma", "--zero-flush=8"
    )
    got = cli.load_image(str(ours))
    assert got.shape == (16, 16, 4)
    flushed = np.array(src)
    flushed[src[:, :, 3] < 8] = 0
    expect = avir_tpu_torch.ImageResizer(res_bit_depth=8, src_bit_depth=8).resize(
        flushed, 16, 16, use_srgb_gamma=True, alpha_index=3, device="cpu"
    )
    np.testing.assert_array_equal(got, expect)
    _same_png(ours, theirs)


def test_auto_scale(tmp_path, rgb_png, capsys):
    inp, _ = rgb_png
    out = tmp_path / "s.png"
    assert cli.main([str(inp), str(out), "--auto-scale=0.5;1.0", "--device", "cpu"]) == 0
    produced = json.loads(capsys.readouterr().out)["__file-list"]
    assert len(produced) == 2
    sizes = sorted((v["w"], v["h"]) for v in produced.values())
    assert sizes == [(32, 24), (64, 48)]
    jout = tmp_path / "j.png"
    with jax_tpu_route():
        assert jax_cli.main([str(inp), str(jout), "--auto-scale=0.5;1.0"]) == 0
    jproduced = json.loads(capsys.readouterr().out)["__file-list"]
    for path in produced:
        assert path.endswith(("-1.png", "-2.png"))
        twin = path.replace("s-", "j-")
        assert produced[path] == jproduced[twin]
        assert open(path, "rb").read() == open(twin, "rb").read()


def test_crop_and_fit(tmp_path, rgb_png):
    inp, _ = rgb_png
    ours, theirs = _both(tmp_path, inp, "c.png", "--out-size=16x16", "--crop=11")
    assert cli.load_image(str(ours)).shape == (16, 16, 3)
    _same_png(ours, theirs)
    ours, theirs = _both(tmp_path, inp, "f.png", "--out-size=32x32", "--fit")
    assert cli.load_image(str(ours)).shape == (24, 32, 3)
    _same_png(ours, theirs)
    with pytest.raises(SystemExit):
        cli.main([str(inp), str(tmp_path / "z.png"), "--out-size=16x16",
                  "--crop=11", "--fit", "--device", "cpu"])


def test_reflection(tmp_path, rgb_png):
    inp, _ = rgb_png
    ours, theirs = _both(tmp_path, inp, "r.png", "--out-size=32x24", "--reflection=8*0.5")
    got = cli.load_image(str(ours))
    assert got.shape == (32, 32, 4)
    assert (got[:24, :, 3] == 255).all()
    np.testing.assert_array_equal(got[24:, :, :3], got[16:24, :, :3][::-1])
    ramp = np.rint(255.0 * np.linspace(0.5, 0.0, 8)).astype(int)
    np.testing.assert_array_equal(got[24:, 0, 3].astype(int), ramp)
    _same_png(ours, theirs)


def test_jpeg_output(tmp_path, rgb_png):
    """JPEG goes through Pillow, as in the JAX tool: the same bytes from the
    same pixels, 4:2:2 with --jpeg-low-cs and 4:4:4 without."""
    from PIL import Image, JpegImagePlugin

    inp, _ = rgb_png
    ours, theirs = _both(
        tmp_path, inp, "o.jpg", "--out-size=32x24", "--out-quality=85", "--jpeg-low-cs"
    )
    assert cli.load_image(str(ours)).shape == (24, 32, 3)
    with Image.open(ours) as im:
        assert JpegImagePlugin.get_sampling(im) == 1
    assert ours.read_bytes() == theirs.read_bytes()
    ours, theirs = _both(tmp_path, inp, "o444.jpg", "--out-size=32x24", "--out-quality=85")
    with Image.open(ours) as im:
        assert JpegImagePlugin.get_sampling(im) == 0
    assert ours.read_bytes() == theirs.read_bytes()


def test_default_device_needs_a_card(tmp_path, rgb_png, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp, _ = rgb_png
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([str(inp), str(tmp_path / "x.png"), "--out-size=32x24"])
