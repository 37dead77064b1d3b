"""The port's public resize on the CPU (the kernels' plain versions)
against the golden outputs of the compiled reference library and against
the JAX package's own resize, on every golden config the port carries:
the int8 slice (u8 in, u8 out, 8-bit output, default dither) and the
full-precision configs (16-bit and float I/O, lower output bit depths,
error diffusion) that run K1's split-bf16 modes and the wavefront K4."""

import numpy as np
import pytest
import torch

from conftest import load_golden, psnr, xorshift128_fill

import avir_tpu

import avir_tpu_torch
from avir_tpu_torch.models import host_reference, runtime
from avir_tpu_torch.plan.plan import build_resize_plan

from test_torch_plan import DT, _M

torch.set_num_threads(1)

SLICE_CONFIGS = [
    "a_readme", "a_up3u8", "a_down3u8", "a_down8x", "a_same", "a_shift",
    "a_kneg", "a_kpos", "a_tiny", "a_one", "a_preset_ulr", "a_preset_lr",
    "a_preset_low", "a_preset_high", "a_preset_ultra", "a_presetd_ultra",
]


def _source(cfg):
    return xorshift128_fill(
        (cfg["sh"], cfg["sw"], cfg["ch"]), DT[cfg["tin"]], cfg["seed"]
    )


def _kwargs(cfg):
    return dict(k=cfg["k"], ox=cfg["ox"], oy=cfg["oy"])


def test_slice_configs_are_the_ported_ones():
    for name in SLICE_CONFIGS:
        cfg = _M[name]
        assert (cfg["tin"], cfg["tout"], cfg["gamma"], cfg["dither"],
                cfg["bitdepth"]) == ("u8", "u8", 0, "", 8)


@pytest.mark.parametrize("name", SLICE_CONFIGS)
def test_resize_golden(name):
    cfg = _M[name]
    src = _source(cfg)
    out = avir_tpu_torch.ImageResizer(
        params=avir_tpu_torch.preset(cfg["preset"])
    ).resize(src, cfg["nw"], cfg["nh"], device="cpu", **_kwargs(cfg))
    ref = load_golden(name)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.abs(out.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    assert psnr(out, ref, 255.0) >= 60.0

    # Within 1 LSB of the JAX package (whose CPU route is split-bf16,
    # not int8).
    jax_out = avir_tpu.ImageResizer(
        params=avir_tpu.preset(cfg["preset"])
    ).resize(src, cfg["nw"], cfg["nh"], **_kwargs(cfg))
    assert np.abs(out.astype(np.int16) - jax_out.astype(np.int16)).max() <= 1


# Full-precision goldens, with tests/test_device_exec.py's tolerances.
SPLIT_CONFIGS = [
    "a_up1u16", "a_in8out16", "a_in16out8", "a_f32", "a_f64", "a_bits6",
    "a_dither", "a_dither16", "a_shift16high", "a_shift16ultra",
]


def _resize_cfg(pkg, cfg, src, **kw):
    return pkg.ImageResizer(
        res_bit_depth=cfg["bitdepth"], params=pkg.preset(cfg["preset"])
    ).resize(
        src, cfg["nw"], cfg["nh"], out_dtype=DT[cfg["tout"]],
        dither="errdiff" if cfg["dither"] == "errd" else "default",
        **_kwargs(cfg), **kw,
    )


def _assert_close(out, ref, cfg):
    """tests/test_device_exec.py's gate: float atol 1e-4; integers 1 LSB
    (u8) or 4 LSB (u16), plus one quantization step for error diffusion,
    and >= 60 dB."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if cfg["tout"] in ("f32", "f64"):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
        return
    peak = 255.0 if cfg["tout"] == "u8" else 65535.0
    out_bits = 8 if cfg["tout"] == "u8" else 16
    lsb_tol = 1 if cfg["tout"] == "u8" else 4
    if cfg["dither"] == "errd":
        lsb_tol += 1 << (out_bits - cfg["bitdepth"])
    diff = np.abs(out.astype(np.float64) - ref.astype(np.float64)).max()
    assert diff <= lsb_tol, f"maxdiff {diff}"
    assert psnr(out, ref, peak) >= 60.0


@pytest.mark.parametrize("name", SPLIT_CONFIGS)
def test_resize_golden_full_precision(name):
    """Against the golden, the JAX package's resize and the port's own
    float64 host oracle (models/host_reference.py)."""
    cfg = _M[name]
    src = _source(cfg)
    out = _resize_cfg(avir_tpu_torch, cfg, src, device="cpu")
    _assert_close(out, load_golden(name), cfg)
    _assert_close(out, _resize_cfg(avir_tpu, cfg, src), cfg)
    plan = build_resize_plan(
        cfg["sw"], cfg["sh"], cfg["nw"], cfg["nh"], cfg["ch"],
        DT[cfg["tin"]], DT[cfg["tout"]], params=avir_tpu_torch.preset(cfg["preset"]),
        res_bit_depth=cfg["bitdepth"], **_kwargs(cfg),
    )
    oracle = host_reference.execute_plan_numpy(
        plan, src, errdiff=cfg["dither"] == "errd"
    )
    _assert_close(out, oracle, cfg)


@pytest.mark.parametrize("name", ["a_readme", "a_in16out8", "a_f32", "a_dither"])
def test_precision_exact_matches_jax(name):
    cfg = _M[name]
    src = _source(cfg)
    out = _resize_cfg(avir_tpu_torch, cfg, src, device="cpu", precision="exact")
    _assert_close(out, _resize_cfg(avir_tpu, cfg, src, precision="exact"), cfg)
    _assert_close(out, load_golden(name), cfg)


@pytest.mark.parametrize("name", ["a_readme", "a_up1u16"])
def test_precision_fast_quality(name):
    """split2 for both passes stays >= 50 dB against exact, the JAX
    package's own gate (tests/test_device_exec.py:102), against the port's
    exact route and the JAX package's, and >= 50 dB against the JAX
    package's own fast route (whose passes may run in the other order, so
    other intermediates round to bf16 and single pixels differ by 2 LSB)."""
    cfg = _M[name]
    src = _source(cfg)
    peak = 255.0 if cfg["tout"] == "u8" else 65535.0
    fast = _resize_cfg(avir_tpu_torch, cfg, src, device="cpu", precision="fast")
    exact = _resize_cfg(avir_tpu_torch, cfg, src, device="cpu", precision="exact")
    assert psnr(exact, fast, peak) >= 50.0
    assert psnr(_resize_cfg(avir_tpu, cfg, src, precision="exact"), fast, peak) >= 50.0
    assert psnr(_resize_cfg(avir_tpu, cfg, src, precision="fast"), fast, peak) >= 50.0


def test_resize_grayscale_2d():
    src = xorshift128_fill((40, 30), np.uint8, 77)
    out = avir_tpu_torch.resize(src, 45, 60, device="cpu")
    assert out.shape == (60, 45) and out.dtype == np.uint8


@pytest.mark.parametrize(
    "kwargs, src_dtype, c",
    [
        ({"dither": "errdiff-device"}, np.uint8, 3),
        ({"precision": "f64"}, np.uint8, 3),
        ({"dither": lambda img, tb, om, seed: img}, np.uint8, 3),
        ({"engine": "host"}, np.uint8, 3),
        ({"use_srgb_gamma": True, "dither": "errdiff-device"}, np.uint8, 3),
        ({"use_srgb_gamma": True, "precision": "f64"}, np.uint16, 3),
        ({"use_srgb_gamma": True, "engine": "host"}, np.float32, 3),
        ({"use_srgb_gamma": True, "alpha_index": 3, "precision": "f64"}, np.uint8, 4),
        ({}, np.uint8, 5),
    ],
)
def test_unsupported_configs_raise(kwargs, src_dtype, c):
    """The configurations that raised NotImplementedError until the rest of
    the public API was ported now run, gamma or not, and agree with the
    JAX package: the float64 host route to its bits (float: 5e-7), the
    device routes within 1 LSB (2 with error diffusion).  Unknown spellings
    still raise ValueError (tests/test_torch_api.py)."""
    src = xorshift128_fill((20, 30, c), src_dtype, 3)
    out = avir_tpu_torch.resize(src, 15, 10, device="cpu", **kwargs)
    ref = avir_tpu.resize(src, 15, 10, **kwargs)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    diff = np.abs(out.astype(np.float64) - ref.astype(np.float64)).max()
    if kwargs.get("precision") == "f64" or kwargs.get("engine") == "host":
        assert diff <= (5e-7 if out.dtype.kind == "f" else 0)
    else:
        assert diff <= (2 if kwargs.get("dither") == "errdiff-device" else 1)


def test_int8_infeasible_operator_raises(monkeypatch):
    """An operator whose int8 limbs are infeasible runs unfused (K2 and
    K3) in the split-bf16 modes, as the JAX package falls back
    (runtime.py:372-375)."""
    monkeypatch.setattr(runtime, "int8_feasible", lambda *a: False)
    cfg = _M["a_down3u8"]
    src = _source(cfg)
    fn = runtime.make_avir_executor(
        build_resize_plan(
            cfg["sw"], cfg["sh"], cfg["nw"], cfg["nh"], cfg["ch"],
            np.uint8, np.uint8, params=avir_tpu_torch.preset(cfg["preset"]),
            **_kwargs(cfg),
        ),
        device="cpu",
    )
    assert fn.route == "unfused" and fn.order == "vh"
    assert (fn.ops.mode_v, fn.ops.mode_h) == ("split2", "split3")
    out = avir_tpu_torch.ImageResizer(
        params=avir_tpu_torch.preset(cfg["preset"])
    ).resize(src, cfg["nw"], cfg["nh"], device="cpu", **_kwargs(cfg))
    ref = load_golden("a_down3u8")
    assert np.abs(out.astype(np.int16) - ref.astype(np.int16)).max() <= 1


@pytest.mark.parametrize(
    "src_dtype, out_dtype, kwargs, route, modes",
    [
        (np.uint8, None, {}, "int8", None),
        (np.uint8, None, {"dither": "errdiff"}, "split", ("split2", "split3")),
        (np.uint8, None, {"res_bit_depth": 6}, "split", ("split2", "split3")),
        (np.uint8, np.uint16, {}, "split", ("split2", "split3")),
        (np.uint16, None, {}, "split", ("split3", "split3")),
        (np.float32, None, {}, "split", ("split3", "split3")),
        (np.uint8, None, {"precision": "fast"}, "split", ("split2", "split2")),
        (np.uint8, None, {"precision": "exact"}, "exact", None),
    ],
)
def test_routing(src_dtype, out_dtype, kwargs, route, modes):
    """int8 only for u8 in / 8-bit out / default dither / auto; the split
    modes from resolve_modes otherwise (first pass split2 only over u8
    input); exact on request."""
    kwargs = dict(kwargs)
    plan = build_resize_plan(
        30, 20, 15, 10, 3, src_dtype, out_dtype or src_dtype,
        res_bit_depth=kwargs.pop("res_bit_depth", 8),
    )
    fn = runtime.make_avir_executor(
        plan, errdiff=kwargs.pop("dither", None) == "errdiff",
        precision=kwargs.pop("precision", "auto"), device="cpu",
    )
    assert fn.route == route and fn.order in ("vh", None)
    if modes is not None:
        assert (fn.ops.mode_v, fn.ops.mode_h) == modes


def test_dither_is_part_of_the_cache_key():
    cfg = _M["a_dither"]
    src = _source(cfg)
    rz = avir_tpu_torch.ImageResizer()
    plain = rz.resize(src, cfg["nw"], cfg["nh"], device="cpu")
    diffused = rz.resize(src, cfg["nw"], cfg["nh"], device="cpu", dither="errdiff")
    assert not np.array_equal(plain, diffused)
    np.testing.assert_array_equal(
        diffused,
        avir_tpu_torch.resize(src, cfg["nw"], cfg["nh"], device="cpu", dither="errdiff"),
    )
    ref = load_golden("a_dither")
    assert np.abs(diffused.astype(np.int16) - ref.astype(np.int16)).max() <= 2


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = np.zeros((20, 30, 3), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        avir_tpu_torch.resize(src, 15, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.resolve_device(None)
