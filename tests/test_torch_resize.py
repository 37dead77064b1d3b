"""The port's public resize on the CPU (the kernel's plain version) against
the golden outputs of the compiled reference library and against the
JAX package's own resize, on every golden config of the ported slice
(u8 in, u8 out, 8-bit output, no gamma, default dither)."""

import numpy as np
import pytest
import torch

from conftest import load_golden, psnr, xorshift128_fill

import avir_tpu

import avir_tpu_torch
from avir_tpu_torch.models import runtime

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


def test_resize_grayscale_2d():
    src = xorshift128_fill((40, 30), np.uint8, 77)
    out = avir_tpu_torch.resize(src, 45, 60, device="cpu")
    assert out.shape == (60, 45) and out.dtype == np.uint8


@pytest.mark.parametrize(
    "kwargs, src_dtype, c",
    [
        ({}, np.uint16, 3),
        ({"out_dtype": np.uint16}, np.uint8, 3),
        ({}, np.float32, 3),
        ({"use_srgb_gamma": True}, np.uint8, 3),
        ({"dither": "errdiff"}, np.uint8, 3),
        ({"res_bit_depth": 6}, np.uint8, 3),
        ({"precision": "exact"}, np.uint8, 3),
        ({}, np.uint8, 5),
    ],
)
def test_unsupported_configs_raise(kwargs, src_dtype, c):
    src = np.zeros((20, 30, c), dtype=src_dtype)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        avir_tpu_torch.resize(src, 15, 10, device="cpu", **kwargs)


def test_int8_infeasible_operator_raises(monkeypatch):
    monkeypatch.setattr(runtime, "int8_feasible", lambda *a: False)
    src = np.zeros((20, 30, 3), dtype=np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        avir_tpu_torch.resize(src, 15, 10, device="cpu")


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = np.zeros((20, 30, 3), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        avir_tpu_torch.resize(src, 15, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.resolve_device(None)
