"""LANCIR in the port: the Lanczos filter bank and plan, K1's
round-half-even and ``scale`` epilogue (int8 and split-bf16 modes, both
pass orders), ``LancIR.resize`` and the float64 oracle, against the JAX
package on the CPU and the goldens of the compiled reference library.
The kernels themselves are held against their plain versions on the card
only (tests/test_torch_cuda.py).

Tolerances: the filter bank, the plan, the oracle and the K1 int8 plain
version are array-equal (bit-equal) to the JAX package's; the K1 split
plain version is within the split gate (tests/test_torch_split.py); the
public outputs hold tests/test_device_exec.py:61-84's gate against the
goldens (u8 1 LSB, u16 4 LSB, >= 60 dB; float 1e-4) and are within
1 LSB (float: 1e-4) of ``avir_tpu.LancIR().resize``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import load_golden, psnr, xorshift128_fill

import avir_tpu
from avir_tpu.filters.lanczos import LanczosBank as JaxLanczosBank
from avir_tpu.models.host_reference import (
    execute_lancir_numpy as jax_execute_lancir_numpy,
)
from avir_tpu.plan.lancir_plan import build_lancir_plan as jax_build_lancir_plan

from torch_cases import INT8_EPI_CASES, SPLIT_EPI_CASES

import avir_tpu_torch
from avir_tpu_torch.convert import lancir_plan_from_numpy
from avir_tpu_torch.filters import FRAC_COUNT, LanczosBank
from avir_tpu_torch.models import host_reference, lancir, runtime
from avir_tpu_torch.plan.lancir_plan import build_lancir_plan

from test_torch_gamma import (
    _cases,
    assert_split_gate,
    int8_epi_outputs,
    split_epi_outputs,
)
from test_torch_plan import DT, _M

torch.set_num_threads(1)

LANCIR_CONFIGS = [n for n, c in _M.items() if c.get("kind") == "lancir"]


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _source(cfg):
    return xorshift128_fill(
        (cfg["sh"], cfg["sw"], cfg["ch"]), DT[cfg["tin"]], cfg["seed"]
    )


def _kwargs(cfg):
    return dict(
        kx=cfg["kx"], ky=cfg["ky"], ox=cfg["ox"], oy=cfg["oy"], la=cfg["la"]
    )


def _plan_args(cfg):
    return (
        cfg["sw"], cfg["sh"], cfg["nw"], cfg["nh"], cfg["ch"],
        DT[cfg["tin"]], DT[cfg["tout"]],
    )


def _assert_close(out, ref, cfg, lsb=None):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if cfg["tout"] in ("f32", "f64"):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
        return
    peak = 255.0 if cfg["tout"] == "u8" else 65535.0
    if lsb is None:
        lsb = 1 if cfg["tout"] == "u8" else 4
    diff = np.abs(out.astype(np.float64) - ref.astype(np.float64)).max()
    assert diff <= lsb, f"maxdiff {diff}"
    assert psnr(out, ref, peak) >= 60.0


def test_lancir_configs_cover_the_goldens():
    assert len(LANCIR_CONFIGS) == 8


# ---------------------------------------------------------------------------
# Filters and plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0.5, 1.0, 2.37])
@pytest.mark.parametrize("la", [2.0, 3.0, 4.0])
def test_lanczos_bank_matches_jax(la, k):
    ours, ref = LanczosBank(la, k), JaxLanczosBank(la, k)
    assert (ours.kernel_len, ours.fl2) == (ref.kernel_len, ref.fl2)
    for x in np.linspace(0.0, 1.0, 2 * FRAC_COUNT + 3):
        np.testing.assert_array_equal(
            ours.filter_for_frac(float(x)), ref.filter_for_frac(float(x))
        )


@pytest.mark.parametrize("name", LANCIR_CONFIGS)
def test_lancir_plan_matches_jax(name):
    cfg = _M[name]
    ref = jax_build_lancir_plan(*_plan_args(cfg), **_kwargs(cfg))
    got = build_lancir_plan(*_plan_args(cfg), **_kwargs(cfg))
    for axis in ("h", "v"):
        r, g = getattr(ref, axis), getattr(got, axis)
        assert (g.n_in, g.n_out) == (r.n_in, r.n_out)
        np.testing.assert_array_equal(g.starts, r.starts)
        np.testing.assert_array_equal(g.taps, r.taps)
    for f in dataclasses.fields(ref):
        if f.name not in ("h", "v"):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name


def _jax_fields(jplan):
    fields = {
        f.name: getattr(jplan, f.name)
        for f in dataclasses.fields(jplan) if f.name not in ("h", "v")
    }
    for axis in ("h", "v"):
        op = getattr(jplan, axis)
        fields[axis] = (
            op.n_in, op.n_out, np.asarray(op.starts), np.asarray(op.taps)
        )
    return fields


def test_lancir_plan_from_numpy_carries_a_jax_plan():
    cfg = _M["l_mixed"]
    jplan = jax_build_lancir_plan(*_plan_args(cfg), **_kwargs(cfg))
    plan = lancir_plan_from_numpy(_jax_fields(jplan))
    ours = build_lancir_plan(*_plan_args(cfg), **_kwargs(cfg))
    for axis in ("h", "v"):
        np.testing.assert_array_equal(getattr(plan, axis).taps, getattr(ours, axis).taps)
        np.testing.assert_array_equal(getattr(plan, axis).starts, getattr(ours, axis).starts)
    src = _source(cfg)
    fn = runtime.make_lancir_executor(plan, device="cpu")
    got = fn(torch.from_numpy(src.reshape(cfg["sh"], -1))).numpy()
    want = runtime.make_lancir_executor(ours, device="cpu")(
        torch.from_numpy(src.reshape(cfg["sh"], -1))
    ).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="axis"):
        lancir_plan_from_numpy({**_jax_fields(jplan), "h": (1, 2)})


@pytest.mark.parametrize("name", ["l_down4u8", "l_gray16", "l_f32", "l_mixed"])
def test_execute_lancir_numpy_matches_jax(name):
    cfg = _M[name]
    src = _source(cfg)
    np.testing.assert_array_equal(
        host_reference.execute_lancir_numpy(
            build_lancir_plan(*_plan_args(cfg), **_kwargs(cfg)), src
        ),
        jax_execute_lancir_numpy(
            jax_build_lancir_plan(*_plan_args(cfg), **_kwargs(cfg)), src
        ),
    )


# ---------------------------------------------------------------------------
# K1's round-half-even / scale epilogue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _cases(INT8_EPI_CASES, False))
def test_int8_even_plain_matches_pallas(name):
    got, ref = int8_epi_outputs(name)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", _cases(SPLIT_EPI_CASES, False))
def test_split_even_plain_matches_pallas(name):
    assert_split_gate(*split_epi_outputs(name))


# ---------------------------------------------------------------------------
# Public resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LANCIR_CONFIGS)
def test_lancir_golden(name):
    cfg = _M[name]
    src = _source(cfg)
    kw = dict(out_dtype=DT[cfg["tout"]], **_kwargs(cfg))
    out = avir_tpu_torch.LancIR().resize(
        src, cfg["nw"], cfg["nh"], device="cpu", **kw
    )
    _assert_close(out, load_golden(name), cfg)
    _assert_close(
        out, avir_tpu.LancIR().resize(src, cfg["nw"], cfg["nh"], **kw), cfg,
        lsb=1,
    )


@pytest.mark.parametrize(
    "tin, tout, precision, route, modes, key",
    [
        ("u8", "u8", "auto", "int8", None, "fused_int8_vh_even"),
        ("u16", "u8", "auto", "split", ("split3", "split3"), "fused_split_vh_even"),
        ("u8", "u16", "auto", "split", ("split2", "split3"), "fused_split_vh_even"),
        ("f32", "f32", "auto", "split", ("split3", "split3"), "fused_split_vh_even"),
        ("u8", "u8", "fast", "split", ("split2", "split2"), "fused_split_vh_even"),
        ("u8", "u8", "exact", "exact", None, None),
    ],
)
def test_lancir_routing(tin, tout, precision, route, modes, key):
    """int8 for u8 in and u8 out at "auto" (the JAX package's
    runtime.py:624-629), split modes from resolve_modes otherwise; every
    K1 variant rounds half to even with the plan's out_mul as scale."""
    plan = build_lancir_plan(40, 30, 20, 15, 3, DT[tin], DT[tout])
    fn = runtime.make_lancir_executor(plan, precision=precision, device="cpu")
    assert fn.route == route
    if fn.ops is not None:
        assert fn.order == "vh" and fn.ops.launch_key == key
        assert fn.ops.epi.round_mode == "even"
        assert fn.ops.epi.scale == plan.out_mul
    if modes is not None:
        assert (fn.ops.mode_v, fn.ops.mode_h) == modes


@pytest.mark.parametrize("name", ["l_up3u8", "l_mixed", "l_f32"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_lancir_precision_tiers_match_jax(name, precision):
    """"exact" holds the golden gate against the JAX package's exact route
    and the golden; "fast" stays >= 50 dB against exact and against the
    JAX package's fast route (tests/test_device_exec.py:94-102)."""
    cfg = _M[name]
    src = _source(cfg)
    kw = dict(out_dtype=DT[cfg["tout"]], precision=precision, **_kwargs(cfg))
    out = avir_tpu_torch.LancIR().resize(src, cfg["nw"], cfg["nh"], device="cpu", **kw)
    ref = avir_tpu.LancIR().resize(src, cfg["nw"], cfg["nh"], **kw)
    if precision == "exact":
        _assert_close(out, ref, cfg, lsb=1)
        _assert_close(out, load_golden(name), cfg)
    elif cfg["tout"] == "f32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)
    else:
        assert psnr(out, ref, 255.0) >= 50.0


def test_lancir_f64_runs_the_host_oracle():
    cfg = _M["l_gray16"]
    src = _source(cfg)
    kw = dict(out_dtype=DT[cfg["tout"]], precision="f64", **_kwargs(cfg))
    out = avir_tpu_torch.LancIR().resize(src, cfg["nw"], cfg["nh"], **kw)
    np.testing.assert_array_equal(
        out, avir_tpu.LancIR().resize(src, cfg["nw"], cfg["nh"], **kw)
    )
    _assert_close(out, load_golden("l_gray16"), cfg)


def test_lancir_out_is_written_through_its_strides():
    src = xorshift128_fill((30, 40, 3), np.uint8, 9)
    buf = np.zeros((15, 40, 3), dtype=np.uint8)
    view = buf[:, ::2]
    rz = avir_tpu_torch.LancIR()
    got = rz.resize(src, 20, 15, out=view, device="cpu")
    assert got is view
    np.testing.assert_array_equal(view, rz.resize(src, 20, 15, device="cpu"))
    assert not buf[:, 1::2].any()
    with pytest.raises(ValueError, match="out shape"):
        rz.resize(src, 21, 15, out=view, device="cpu")


def test_lancir_grayscale_2d_and_float64():
    src = xorshift128_fill((40, 30), np.uint8, 77)
    out = avir_tpu_torch.lancir_resize(src, 45, 60, device="cpu")
    assert out.shape == (60, 45) and out.dtype == np.uint8
    f = src.astype(np.float64) / 255.0
    out = avir_tpu_torch.lancir_resize(f, 45, 60, device="cpu")
    assert out.dtype == np.float64
    np.testing.assert_allclose(
        out, avir_tpu.lancir_resize(f, 45, 60), rtol=0, atol=1e-4
    )


_BATCH = np.random.default_rng(4).integers(0, 256, (2, 20, 30, 3), dtype=np.uint8)


@pytest.mark.parametrize(
    "call",
    [
        lambda: (
            avir_tpu_torch.LancIR().resize_batch(_BATCH, 15, 10, device="cpu"),
            avir_tpu.LancIR().resize_batch(_BATCH, 15, 10),
        ),
        lambda: (
            lancir.make_lancir_resize_fn(
                (20, 30, 3), np.uint8, 15, 10, device="cpu"
            )(torch.from_numpy(_BATCH[0])).numpy(),
            np.asarray(
                avir_tpu.make_lancir_resize_fn((20, 30, 3), np.uint8, 15, 10)(_BATCH[0])
            ),
        ),
    ],
    ids=["resize_batch", "make_lancir_resize_fn"],
)
def test_batch_entry_points_raise(call):
    """The batch and device-function entry points, which raised until they
    were ported, now run and agree with the JAX package's within 1 LSB."""
    got, ref = call()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_lancir_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = np.zeros((20, 30, 3), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        avir_tpu_torch.lancir_resize(src, 15, 10)
