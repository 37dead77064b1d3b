"""sRGB gamma in the port: the gamma forms, K1's in-kernel gamma stages
(int8 and split-bf16 modes, both pass orders, the C=4 alpha bypass) and
``ImageResizer.resize(use_srgb_gamma=True)``, against the JAX package on
the CPU.  The kernels themselves are held against their plain versions on
the card only (tests/test_torch_cuda.py).

Tolerances:
  - the kernels' polynomial forms and the K1 int8 plain version are
    bit-equal to the JAX package's (interpret-mode Pallas): both write the
    same float32 steps and the same fused multiply-adds (ops/gamma.py);
  - the K1 split plain version sums in another order than the Pallas
    kernel (tests/test_torch_split.py): float32 within max|ref| * 1e-4,
    integers within 1 LSB (one quantization step with ``trunc_bits``;
    the float32 gate on the output's range plus one step when a scale
    > 1 or gamma-out amplifies the difference, ``torch_cases.split_tol``);
  - public outputs, tests/test_device_exec.py's gate: u8 1 LSB, u16
    4 LSB, >= 60 dB, against the goldens, ``avir_tpu.resize`` and the
    float64 oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden, psnr, xorshift128_fill

import avir_tpu
from avir_tpu.models.host_reference import (
    execute_plan_numpy as jax_execute_plan_numpy,
)
from avir_tpu.ops import gamma as jax_gamma
from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.lanes import lane_block_banded as jax_lane_block_banded
from avir_tpu.ops.pallas import fused_kernel as jax_fk
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from torch_cases import (
    IN_BYTES,
    INT8_EPI_CASES,
    NP_TYPES,
    SPLIT_EPI_CASES,
    epi_kwargs,
    split_source,
    split_tol,
)

import avir_tpu_torch
from avir_tpu_torch.models import host_reference, runtime
from avir_tpu_torch.ops import gamma
from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import fused_kernel as fk
from avir_tpu_torch.ops.cuda import fused_split as fs
from avir_tpu_torch.ops.lanes import lane_block_banded
from avir_tpu_torch.plan.plan import build_resize_plan

from test_torch_plan import DT, _M

torch.set_num_threads(1)

_TORCH = {"u8": torch.uint8, "u16": torch.uint16, "f32": torch.float32}
GAMMA_GOLDENS = ["a_gray16gamma", "a_rgba8gamma", "a_rgba16gamma"]


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _cases(table, gamma_cases):
    return [n for n, case in table.items() if case[-2] == gamma_cases]


# ---------------------------------------------------------------------------
# K1 epilogue variants, plain version against interpret-mode Pallas (shared
# with tests/test_torch_lancir.py)
# ---------------------------------------------------------------------------


def int8_epi_outputs(name):
    """(port plain version, interpret-mode Pallas) outputs of an
    INT8_EPI_CASES case."""
    sw, sh, nw, nh, c, tile, order, rm, scale, g, alpha = INT8_EPI_CASES[name]
    x = np.random.default_rng(sum(map(ord, name))).integers(
        0, 256, (sh, sw * c), dtype=np.uint8
    )
    plan_kw = dict(use_srgb_gamma=g, alpha_index=alpha)
    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, **plan_kw)
    jvop = jax_block_banded(jplan.v.op)
    jlop = jax_lane_block_banded(jplan.h.op, c, tile=tile)
    ref = jax_fk.apply_fused_pallas(
        jvop, jlop, jnp.asarray(x), "int8", "int8", out_dtype=jnp.uint8,
        out_max=255.0, order=order, interpret=True,
        **epi_kwargs(jplan, rm, scale, g, alpha),
    )
    ref = np.asarray(ref)[:nh, : nw * c]

    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, **plan_kw)
    lop = lane_block_banded(plan.h.op, c, tile=tile)
    assert (lop.chunk_rel is None) == (jlop.chunk_rel is None)
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lop, order, "cpu",
        **epi_kwargs(plan, rm, scale, g, alpha),
    )
    got = fk.apply_fused_int8(ops, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (nh, nw * c)
    return got, ref


def split_epi_outputs(name):
    """(port plain version, interpret-mode Pallas, out type, out_max,
    trunc_bits, scale, gamma) of a SPLIT_EPI_CASES case."""
    (sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb, rm, scale, g,
     alpha) = SPLIT_EPI_CASES[name]
    out_max = 255.0 if tout == "u8" else 65535.0
    x = split_source(name, sh, sw, c, tin)
    ib = IN_BYTES[tin]
    types = (NP_TYPES[tin], NP_TYPES[tout])
    plan_kw = dict(use_srgb_gamma=g, alpha_index=alpha)
    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, *types, **plan_kw)
    jvop = jax_block_banded(jplan.v.op, in_bytes=ib)
    jlop = jax_lane_block_banded(jplan.h.op, c, tile=tile, in_bytes=ib)
    ref = jax_fk.apply_fused_pallas(
        jvop, jlop, jnp.asarray(x), mv, mh,
        out_dtype=jnp.dtype(NP_TYPES[tout]), out_max=out_max, trunc_bits=tb,
        order=order, interpret=True, **epi_kwargs(jplan, rm, scale, g, alpha),
    )
    ref = np.asarray(ref)[:nh, : nw * c]

    plan = build_resize_plan(sw, sh, nw, nh, c, *types, **plan_kw)
    ops = fs.prepare_fused_split(
        block_banded(plan.v.op, in_bytes=ib),
        lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib),
        order, mv, mh, "cpu", out_dtype=_TORCH[tout], out_max=out_max,
        trunc_bits=tb, **epi_kwargs(plan, rm, scale, g, alpha),
    )
    got = fs.apply_fused_split(ops, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (nh, nw * c)
    assert got.dtype == ref.dtype
    return got, ref, tout, out_max, tb, scale, g


def assert_split_gate(got, ref, tout, out_max, tb, scale, g):
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64)).max()
    ref_max = float(np.abs(ref.astype(np.float64)).max())
    assert diff <= split_tol(tout, ref_max, out_max, tb, scale, g) + 1e-9, diff


@pytest.mark.parametrize("name", _cases(INT8_EPI_CASES, True))
def test_int8_gamma_plain_matches_pallas(name):
    got, ref = int8_epi_outputs(name)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", _cases(SPLIT_EPI_CASES, True))
def test_split_gamma_plain_matches_pallas(name):
    assert_split_gate(*split_epi_outputs(name))


# ---------------------------------------------------------------------------
# The gamma forms
# ---------------------------------------------------------------------------


def test_oracle_forms_match_jax():
    x = np.concatenate(
        [load_golden("f_srgb_x").ravel(), np.linspace(0.0, 1.0, 4001)]
    )
    np.testing.assert_array_equal(
        gamma.srgb_to_linear_np(x), jax_gamma.srgb_to_linear_np(x)
    )
    np.testing.assert_array_equal(
        gamma.linear_to_srgb_np(x), jax_gamma.linear_to_srgb_np(x)
    )
    rgba = np.random.default_rng(1).random((7, 5, 4))
    for alpha in (0, 3):
        np.testing.assert_array_equal(
            gamma.srgb_to_linear_np(rgba, alpha),
            jax_gamma.srgb_to_linear_np(rgba, alpha),
        )
        np.testing.assert_array_equal(
            gamma.linear_to_srgb_np(rgba, alpha),
            jax_gamma.linear_to_srgb_np(rgba, alpha),
        )


@pytest.mark.parametrize("c, alpha", [(3, -1), (4, 3), (4, 0)])
@pytest.mark.parametrize(
    "form", ["_srgb_to_linear", "_srgb_to_linear13_u8poly", "_linear_to_srgb"]
)
def test_kernel_forms_match_pallas_forms(form, c, alpha):
    """The division-free forms, bit-equal to the JAX package's as XLA
    compiles them on the CPU, over the u8 grid and random values in
    [0, 1] (and slightly outside, where the kernels clamp)."""
    rng = np.random.default_rng(11)
    x = rng.random((64, 96 * c), dtype=np.float32)
    if form == "_srgb_to_linear13_u8poly":
        x = (rng.integers(0, 256, x.shape).astype(np.float32)
             * np.float32(1.0 / 255.0))
        x[0, :256] = np.arange(256) * np.float32(1.0 / 255.0)
    elif form == "_linear_to_srgb":
        x[1] = np.linspace(-0.01, 1.01, x.shape[1], dtype=np.float32)
    ref = np.asarray(
        jax.jit(lambda v: getattr(jax_fk, form)(v, c, alpha))(jnp.asarray(x))
    )
    got = getattr(gamma, form)(torch.from_numpy(x), c, alpha).numpy()
    np.testing.assert_array_equal(got, ref)


def test_int8_limbs_match_jax():
    q = np.arange(-9000, 9001, dtype=np.int32)
    r1, r0 = jax_fk._int8_limbs(jnp.asarray(q))
    g1, g0 = gamma._int8_limbs(torch.from_numpy(q))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(g0.numpy(), np.asarray(r0))


# ---------------------------------------------------------------------------
# Public resize with gamma
# ---------------------------------------------------------------------------


def _source(cfg):
    return xorshift128_fill(
        (cfg["sh"], cfg["sw"], cfg["ch"]), DT[cfg["tin"]], cfg["seed"]
    )


def _resize(pkg, cfg, src, **kw):
    return pkg.ImageResizer(
        res_bit_depth=cfg["bitdepth"], params=pkg.preset(cfg["preset"])
    ).resize(
        src, cfg["nw"], cfg["nh"], k=cfg["k"], ox=cfg["ox"], oy=cfg["oy"],
        out_dtype=DT[cfg["tout"]], use_srgb_gamma=True,
        alpha_index=cfg["alphaidx"], **kw,
    )


def _plan(cfg):
    return build_resize_plan(
        cfg["sw"], cfg["sh"], cfg["nw"], cfg["nh"], cfg["ch"],
        DT[cfg["tin"]], DT[cfg["tout"]], k=cfg["k"], ox=cfg["ox"],
        oy=cfg["oy"], params=avir_tpu_torch.preset(cfg["preset"]),
        res_bit_depth=cfg["bitdepth"], use_srgb_gamma=True,
        alpha_index=cfg["alphaidx"],
    )


def _assert_close(out, ref, cfg):
    """tests/test_device_exec.py's gate: u8 1 LSB, u16 4 LSB, >= 60 dB."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    peak = 255.0 if cfg["tout"] == "u8" else 65535.0
    lsb_tol = 1 if cfg["tout"] == "u8" else 4
    diff = np.abs(out.astype(np.float64) - ref.astype(np.float64)).max()
    assert diff <= lsb_tol, f"maxdiff {diff}"
    assert psnr(out, ref, peak) >= 60.0


@pytest.mark.parametrize("name", GAMMA_GOLDENS)
def test_gamma_golden(name):
    """Against the golden, the JAX package's resize and the port's own
    float64 oracle.  The u16 configs run K1 split3 with the degree-9
    float32 linearization; the u8 one runs K1 int8 with the 13-bit
    linearization."""
    cfg = _M[name]
    assert cfg["gamma"] == 1
    src = _source(cfg)
    out = _resize(avir_tpu_torch, cfg, src, device="cpu")
    _assert_close(out, load_golden(name), cfg)
    _assert_close(out, _resize(avir_tpu, cfg, src), cfg)
    _assert_close(out, host_reference.execute_plan_numpy(_plan(cfg), src), cfg)


@pytest.mark.parametrize("name", GAMMA_GOLDENS)
def test_execute_plan_numpy_gamma_matches_jax(name):
    cfg = _M[name]
    src = _source(cfg)
    jplan = jax_build_resize_plan(
        cfg["sw"], cfg["sh"], cfg["nw"], cfg["nh"], cfg["ch"],
        DT[cfg["tin"]], DT[cfg["tout"]], k=cfg["k"], ox=cfg["ox"],
        oy=cfg["oy"], params=avir_tpu.preset(cfg["preset"]),
        res_bit_depth=cfg["bitdepth"], use_srgb_gamma=True,
        alpha_index=cfg["alphaidx"],
    )
    plan = _plan(cfg)
    for kw in ({}, {"return_predither": True}):
        np.testing.assert_array_equal(
            host_reference.execute_plan_numpy(plan, src, **kw),
            jax_execute_plan_numpy(jplan, src, **kw),
        )


def test_gamma_precision_tiers():
    """"exact" (rational gamma forms around full-float32 passes) holds the
    golden gate against the JAX package's exact route and the golden;
    "fast" (split2 for both passes, so linearized input is cut to bf16)
    stays >= 50 dB against exact, the JAX package's own gate
    (tests/test_device_exec.py:94-102), and against the JAX package's
    fast route."""
    cfg = _M["a_rgba8gamma"]
    src = _source(cfg)
    exact = _resize(avir_tpu_torch, cfg, src, device="cpu", precision="exact")
    _assert_close(exact, _resize(avir_tpu, cfg, src, precision="exact"), cfg)
    _assert_close(exact, load_golden("a_rgba8gamma"), cfg)
    fast = _resize(avir_tpu_torch, cfg, src, device="cpu", precision="fast")
    assert psnr(exact, fast, 255.0) >= 50.0
    assert psnr(_resize(avir_tpu, cfg, src, precision="fast"), fast, 255.0) >= 50.0


@pytest.mark.parametrize("tin, tout, bits", [("u8", "u8", 8), ("u16", "u16", 16)])
def test_gamma_errdiff_matches_jax(tin, tout, bits):
    """Error diffusion after gamma-out: K1 split writes float32 after the
    unpack stage, then K4 quantizes; one quantization step plus the
    device pipeline's own LSB, as tests/test_device_exec.py gates it."""
    src = xorshift128_fill((41, 57, 4), NP_TYPES[tin], 5)
    kw = dict(use_srgb_gamma=True, alpha_index=3, dither="errdiff")
    out = avir_tpu_torch.ImageResizer(res_bit_depth=bits).resize(
        src, 90, 70, device="cpu", **kw
    )
    ref = avir_tpu.ImageResizer(res_bit_depth=bits).resize(src, 90, 70, **kw)
    peak = 255.0 if tout == "u8" else 65535.0
    tol = (1 if tout == "u8" else 4) + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.abs(out.astype(np.float64) - ref.astype(np.float64)).max() <= tol
    assert psnr(out, ref, peak) >= 60.0


def test_int8_gamma_within_one_lsb_of_linear_light_exact():
    """K1 int8 with gamma against the exact route (rational forms,
    full-float32 passes): within 1 LSB, as the JAX package holds its own
    int8 gamma mode (tests/test_pallas_kernel.py:508-557)."""
    src = xorshift128_fill((150, 200, 3), np.uint8, 33)
    rz = avir_tpu_torch.ImageResizer()
    auto = rz.resize(src, 80, 60, use_srgb_gamma=True, device="cpu")
    exact = rz.resize(
        src, 80, 60, use_srgb_gamma=True, precision="exact", device="cpu"
    )
    assert np.abs(auto.astype(int) - exact.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# Routing, and the two faults the gamma path reaches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "src_dtype, out_dtype, errdiff, precision, route, modes",
    [
        (np.uint8, np.uint8, False, "auto", "int8", None),
        (np.uint8, np.uint8, True, "auto", "split", ("split3", "split3")),
        (np.uint8, np.uint16, False, "auto", "split", ("split3", "split3")),
        (np.uint16, np.uint16, False, "auto", "split", ("split3", "split3")),
        (np.float32, np.float32, False, "auto", "split", ("split3", "split3")),
        (np.uint8, np.uint8, False, "fast", "split", ("split2", "split2")),
        (np.uint8, np.uint8, False, "exact", "exact", None),
    ],
)
def test_gamma_routing(src_dtype, out_dtype, errdiff, precision, route, modes):
    """int8 (13-bit linear light) for u8 in / 8-bit out / auto; otherwise
    the split modes with the first pass in split3: linearized u8 is not
    exact in bf16 (the JAX package's runtime.py:330-334).  A first pass
    in split2 here was a fault of the port."""
    plan = build_resize_plan(
        30, 20, 15, 10, 4, src_dtype, out_dtype, use_srgb_gamma=True,
        alpha_index=3,
    )
    assert not runtime.in_exact_bf16(plan)
    fn = runtime.make_avir_executor(
        plan, errdiff=errdiff, precision=precision, device="cpu"
    )
    assert fn.route == route
    if fn.ops is not None:
        assert fn.ops.epi.gamma and fn.ops.epi.alpha_lane == 3
        assert fn.ops.launch_key.endswith("_gamma")
    if modes is not None:
        assert (fn.ops.mode_v, fn.ops.mode_h) == modes


def test_int8_feasible_applies_the_gamma_s32_bound():
    """With gamma the first pass recombines limb products << 14, so the
    taps' per-output abs limb sums must keep it inside s32
    (fused_kernel.py:763-773 there); the x_shift test alone passes such
    taps.  Without the bound this was a fault of the port."""
    plan = build_resize_plan(200, 150, 80, 60, 3, np.uint8, np.uint8)
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, 3)
    assert fk.int8_feasible(vop, lop, "vh", gamma=True)
    big = dataclasses.replace(vop, q_abs1=1 << 11, q_abs0=0)
    assert fk.int8_feasible(big, lop, "vh", gamma=False)
    assert not fk.int8_feasible(big, lop, "vh", gamma=True)
    jplan = jax_build_resize_plan(200, 150, 80, 60, 3, np.uint8, np.uint8)
    jbig = dataclasses.replace(
        jax_block_banded(jplan.v.op), q_abs1=1 << 11, q_abs0=0
    )
    jlop = jax_lane_block_banded(jplan.h.op, 3)
    assert jax_fk.int8_feasible(jbig, jlop, "vh", gamma=False)
    assert not jax_fk.int8_feasible(jbig, jlop, "vh", gamma=True)
    # The gamma first pass's x_shift reads linear light (in_max = 1).
    assert fk._int8_x_shift(1.0, 20, in_max=1.0) == jax_fk._int8_x_shift(
        1.0, 20, in_max=1.0
    )
