"""K1 in its split-bf16 modes in the port: the plain PyTorch version
against the JAX package's Pallas kernel (interpret mode, on the CPU), and
the port's full-float32 ``apply_blocked`` against the JAX package's
"exact" mode.  The kernel itself is held against the plain version on the
card only (tests/test_torch_cuda.py).

Tolerances: the two sum bf16 x bf16 products in other orders.  Where an
intermediate value sits on a bf16 rounding boundary, the two split it
into different hi/lo pairs, which moves the result by up to ~2^-16 of
its size: float32 output agrees within max|ref| * 1e-4 (the JAX
package's own gate for its fused two-pass kernel,
tests/test_pallas_kernel.py:134; one split pass alone holds 1e-5 there,
as ``test_apply_blocked_exact_matches_jax``'s exact mode does here), and
integer output within one LSB, or one quantization step when
``trunc_bits`` > 0 (a value on a half-step boundary may round either
way)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avir_tpu.ops.banded import apply_blocked as jax_apply_blocked
from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.lanes import lane_block_banded as jax_lane_block_banded
from avir_tpu.ops.pallas.fused_kernel import apply_fused_pallas
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from torch_cases import (
    IN_BYTES,
    NP_TYPES,
    SPLIT_CASES,
    SPLIT_HV_EDGE_CASES,
    epi_kwargs,
    split_source,
    split_tol,
)

from avir_tpu_torch.ops.banded import apply_blocked, block_banded
from avir_tpu_torch.ops.cuda import fused_split as fs
from avir_tpu_torch.ops.cuda.fused_kernel import _k_ranges, h_ranges
from avir_tpu_torch.ops.lanes import lane_block_banded
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)

_TORCH = {"u8": torch.uint8, "u16": torch.uint16, "f32": torch.float32}


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_plain_matches_pallas_split(name):
    sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb = SPLIT_CASES[name]
    out_max = 255.0 if tout == "u8" else 65535.0
    x = split_source(name, sh, sw, c, tin)
    ib = IN_BYTES[tin]

    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout])
    jvop = jax_block_banded(jplan.v.op, in_bytes=ib)
    jlop = jax_lane_block_banded(jplan.h.op, c, tile=tile, in_bytes=ib)
    ref = apply_fused_pallas(
        jvop, jlop, jnp.asarray(x), mv, mh,
        out_dtype=jnp.dtype(NP_TYPES[tout]), out_max=out_max, trunc_bits=tb,
        order=order, interpret=True,
    )
    ref = np.asarray(ref)[: jvop.n_out, : jlop.n_out * c]

    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout])
    vop = block_banded(plan.v.op, in_bytes=ib)
    lop = lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib)
    assert (lop.chunk_rel is None) == (jlop.chunk_rel is None)
    ops = fs.prepare_fused_split(
        vop, lop, order, mv, mh, "cpu", out_dtype=_TORCH[tout],
        out_max=out_max, trunc_bits=tb,
    )
    got = fs.apply_fused_split(ops, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (nh, nw * c)
    assert got.dtype == ref.dtype
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    if tout == "f32":
        assert diff.max() <= np.abs(ref).max() * 1e-4
    else:
        step = out_max / (int(out_max) >> tb) if tb else 1.0
        assert diff.max() <= step + 1e-9, diff.max()


@pytest.mark.parametrize("tin", ["u8", "u16", "f32"])
def test_apply_blocked_exact_matches_jax(tin):
    sw, sh, nw, nh, c = 97, 61, 51, 140, 3
    x = split_source(tin, sh, sw, c, tin).astype(np.float32)
    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
    for axis, n_in in (("v", sh), ("h", sw)):
        xa = x if axis == "v" else x.reshape(sh, sw, c).transpose(1, 0, 2).reshape(sw, -1)
        ib = IN_BYTES[tin]
        ref = np.asarray(
            jax_apply_blocked(
                jax_block_banded(getattr(jplan, axis).op, in_bytes=ib),
                jnp.asarray(xa), "exact",
            )
        )
        got = apply_blocked(
            block_banded(getattr(plan, axis).op, in_bytes=ib),
            torch.from_numpy(np.ascontiguousarray(xa)),
        ).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=np.abs(ref).max() * 1e-5)


def test_h_ranges_cover_every_nonzero_tap():
    plan = build_resize_plan(300, 20, 1400, 41, 3, np.uint8, np.uint8)
    lop = lane_block_banded(plan.h.op, 3)
    hi, lo, _, win_c = fs._chunked_lane_taps(lop)
    rng = h_ranges((hi != 0).numpy(), (lo != 0).numpy())
    nz = ((hi != 0) | (lo != 0)).any(dim=3).numpy()
    rows = np.arange(win_c)
    inside = (rows >= rng[..., :1]) & (rows < rng[..., 1:])
    assert not (nz & ~inside).any()
    assert (rng[..., 0] % 32 == 0).all()
    assert ((rng[..., 1] % 32 == 0) | (rng[..., 1] == win_c)).all()


def _split_ops(name, order=None):
    """CPU operands of a SPLIT_CASES case (in ``order`` if given)."""
    sw, sh, nw, nh, c, tile, case_order, mv, mh, tin, tout, tb = SPLIT_CASES[name]
    ib = IN_BYTES[tin]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout])
    return fs.prepare_fused_split(
        block_banded(plan.v.op, in_bytes=ib),
        lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib),
        order or case_order, mv, mh, "cpu", out_dtype=_TORCH[tout],
        out_max=255.0 if tout == "u8" else 65535.0, trunc_bits=tb,
    )


@pytest.mark.parametrize("order, rows", [("vh", fs.VH_ROWS), ("hv", fs.HV_ROWS)])
@pytest.mark.parametrize("name", ["down_c3_u8_f32", "up_vh_c2_f32_u16", "vh_edge_down5_u8_u8"])
def test_k_ranges_cover_every_nonzero_tap(name, order, rows):
    """Each order's kernel runs its own slice height (VH_ROWS, HV_ROWS):
    each slice's range holds every nonzero V tap of its rows, 32-aligned."""
    ops = _split_ops(name, order)
    nz = ((ops.tvh != 0) | (ops.tvl != 0)).numpy()  # [Bv, Tv, Wv]
    bv, tv, wv = nz.shape
    kr = ops.k_range.numpy()
    assert ops.rows == rows and kr.shape == (bv, -(-tv // rows), 2)
    cols = np.arange(wv)
    for s in range(kr.shape[1]):
        used = nz[:, s * rows : (s + 1) * rows].any(axis=1)  # [Bv, Wv]
        inside = (cols >= kr[:, s, :1]) & (cols < kr[:, s, 1:])
        assert not (used & ~inside).any()
    assert (kr % 32 == 0).all()


@pytest.mark.parametrize("name", ["down_c3_u8_f32", "up_vh_c1_f32_f32", "vh_edge_c2_u16_u16"])
def test_plain_version_independent_of_row_tile(name):
    """The plain version reads the whole tap blocks: the vh operands give
    the bits of the same operands with 32-row ranges (the tiling before
    the tensor-core kernel)."""
    sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb = SPLIT_CASES[name]
    ops = _split_ops(name)
    assert ops.order == "vh" and ops.rows == fs.VH_ROWS
    v1, v0 = (ops.tvh != 0).numpy(), (ops.tvl != 0).numpy()
    ops32 = dataclasses.replace(
        ops, rows=32, k_range=torch.from_numpy(_k_ranges(v1, v0, 32))
    )
    x = torch.from_numpy(split_source(name, sh, sw, c, tin))
    assert torch.equal(
        fs.apply_fused_split_reference(ops, x), fs.apply_fused_split_reference(ops32, x)
    )


def test_vh_edge_cases_reach_their_edges():
    """The vh_edge cases (and their gamma ones) cover what their names
    promise: rows_out not a multiple of the 64-row slice, nonzero V-tap
    ranges and lane windows that end inside a 16-deep MMA step, C = 2,
    trunc_bits=4, a downsize by more than 4 and lanes_in not a multiple
    of 4."""
    seen = set()
    for name in [n for n in SPLIT_CASES if n.startswith("vh_edge")]:
        ops = _split_ops(name)
        sw, sh, nw, nh, c, *_, tb = SPLIT_CASES[name]
        nz = ((ops.tvh != 0) | (ops.tvl != 0)).numpy()
        bv, tv, _ = nz.shape
        spans = [
            np.flatnonzero(nz[b, s : s + 64].any(axis=0))
            for b in range(bv) for s in range(0, tv, 64)
        ]
        hnz = ((ops.thh != 0) | (ops.thl != 0)).any(dim=3).numpy()
        ends = [np.flatnonzero(w)[-1] + 1 for w in hnz.reshape(-1, hnz.shape[2]) if w.any()]
        seen |= {
            *(["rows_out"] if ops.rows_out % 64 else []),
            *(["v_range"] if any(r.size and (r[-1] + 1 - r[0]) % 16 for r in spans) else []),
            *(["lane_end"] if any(e % 16 for e in ends) else []),
            *(["c2"] if c == 2 else []),
            *(["tb4"] if tb == 4 and ops.out_dtype == torch.uint16 else []),
            *(["down_gt4"] if sw > 4 * nw and sh > 4 * nh else []),
            *(["lanes_in"] if ops.lanes_in % 4 else []),
        }
    assert seen == {"rows_out", "v_range", "lane_end", "c2", "tb4", "down_gt4", "lanes_in"}


def _hv_edge_ops(name, device="cpu"):
    """(plan, operands) of a SPLIT_HV_EDGE_CASES case."""
    (sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb, rm, scale, g,
     alpha) = SPLIT_HV_EDGE_CASES[name]
    ib = IN_BYTES[tin]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout],
                             use_srgb_gamma=g, alpha_index=alpha)
    return plan, fs.prepare_fused_split(
        block_banded(plan.v.op, in_bytes=ib),
        lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib),
        order, mv, mh, device, out_dtype=_TORCH[tout],
        out_max=255.0 if tout == "u8" else 65535.0, trunc_bits=tb,
        **epi_kwargs(plan, rm, scale, g, alpha),
    )


@pytest.mark.parametrize("name", list(SPLIT_HV_EDGE_CASES))
def test_hv_edge_plain_matches_pallas(name):
    """The hv edge cases' plain version against the JAX package's
    interpret-mode kernel, within the split gate."""
    (sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb, rm, scale, g,
     alpha) = SPLIT_HV_EDGE_CASES[name]
    out_max = 255.0 if tout == "u8" else 65535.0
    x = split_source(name, sh, sw, c, tin)
    ib = IN_BYTES[tin]
    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout],
                                  use_srgb_gamma=g, alpha_index=alpha)
    jvop = jax_block_banded(jplan.v.op, in_bytes=ib)
    jlop = jax_lane_block_banded(jplan.h.op, c, tile=tile, in_bytes=ib)
    ref = apply_fused_pallas(
        jvop, jlop, jnp.asarray(x), mv, mh,
        out_dtype=jnp.dtype(NP_TYPES[tout]), out_max=out_max, trunc_bits=tb,
        order=order, interpret=True, **epi_kwargs(jplan, rm, scale, g, alpha),
    )
    ref = np.asarray(ref)[:nh, : nw * c]
    _, ops = _hv_edge_ops(name)
    got = fs.apply_fused_split(ops, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64)).max()
    ref_max = float(np.abs(ref.astype(np.float64)).max())
    assert diff <= split_tol(tout, ref_max, out_max, tb, scale, g) + 1e-9, diff


def test_hv_edge_cases_reach_their_edges():
    """The hv edge cases cover what their names promise, at the hv
    kernel's slice height: rows_out not a multiple of it, nonzero V-tap
    ranges and lane windows that end inside a 16-deep MMA step, C = 2, 5
    and 8, lanes_in not a multiple of 4, a slice's V-tap range of four or
    more 32-row groups, gamma with the alpha lane first and last, and u16
    output with trunc_bits=4."""
    rows, seen = fs.HV_ROWS, set()
    for name, case in SPLIT_HV_EDGE_CASES.items():
        _, ops = _hv_edge_ops(name)
        c, tb, g, alpha = case[4], case[11], case[14], case[15]
        assert ops.order == "hv" and ops.rows == rows
        nz = ((ops.tvh != 0) | (ops.tvl != 0)).numpy()
        bv, tv, _ = nz.shape
        spans = [
            np.flatnonzero(nz[b, s : s + rows].any(axis=0))
            for b in range(bv) for s in range(0, tv, rows)
        ]
        hnz = ((ops.thh != 0) | (ops.thl != 0)).any(dim=3).numpy()
        ends = [np.flatnonzero(w)[-1] + 1 for w in hnz.reshape(-1, hnz.shape[2]) if w.any()]
        kr = ops.k_range.numpy()
        seen |= {
            *(["rows_out"] if ops.rows_out % rows else []),
            *(["v_range"] if any(r.size and (r[-1] + 1) % 16 for r in spans) else []),
            *(["lane_end"] if any(e % 16 for e in ends) else []),
            *([f"c{c}"] if c in (2, 5, 8) else []),
            *(["lanes_in"] if ops.lanes_in % 4 else []),
            *(["tall"] if (kr[..., 1] - kr[..., 0]).max() >= 4 * 32 else []),
            *([f"gamma_a{alpha}"] if g else []),
            *(["tb4"] if tb == 4 and ops.out_dtype == torch.uint16 else []),
        }
    assert seen == {"rows_out", "v_range", "lane_end", "c2", "c5", "c8", "lanes_in",
                    "tall", "gamma_a0", "gamma_a3", "tb4"}


def test_cpu_tensor_takes_plain_version():
    plan = build_resize_plan(40, 30, 20, 15, 3, np.uint16, np.uint16)
    ops = fs.prepare_fused_split(
        block_banded(plan.v.op, in_bytes=2),
        lane_block_banded(plan.h.op, 3, in_bytes=2),
        "vh", "split3", "split3", "cpu", out_dtype=torch.uint16,
        out_max=65535.0,
    )
    x = torch.randint(0, 65536, (30, 120), dtype=torch.int32).to(torch.uint16)
    before = dict(fs.launches)
    out = fs.apply_fused_split(ops, x)
    assert fs.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, fs.apply_fused_split_reference(ops, x))


def test_wrapper_never_falls_back_off_the_cpu():
    plan = build_resize_plan(40, 30, 20, 15, 3, np.uint8, np.uint8)
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, 3)
    x = torch.zeros((30, 120), dtype=torch.uint8)
    ops = fs.prepare_fused_split(vop, lop, "vh", "split2", "split3", "meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fs.apply_fused_split(ops, x)
    ops = fs.prepare_fused_split(vop, lop, "vh", "split2", "split3", "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        fs.apply_fused_split(ops, x.to("meta"))


def test_prepare_rejects_unknown_modes():
    plan = build_resize_plan(40, 30, 20, 15, 3, np.uint8, np.uint8)
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, 3)
    with pytest.raises(ValueError, match="split2/split3"):
        fs.prepare_fused_split(vop, lop, "vh", "int8", "int8", "cpu")
