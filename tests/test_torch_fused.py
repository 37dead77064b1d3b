"""K1 int8 mode in the port: the plain PyTorch version is bit-equal to the
JAX package's Pallas kernel (interpret mode, on the CPU), on the port's
own blocked operators and on the JAX package's plans carried across by
``avir_tpu_torch.convert``.  The kernel itself is held against the plain
version on the card only (tests/test_torch_cuda.py)."""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.lanes import lane_block_banded as jax_lane_block_banded
from avir_tpu.ops.pallas.fused_kernel import apply_fused_pallas
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from torch_cases import FUSED_CASES as CASES
from torch_cases import (
    BANDED_CASES,
    HV_RUN_CASES,
    IN_BYTES,
    INT8_EPI_CASES,
    LANES_CASES,
    NP_TYPES,
    PLANAR_CASES,
    RING_CASES,
    SPLIT_CASES,
    VH_RING_CASES,
    epi_kwargs,
)

from avir_tpu_torch.convert import resize_plan_from_numpy
from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import banded_kernel as bk
from avir_tpu_torch.ops.cuda import build
from avir_tpu_torch.ops.cuda import fused_kernel as fk
from avir_tpu_torch.ops.cuda import fused_ring as fr
from avir_tpu_torch.ops.cuda import fused_split as fs
from avir_tpu_torch.ops.cuda import gamma_prologue as gp
from avir_tpu_torch.ops.cuda import lanes_kernel as lk
from avir_tpu_torch.ops.cuda import planar as pk
from avir_tpu_torch.ops.cuda import planar2 as p2
from avir_tpu_torch.ops.cuda import wavefront as wf
from avir_tpu_torch.ops.lanes import lane_block_banded, narrow_lop
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _order(sw, sh, nw, nh):
    return "vh" if nw * nh <= sw * sh else "hv"


def _jax_fused(plan, x, c, order, tile):
    vop = jax_block_banded(plan.v.op)
    lop = jax_lane_block_banded(plan.h.op, c, tile=tile)
    out = apply_fused_pallas(
        vop, lop, jnp.asarray(x), "int8", "int8", out_dtype=jnp.uint8,
        out_max=255.0, order=order, interpret=True,
    )
    return np.asarray(out)[: vop.n_out, : lop.n_out * c], lop


def _port_plain(plan, x, c, order, tile):
    vop = block_banded(plan.v.op)
    lop = lane_block_banded(plan.h.op, c, tile=tile)
    ops = fk.prepare_fused_int8(vop, lop, order, "cpu")
    return fk.apply_fused_int8(ops, torch.from_numpy(x)).numpy(), lop


def _plan_fields(plan):
    fields = {
        f.name: getattr(plan, f.name)
        for f in dataclasses.fields(plan) if f.name not in ("h", "v")
    }
    for axis in ("h", "v"):
        ap = getattr(plan, axis)
        fields[axis] = (
            ap.op.n_in, ap.op.n_out, np.asarray(ap.op.starts),
            np.asarray(ap.op.taps), ap.build_mode, ap.k, ap.o,
        )
    return fields


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_int8(name):
    sw, sh, nw, nh, c, tile = CASES[name]
    order = _order(sw, sh, nw, nh)
    x = np.random.default_rng(sum(map(ord, name))).integers(
        0, 256, (sh, sw * c), dtype=np.uint8
    )
    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    ref, jlop = _jax_fused(jplan, x, c, order, tile)

    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    got, lop = _port_plain(plan, x, c, order, tile)
    assert (lop.chunk_rel is None) == (jlop.chunk_rel is None)
    assert got.shape == ref.shape == (nh, nw * c)
    np.testing.assert_array_equal(got, ref)

    # The JAX package's own plan, carried across.
    conv, _ = _port_plain(
        resize_plan_from_numpy(_plan_fields(jplan)), x, c, order, tile
    )
    np.testing.assert_array_equal(conv, ref)


@pytest.mark.parametrize("order", ["vh", "hv"])
def test_plain_matches_pallas_other_order(order):
    """Either pass order runs either resize direction."""
    sw, sh, nw, nh, c = 96, 80, 70, 101, 3
    x = np.random.default_rng(5).integers(
        0, 256, (sh, sw * c), dtype=np.uint8
    )
    ref, _ = _jax_fused(
        jax_build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8),
        x, c, order, None,
    )
    got, _ = _port_plain(
        build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8),
        x, c, order, None,
    )
    np.testing.assert_array_equal(got, ref)


def test_cpu_tensor_takes_plain_version():
    plan = build_resize_plan(40, 30, 20, 15, 3, np.uint8, np.uint8)
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, 3), "vh", "cpu"
    )
    x = torch.randint(0, 256, (30, 120), dtype=torch.uint8)
    before = dict(fk.launches)
    out = fk.apply_fused_int8(ops, x)
    assert fk.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, fk.apply_fused_int8_reference(ops, x))


def test_wrapper_never_falls_back_off_the_cpu():
    """Operands off the CPU with a CPU image (or the reverse) raise: only
    a CPU image with CPU operands takes the plain version."""
    plan = build_resize_plan(40, 30, 20, 15, 3, np.uint8, np.uint8)
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, 3)
    x = torch.zeros((30, 120), dtype=torch.uint8)
    ops = fk.prepare_fused_int8(vop, lop, "vh", "meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fk.apply_fused_int8(ops, x)
    ops = fk.prepare_fused_int8(vop, lop, "vh", "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        fk.apply_fused_int8(ops, x.to("meta"))


def test_pack4_layout():
    q = np.arange(-64, 64, dtype=np.int8).reshape(1, 8, 16)
    q = np.repeat(q, 8, axis=2)  # [1, 8, 128]
    p = fk._pack4(q)
    assert p.shape == (1, 2, 128)
    for k in range(8):
        got = (p[0, k // 4] >> (8 * (k % 4))) & 0xFF
        np.testing.assert_array_equal(got, q[0, k].view(np.uint8))


# ---------------------------------------------------------------------------
# Operands of the tensor-core kernels (without gamma, and with the
# in-kernel gamma: INT8_EPI_CASES' gamma cases)
# ---------------------------------------------------------------------------

EDGE = [n for n in CASES if n.startswith("edge")]
GAMMA = [n for n, case in INT8_EPI_CASES.items() if case[9]]
GAMMA_EDGE = [n for n in GAMMA if n.startswith(("gamma_edge", "gamma_odd", "gamma_hv"))
              or n == "gamma_up_c4a0"]


def _ops(name):
    """Operands of a FUSED_CASES case, or (an INT8_EPI_CASES gamma case)
    of the in-kernel gamma route."""
    if name in INT8_EPI_CASES:
        sw, sh, nw, nh, c, tile, order, rm, scale, g, alpha = INT8_EPI_CASES[name]
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8,
                                 use_srgb_gamma=g, alpha_index=alpha)
        return fk.prepare_fused_int8(
            block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile),
            order, "cpu", **epi_kwargs(plan, rm, scale, g, alpha),
        )
    sw, sh, nw, nh, c, tile = CASES[name]
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    return fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile),
        _order(sw, sh, nw, nh), "cpu",
    )


@pytest.mark.parametrize("name", ["down_c3", "up_c4_tc", "edge_down5_c3", "edge_up128_c3"])
def test_h_range_covers_every_nonzero_tap(name):
    """Each chunk's h_range holds every nonzero lane tap, 32-aligned."""
    ops = _ops(name)
    nz = ((ops.h1 != 0) | (ops.h0 != 0)).any(dim=3).numpy()  # [Bh, n_ch, win_c]
    rng = ops.h_range.numpy()
    win_c = nz.shape[2]
    lanes = np.arange(win_c)
    inside = (lanes >= rng[..., :1]) & (lanes < rng[..., 1:])
    assert not (nz & ~inside).any()
    assert (rng[..., 0] % 32 == 0).all()
    assert ((rng[..., 1] % 32 == 0) | (rng[..., 1] == win_c)).all()


@pytest.mark.parametrize("rows", [32, 64, 128])
@pytest.mark.parametrize("name", ["down_c3", "edge_rows_c3", "edge_up_c2", "edge_up128_c3",
                                  "gamma_edge_rows_down_c3", "gamma_edge_rows_up_c3",
                                  "gamma_up_c4a0"])
def test_slice_range_covers_every_nonzero_tap(name, rows):
    """Each R-row slice's range holds every nonzero V tap of its rows,
    32-aligned; the 32-row k_range (which K6 and the hv kernel's second
    pass read) is the same at every R, with gamma (the in-kernel route) as
    without.  The vh kernel takes 32-row slices only (at_rows refuses the
    others), so there the ranges are _k_ranges': its slice_range is the
    k_range tensor itself, one array on the device."""
    ops = _ops(name)
    v1, v0 = ops.v1.numpy(), ops.v0.numpy()
    nz = (v1 != 0) | (v0 != 0)  # [Bv, Tv, Wv]
    bv, tv, wv = nz.shape
    if ops.order == "vh" and rows != 32:
        with pytest.raises(ValueError, match=f"no {rows}-row slices"):
            fk.at_rows(ops, rows)
        sr = fk._k_ranges(v1, v0, rows)
    else:
        ops = fk.at_rows(ops, rows)
        sr = ops.slice_range.numpy()
        assert ops.rows == rows
    assert sr.shape == (bv, -(-tv // rows), 2)
    cols = np.arange(wv)
    for s in range(sr.shape[1]):
        used = nz[:, s * rows : (s + 1) * rows].any(axis=1)
        inside = (cols >= sr[:, s, :1]) & (cols < sr[:, s, 1:])
        assert not (used & ~inside).any()
    assert (sr % 32 == 0).all()
    np.testing.assert_array_equal(ops.k_range.numpy(), fk._k_ranges(v1, v0, 32))
    assert ops.k_range.shape[1] == -(-tv // 32)
    if ops.order == "vh":
        assert ops.slice_range is ops.k_range
    elif rows == 32:
        np.testing.assert_array_equal(ops.slice_range.numpy(), ops.k_range.numpy())


def test_k_range_of_the_gamma_kernels_and_k6_unchanged():
    """The in-kernel gamma operands carry the tensor-core kernels' tiling
    (slice_range, h_range, kwin, and for hv the transposed lane taps), and
    at_rows takes every height their order runs; K6, which builds its
    operands on the vh ones, still finds 32-row k_range slices over the
    dense taps and the packed lane taps it reads."""
    plan = build_resize_plan(200, 150, 80, 60, 3, np.uint8, np.uint8, use_srgb_gamma=True)
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, 3)
    for order in ("vh", "hv"):
        ops = fk.prepare_fused_int8(vop, lop, order, "cpu", gamma=True)
        kr = ops.k_range.numpy()
        nz = (ops.v1.numpy() != 0) | (ops.v0.numpy() != 0)
        bv, tv, wv = nz.shape
        assert kr.shape == (bv, -(-tv // 32), 2)
        for b in range(bv):
            for s in range(kr.shape[1]):
                used = np.flatnonzero(nz[b, 32 * s : 32 * s + 32].any(axis=0))
                if used.size:
                    assert kr[b, s, 0] == used[0] // 32 * 32
                    assert kr[b, s, 1] == min(-(-(used[-1] + 1) // 32) * 32, wv)
                else:
                    assert tuple(kr[b, s]) == (0, 0)
        v1, v0 = ops.v1.numpy(), ops.v0.numpy()
        np.testing.assert_array_equal(
            ops.slice_range.numpy(), fk._k_ranges(v1, v0, ops.rows))
        np.testing.assert_array_equal(
            ops.h_range.numpy(), fk.h_ranges(ops.h1.numpy(), ops.h0.numpy()))
        assert ops.kwin == fk._slice_fields(v1, v0, ops.rows)[1]
        for rows in (32,) if order == "vh" else (32, 64, 128):
            assert fk.at_rows(ops, rows).rows == rows
        if order == "vh":
            assert ops.rows == 32 and ops.h1t is None and ops.h0t is None
            np.testing.assert_array_equal(ops.h1p.numpy(), fk._pack4(ops.h1.numpy()))
            np.testing.assert_array_equal(ops.h0p.numpy(), fk._pack4(ops.h0.numpy()))
            # K6's own K1 operands (RING_CASES' uniform_c3): the same
            # 32-row k_range and packed lane taps.
            rplan = build_resize_plan(512, 1024, 128, 256, 3, np.uint8, np.uint8,
                                      use_srgb_gamma=True)
            k1 = fr.prepare_fused_ring(
                block_banded(rplan.v.op, tile=64, uniform=True),
                lane_block_banded(rplan.h.op, 3), "cpu",
                in_gamma_mult=rplan.in_gamma_mult, out_gamma_mult=rplan.out_gamma_mult,
            ).k1
            np.testing.assert_array_equal(
                k1.k_range.numpy(), fk._k_ranges(k1.v1.numpy(), k1.v0.numpy(), 32))
            np.testing.assert_array_equal(k1.h1p.numpy(), fk._pack4(k1.h1.numpy()))
            np.testing.assert_array_equal(k1.h0p.numpy(), fk._pack4(k1.h0.numpy()))
        else:
            assert torch.equal(ops.h1t, ops.h1.transpose(2, 3))
            assert torch.equal(ops.h0t, ops.h0.transpose(2, 3))
            assert ops.h1p is None and ops.h0p is None  # read by no hv kernel


def test_hv_lane_taps_transposed():
    ops = _ops("edge_up128_c3")
    assert ops.order == "hv"
    assert torch.equal(ops.h1t, ops.h1.transpose(2, 3))
    assert torch.equal(ops.h0t, ops.h0.transpose(2, 3))
    assert ops.h1t.is_contiguous() and ops.lane_align == 16
    assert ops.h1p is None and ops.h0p is None  # read by no hv kernel without gamma


def _count_macs(ops, first):
    """The s8 MACs of ``ops``' kernel, block by block and step by step, with
    ``first`` limb products in the first pass."""
    sr, kr, hr = (t.numpy().astype(np.int64) for t in (ops.slice_range, ops.k_range, ops.h_range))
    rows, n_s32 = ops.rows, kr.shape[1]
    want = 0
    for b in range(sr.shape[0]):
        for s in range(sr.shape[1]):
            kw = sr[b, s, 1] - sr[b, s, 0]
            for hw in (hr[..., 1] - hr[..., 0]).ravel():
                if kw <= 0 or hw <= 0:
                    continue
                if ops.order == "vh":
                    want += first * rows * kw * hw + 3 * rows * hw * 128
                else:
                    want += first * kw * 128 * hw
                    for sub in range(rows // 32):
                        s32 = s * rows // 32 + sub
                        if s32 < n_s32:
                            want += 3 * 32 * (kr[b, s32, 1] - kr[b, s32, 0]) * 128
    return want


@pytest.mark.parametrize("name", ["down_c3", "up_c4", "edge_down_c2", "edge_up128_c3"])
def test_issued_macs_counts_every_block(name):
    """issued_macs against a count over the kernel's blocks and steps."""
    ops = _ops(name)
    sr, kr, hr = (ops.slice_range.numpy(), ops.k_range.numpy(), ops.h_range.numpy())
    assert fk.issued_macs(ops.order, ops.rows, sr, kr, hr) == _count_macs(ops, 2)


@pytest.mark.parametrize("name", ["gamma_down_c4a", "gamma_up_c4a", "gamma_edge_rows_up_c3",
                                  "gamma_hv_windows_c1"])
def test_issued_macs_counts_three_first_pass_products(name):
    """With gamma the first pass makes three limb products (the in-kernel
    route as the limb-plane one): issued_macs with first=3 against the
    count over the kernel's blocks and steps, at every height at_rows
    takes."""
    base = _ops(name)
    assert base.epi.gamma and not base.gamma_pre
    for rows in (32,) if base.order == "vh" else (32, 64, 128):
        try:
            ops = fk.at_rows(base, rows)
        except ValueError:
            assert base.order == "hv" and rows > 32  # windows: 32 rows only
            continue
        sr, kr, hr = (ops.slice_range.numpy(), ops.k_range.numpy(), ops.h_range.numpy())
        got = fk.issued_macs(ops.order, rows, sr, kr, hr, first=3)
        assert got == _count_macs(ops, 3) > _count_macs(ops, 2)


def test_gamma_edge_cases_reach_their_edges():
    """The in-kernel gamma edge cases (INT8_EPI_CASES) cover what
    torch_cases.py promises: rows_out off 32, 64 and 128 in both orders,
    an hv at 128-row slices with a ragged last slice, lanes_in odd in both
    orders, C = 4 with the alpha lane first in hv, and an hv in windows."""
    seen = set()
    for name in GAMMA_EDGE:
        ops = _ops(name)
        c = INT8_EPI_CASES[name][4]
        span = (ops.slice_range.numpy()[..., 1] - ops.slice_range.numpy()[..., 0]).max()
        seen |= {
            *([f"rows_out_{ops.order}"] if all(ops.rows_out % r for r in (32, 64, 128)) else []),
            *(["hv128_ragged"] if ops.order == "hv" and ops.rows == 128
              and ops.rows_out % 128 and ops.v1.shape[1] >= 128 else []),
            *([f"odd_lanes_in_{ops.order}"] if ops.lanes_in % 2 else []),
            *(["hv_alpha0"] if ops.order == "hv" and c == 4 and ops.epi.alpha_lane == 0 else []),
            *(["hv_windows"] if ops.order == "hv" and span > fk.KWIN_MAX else []),
        }
    assert seen == {
        "rows_out_vh", "rows_out_hv", "hv128_ragged", "odd_lanes_in_vh",
        "odd_lanes_in_hv", "hv_alpha0", "hv_windows",
    }


def _vh_steps(kw: int, hw: int) -> int:
    """Steps of a vh block (fused_int8.cu) whose slice range is kw rows
    and whose chunk's lane range is hw lanes: per 128-lane segment, one
    step per 64 slice rows and one per 64 of its lanes."""
    return sum(-(-kw // 64) + -(-min(128, hw - s) // 64) for s in range(0, hw, 128))


@pytest.mark.parametrize("name", list(VH_RING_CASES))
def test_vh_ring_cases_reach_their_edges(name):
    """Each of torch_cases.VH_RING_CASES has the edge of the vh kernel's
    ring that its name promises, and all but the odd-lanes case stage the
    image by cp.async (rows and windows 16-byte aligned)."""
    sw, sh, nw, nh, c, tile = VH_RING_CASES[name]
    assert _order(sw, sh, nw, nh) == "vh"
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile), "vh", "cpu",
    )
    sr = ops.slice_range.numpy().reshape(-1, 2)
    hr = ops.h_range.numpy().reshape(-1, 2)
    kw, hw = sr[:, 1] - sr[:, 0], hr[:, 1] - hr[:, 0]
    steps = [_vh_steps(k, h) for k in kw[kw > 0] for h in hw[hw > 0]]
    vec16 = ops.lanes_in % 16 == 0 and ops.lane_align == 16
    assert vec16 == (name != "ring_odd_lanes")
    edge = {
        "ring_under_one_step": (0 < kw).all() and (kw < 64).all() and max(steps) < fk.VH_STAGES,
        "ring_kw_off64": (kw % 64 == 32).any() and max(steps) > 4 * fk.VH_STAGES,
        "ring_seg32_seg96": (hw % 128 == 32).any() and (hw % 128 == 96).any(),
        "ring_no_taps": (kw == 0).any() and (hw == 0).any(),
        "ring_odd_lanes": ops.lanes_in % 2 == 1 and max(steps) > fk.VH_STAGES,
    }[name]
    assert edge


def test_k1_phases_marks_the_vh_kernel():
    """k1_phases.py's timed copy applies to the shipped fused_int8.cu: each
    phase mark of the vh kernel's ring lands once, with and without
    ``--stages``, and the copy's ring depth is the one asked for."""
    from pathlib import Path

    import k1_phases

    src = (Path(fk.__file__).with_name("csrc") / "fused_int8.cu").read_text()
    for stages in (None, 3):
        text, (loop, phases, waits) = k1_phases._timed_source(src, stages)
        assert loop == "ring" and set(waits) < set(phases)
        assert all(text.count(f"MARK({k});") == 1 for k in range(len(phases)))
        assert text.count("STEP(i < nv);") == 1
        assert ("kStages = IN == kU8 ? 3 : 4;" in text) == (stages == 3)


def test_k1_phases_marks_the_hv_kernel():
    """k1_phases.py's ``--order hv`` copy applies to the shipped
    fused_int8.cu (the block that walks runs of tiles): each phase mark
    lands once and both step kinds are counted, and the vh kernel is left
    unmarked."""
    from pathlib import Path

    import k1_phases

    src = (Path(fk.__file__).with_name("csrc") / "fused_int8.cu").read_text()
    text, (loop, phases, waits) = k1_phases._timed_source(src, None, "hv")
    assert loop == "runs" and set(waits) < set(phases)
    assert all(text.count(f"MARK({k});") == 1 for k in range(len(phases)))
    assert text.count("STEP(true);") == text.count("STEP(false);") == 1
    assert "fused_int8_hv_mma(const Args a) {\n  unsigned long long t0_" in text
    assert "fused_int8_vh_mma(const Args a) {\n  unsigned long long t0_" not in text
    with pytest.raises(RuntimeError, match="vh ring"):
        k1_phases._timed_source(src, 3, "hv")


def test_vh_cases_cover_every_staging_path():
    """The vh card cases (FUSED_CASES' downsizes and VH_RING_CASES) stage
    the image on each of the vh kernel's three paths: 16-byte cp.async,
    4-byte cp.async, and byte loads (rows or windows off 4 bytes)."""
    paths = set()
    for sw, sh, nw, nh, c, tile in [*CASES.values(), *VH_RING_CASES.values()]:
        if _order(sw, sh, nw, nh) != "vh":
            continue
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
        ops = fk.prepare_fused_int8(
            block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile), "vh", "cpu",
        )
        align = min(ops.lane_align, ops.lanes_in & -ops.lanes_in)
        paths.add("cp16" if align >= 16 else "cp4" if align >= 4 else "bytes")
    assert paths == {"cp16", "cp4", "bytes"}


@pytest.mark.parametrize("size", [(1920, 1080, 3840, 2160), (1000, 700, 640, 480)])
def test_gamma_slice_rule_keeps_two_blocks_an_sm(size):
    """u8 RGB with sRGB gamma on the in-kernel route: slice_rows with the
    mode's shared memory (two planes of image tiles and the linearization
    table) keeps two blocks on an H100 SM at 1920x1080 -> 3840x2160 (hv,
    128-row slices, as the limb-plane route) and 1000x700 -> 640x480 (vh,
    32 rows: the downsize K6 cannot take), where the vh kernel's ring fits
    two blocks an SM in every input mode."""
    from avir_tpu_torch.models.runtime import make_avir_executor

    sw, sh, nw, nh = size
    plan = build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8, use_srgb_gamma=True)
    ops = make_avir_executor(plan, device="cpu").ops
    assert ops.launch_key == f"fused_int8_{ops.order}_gamma"
    v1, v0 = ops.v1.numpy(), ops.v0.numpy()
    n_chunks = ops.h_range.shape[0] * ops.h_range.shape[1]
    rows = fk.slice_rows(ops.order, v1, v0, n_chunks, H100_SMS, planes=2, table=True)
    limit = fk.two_blocks_smem(fk.H100_SM_SMEM)
    if ops.order == "hv":
        assert rows == 128 == fk.slice_rows(ops.order, v1, v0, n_chunks, H100_SMS, planes=2)
        kwin = fk.at_rows(ops, rows).kwin
        assert fk.hv_smem_bytes(kwin, 2) < fk.hv_smem_bytes(kwin, 2, table=True) <= limit
    else:
        assert rows == ops.rows == 32 and size == (1000, 700, 640, 480)
        # Every input mode's ring (u8, K5's limb planes, in-kernel gamma)
        # within two blocks an SM; gamma adds the table and a plane of B
        # words to the u8 kernel's ring.
        for planes, table in ((1, False), (2, False), (2, True)):
            assert fk.vh_smem_bytes(planes, table) <= limit
        assert fk.vh_smem_bytes(2, table=True) == (
            fk.vh_smem_bytes() + fk.GAMMA_TABLE_BYTES + 16 * 136 * 4
        )
        assert fk.vh_smem_bytes(2) > fk.vh_smem_bytes(2, table=True)


# The H100 SXM's SMs: the card on which PERF.md measured every slice height.
H100_SMS = 132


def _rule(ops, sms):
    n_chunks = ops.h_range.shape[0] * ops.h_range.shape[1]
    return fk.slice_rows(ops.order, ops.v1.numpy(), ops.v0.numpy(), n_chunks, sms)


def test_slice_rule_picks_recorded_heights():
    """slice_rows at the four K1 int8 main-path cells on an H100 (PERF.md
    §6): 32-row slices at the two 8K downsizes, 128 at 1080p -> 4K, and 64
    at 640x480 -> 1024x768, where 128 rows would leave fewer than two
    blocks per SM.  CPU operands take the tallest viable height."""
    from avir_tpu_torch.models.runtime import make_avir_executor, make_lancir_executor
    from avir_tpu_torch.plan.lancir_plan import build_lancir_plan

    cells = {
        "8k_to_1080p": (make_avir_executor, build_resize_plan, (7680, 4320, 1920, 1080), 32),
        "lancir_8k_to_1080p": (make_lancir_executor, build_lancir_plan, (7680, 4320, 1920, 1080), 32),
        "1080p_to_4k": (make_avir_executor, build_resize_plan, (1920, 1080, 3840, 2160), 128),
        "640x480_to_1024x768": (make_avir_executor, build_resize_plan, (640, 480, 1024, 768), 64),
    }
    for name, (make, build, size, rows) in cells.items():
        fn = make(build(*size, 3, np.uint8, np.uint8), device="cpu")
        assert fn.route == "int8", name
        assert _rule(fn.ops, H100_SMS) == rows, name
        assert fn.ops.rows == (128 if fn.ops.order == "hv" else 32), name
    bh, n_ch = fn.ops.h_range.shape[:2]
    assert bh * n_ch * fn.ops.v1.shape[0] * -(-fn.ops.v1.shape[1] // 128) < 2 * H100_SMS


def test_slice_rule_takes_the_tallest_viable_height_and_caps_hv_windows():
    """vh runs 32 rows; hv the tallest height that fits the V block, keeps
    two blocks per SM and whose ranges fit the intermediate; an hv whose
    taller slices exceed the intermediate's rows runs at 32 rows in
    windows (at_rows refuses the taller ones)."""
    for name in ("down_c3", "up_c3", "edge_rows_c3", "edge_up128_c3"):
        ops = _ops(name)
        v1, v0 = ops.v1.numpy(), ops.v0.numpy()
        bv, tv, _ = v1.shape
        n_chunks = ops.h_range.shape[0] * ops.h_range.shape[1]
        for sms in (0, 1, 4, H100_SMS):
            got = _rule(ops, sms)
            if ops.order == "vh":
                assert got == 32, name
                continue
            for rows in (64, 128):
                sr = fk._k_ranges(v1, v0, rows)
                viable = (
                    rows <= -(-tv // 32) * 32
                    and n_chunks * bv * sr.shape[1] >= 2 * sms
                    and (sr[..., 1] - sr[..., 0]).max() <= fk.KWIN_MAX
                )
                if rows >= got:
                    assert viable == (rows == got), (name, sms, rows)
    ops = _ops("edge_hv_windows_c1")
    span = (ops.slice_range.numpy()[..., 1] - ops.slice_range.numpy()[..., 0]).max()
    assert ops.order == "hv" and ops.rows == 32 and span > fk.KWIN_MAX
    assert ops.kwin == fk.KWIN_MAX
    with pytest.raises(ValueError, match="exceed"):
        fk.at_rows(ops, 64)


def test_edge_cases_reach_their_edges():
    """The edge_* cases cover what their names promise: rows_out not a
    multiple of any slice height, nonzero lane ranges that end inside a
    32-deep MMA step, C = 2 in both orders, a downsize by more than 4, odd
    lanes_in (rows not 16-byte aligned), an hv at 128-row slices with a
    ragged last slice, and an hv in several windows."""
    seen = set()
    for name in EDGE:
        sw, sh, nw, nh, c, _ = CASES[name]
        ops = _ops(name)
        hnz = ((ops.h1 != 0) | (ops.h0 != 0)).any(dim=3).numpy()
        ends = [np.flatnonzero(w)[-1] + 1 for w in hnz.reshape(-1, hnz.shape[2]) if w.any()]
        span = (ops.slice_range.numpy()[..., 1] - ops.slice_range.numpy()[..., 0]).max()
        seen |= {
            *(["rows_out"] if all(ops.rows_out % r for r in (32, 64, 128)) else []),
            *(["lane_end"] if any(e % 32 for e in ends) else []),
            *([f"c2_{ops.order}"] if c == 2 else []),
            *(["down_gt4"] if sw > 4 * nw and sh > 4 * nh else []),
            *(["odd_lanes_in"] if ops.lanes_in % 2 else []),
            *(["hv128_ragged"] if ops.order == "hv" and ops.rows_out % 128
              and ops.v1.shape[1] >= 128 and span <= fk.KWIN_MAX else []),
            *(["hv_windows"] if ops.order == "hv" and span > fk.KWIN_MAX else []),
        }
    assert seen == {
        "rows_out", "lane_end", "c2_vh", "c2_hv", "down_gt4", "odd_lanes_in",
        "hv128_ragged", "hv_windows",
    }


# hv_blocks' choice on an H100 (132 SMs, 233,472 bytes of shared memory an
# SM): (tiles, kwin, SMs, planes, table) -> blocks.  The 1080p -> 4K video
# shape at 128-row slices (1,620 tiles, kwin 128) in each input mode: 264
# blocks (two an SM) walk runs of six or seven tiles; at 64 and 32 rows
# more tiles share as many blocks; fewer tiles than the card holds at once
# run one a block; a window of 256 rows lets one block an SM (132 blocks);
# the CPU (0 SMs) takes one block a tile.
HV_BLOCK_CHOICES = {
    "video_u8": ((1620, 128, 132, 1, False), 264),
    "video_planes": ((1620, 128, 132, 2, False), 264),
    "video_gamma": ((1620, 128, 132, 2, True), 264),
    "video_r64": ((3240, 96, 132, 1, False), 264),
    "video_r32_gamma": ((6480, 64, 132, 2, True), 264),
    "one_wave": ((144, 128, 132, 1, False), 144),
    "exactly_resident": ((264, 128, 132, 1, False), 264),
    "one_over": ((265, 128, 132, 1, False), 264),
    "windows_u8": ((432, 256, 132, 1, False), 132),
    "windows_gamma": ((432, 256, 132, 2, True), 132),
    "windows_fit_the_card": ((100, 256, 132, 1, False), 100),
    "cpu": ((1620, 128, 0, 1, False), 1620),
}


@pytest.mark.parametrize("name", list(HV_BLOCK_CHOICES))
def test_hv_blocks_fill_the_card_once(name):
    """hv_blocks at the recorded cases, and why: the tiles, or the card's
    resident blocks (two an SM where the kernel's shared memory at kwin lets
    two share one, else one) where there are more tiles, so that no block
    waits for a second wave; all tiles on the CPU."""
    (tiles, kwin, sms, planes, table), want = HV_BLOCK_CHOICES[name]
    assert fk.hv_blocks(tiles, kwin, sms, planes, table) == want
    two = fk.hv_smem_bytes(kwin, planes, table) <= fk.two_blocks_smem(fk.H100_SM_SMEM)
    assert want == (tiles if sms == 0 else min(tiles, (2 if two else 1) * sms))


def _hv_runs(ops):
    """The kernel's runs (csrc: fused_int8_hv_mma): block b walks tiles
    runs[b] .. runs[b + 1] - 1 of the chunk-major order, as (chunk, slice
    index) pairs."""
    n_y = ops.slice_range.shape[0] * ops.slice_range.shape[1]
    r = ops.runs.tolist()
    return [[divmod(f, n_y) for f in range(r[k], r[k + 1])] for k in range(ops.blocks)]


def _hv_tile_cycles(ops):
    """hv_runs' estimate of each tile's cycles, in the chunk-major order."""
    kw = (ops.slice_range[..., 1] - ops.slice_range[..., 0]).numpy().reshape(1, -1)
    hw = (ops.h_range[..., 1] - ops.h_range[..., 0]).numpy().reshape(-1, 1)
    work = (kw > 0) & (hw > 0)
    n_win = np.where(work, -(-kw // ops.kwin), 1)
    return (np.where(work, n_win * (fk.HV_WINDOW_CYCLES + ops.rows // 32 * fk.HV_SUB_CYCLES),
                     ops.rows // 32 * fk.HV_EMPTY_SUB_CYCLES)
            + np.where(work, kw // 32 * -(-hw // 128), 0) * fk.HV_STEP_CYCLES).reshape(-1)


@pytest.fixture
def h100(monkeypatch):
    """Operands prepared as on an H100: 132 SMs (the CPU's own count is 0)."""
    monkeypatch.setattr(fk, "_sm_count", lambda device: H100_SMS)


@pytest.mark.parametrize("gamma,pre", [(False, False), (True, False), (True, True)])
def test_hv_runs_of_the_video_shape(h100, gamma, pre):
    """1080p -> 4K u8 RGB (the video cells' hv, 128-row slices) as on an
    H100: 264 blocks walk runs of five to seven consecutive tiles of the
    chunk-major order, every tile once, cut at equal shares of the tiles'
    estimated cycles (the longest run within 8% of the mean, where runs of
    equal length reach 19%); a run reaches at most one chunk's end (one
    restaging of the lane taps), and the pipeline form is "runs" in every
    input mode; at_rows chooses anew for the other heights."""
    plan = build_resize_plan(1920, 1080, 3840, 2160, 3, np.uint8, np.uint8,
                             use_srgb_gamma=gamma)
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, 3), "hv", "cpu",
        gamma=gamma, gamma_pre=pre,
        in_gamma_mult=plan.in_gamma_mult, out_gamma_mult=plan.out_gamma_mult,
    )
    assert ops.rows == 128 and ops.kwin == 128 and ops.n_tiles == 1620
    assert ops.blocks == 264 and ops.hv_form == "runs"
    runs = _hv_runs(ops)
    assert [f for run in runs for f in run] == [divmod(f, 18) for f in range(1620)]
    assert {len(run) for run in runs} == {5, 6, 7}
    assert max(len({c for c, _ in run}) for run in runs) == 2
    cycles = _hv_tile_cycles(ops)
    shares = np.add.reduceat(cycles, ops.runs.numpy()[:-1])
    equal = np.add.reduceat(cycles, np.arange(264) * 1620 // 264)
    assert shares.max() < 1.08 * shares.mean() and equal.max() > 1.18 * equal.mean()
    for rows in (64, 32):
        o = fk.at_rows(ops, rows)
        assert o.blocks == 264 == fk.hv_blocks(
            o.n_tiles, o.kwin, H100_SMS, 2 if gamma else 1, gamma and not pre)
        assert o.hv_form == "runs" and o.n_tiles == 1620 * 128 // rows
        assert o.runs.tolist() == fk.hv_runs(
            o.slice_range.numpy(), o.h_range.numpy(), o.kwin, rows, 264).tolist()


def test_hv_launch_fields_on_the_cpu_and_for_vh():
    """The CPU's operands (no SMs) take one block a tile; vh operands carry
    no hv launch (no runs, 0 blocks, no form)."""
    for name in ("up_c3", "edge_up128_c3", "edge_hv_windows_c1", "down_c3"):
        ops = _ops(name)
        if ops.order == "vh":
            assert (ops.runs, ops.blocks, ops.hv_form) == (None, 0, None)
            continue
        assert ops.blocks == ops.n_tiles == fk.hv_blocks(ops.n_tiles, ops.kwin, 0)
        assert ops.runs.tolist() == list(range(ops.n_tiles + 1))
        assert ops.hv_form == "one_tile"


@pytest.mark.parametrize("name", list(HV_RUN_CASES))
def test_hv_run_cases_reach_their_edges(h100, name):
    """Each of torch_cases.HV_RUN_CASES takes the pipeline form it records
    at slice_rows' height on an H100 in every input mode, and has the edge
    its name promises: a ragged last slice inside a run, C = 4 with the
    alpha lane (last or first), windows of the intermediate (one block an
    SM), chunks wider than one piece, or fewer tiles than the card holds."""
    sw, sh, nw, nh, c, alpha, form, heights = HV_RUN_CASES[name]
    for gamma, pre in ((False, False), (True, False), (True, True)):
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8,
                                 use_srgb_gamma=gamma, alpha_index=alpha if gamma else -1)
        ops = fk.prepare_fused_int8(
            block_banded(plan.v.op), lane_block_banded(plan.h.op, c), "hv", "cpu",
            **epi_kwargs(plan, "biased", 1.0, gamma, alpha), gamma_pre=pre,
        )
        assert ops.hv_form == form and ops.rows == heights[0]
        for rows in heights:
            assert fk.at_rows(ops, rows).rows == rows
    hw = (ops.h_range[..., 1] - ops.h_range[..., 0]).numpy()
    span = int((ops.slice_range[..., 1] - ops.slice_range[..., 0]).max())
    runs = _hv_runs(ops)
    n_sl, tv = ops.slice_range.shape[1], ops.v1.shape[1]

    def ragged(y):  # the slice's rows end inside it (rows_out or the V block)
        first = y // n_sl * tv + y % n_sl * ops.rows
        return first < ops.rows_out < first + min(ops.rows, tv - y % n_sl * ops.rows)

    edge = {
        "runs_1080p_c3": any(ragged(y) and k < len(run) - 1
                             for run in runs for k, (_, y) in enumerate(run)),
        "runs_c4a3": c == 4 and ops.epi.alpha_lane == 3,
        "runs_c4a0": c == 4 and ops.epi.alpha_lane == 0,
        "runs_windows_c1": span > fk.KWIN_MAX and ops.blocks == H100_SMS,
        "runs_pieces_c3": (hw > 128).any(),
        "one_tile_c3": ops.n_tiles <= 2 * H100_SMS,
    }[name]
    assert edge


@pytest.mark.parametrize("name", list(HV_RUN_CASES))
def test_hv_runs_cover_every_tile_once_in_balance(h100, name):
    """hv_runs on each HV_RUN_CASES shape as on an H100: the runs start at
    tile 0, end at the last and are in order, every block takes one or more
    tiles, and no block's estimated cycles exceed the mean share by more
    than its costliest tile (one tile a block: the tiles themselves)."""
    sw, sh, nw, nh, c, _, form, _ = HV_RUN_CASES[name]
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, c), "hv", "cpu")
    runs = ops.runs.numpy()
    assert runs[0] == 0 and runs[-1] == ops.n_tiles and (np.diff(runs) >= 1).all()
    assert (ops.blocks == ops.n_tiles) == (form == "one_tile")
    cycles = _hv_tile_cycles(ops)
    shares = np.add.reduceat(cycles, runs[:-1])
    assert shares.max() <= shares.mean() + cycles.max()


_TORCH = {"u8": torch.uint8, "u16": torch.uint16, "f32": torch.float32}
_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float, "int*": ctypes.POINTER(ctypes.c_int)}


def _c_params(entry):
    """[(name, ctypes type)] of ``entry.symbol``'s parameters as its source
    in csrc/ defines them."""
    src = (build.CSRC / build.SOURCES[entry.library]).read_text()
    params = re.search(rf'extern "C" int {entry.symbol}\((.*?)\)\s*\{{', src, re.S).group(1)
    return [(name, _C_TYPES[ty]) for ty, name in (p.strip().rsplit(None, 1) for p in params.split(","))]


def _split_ops(name):
    sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb = SPLIT_CASES[name]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout])
    ib = IN_BYTES[tin]
    return fs.prepare_fused_split(
        block_banded(plan.v.op, in_bytes=ib), lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib),
        order, mv, mh, "cpu", out_dtype=_TORCH[tout], out_max=255.0 if tout == "u8" else 65535.0,
        trunc_bits=tb,
    )


def _planar_ops(name, interleaved):
    sw, sh, nw, nh, c, tin, tout, mv, mh, tb, g, alpha = PLANAR_CASES[name]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout],
                             use_srgb_gamma=g, alpha_index=alpha)
    return pk.prepare_planar(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, 1), c, "cpu", mode_v=mv, mode_h=mh,
        out_dtype=_TORCH[tout], out_max=255.0 if tout == "u8" else 65535.0, trunc_bits=tb,
        gamma=g, alpha_plane=alpha, in_gamma_mult=plan.in_gamma_mult,
        out_gamma_mult=plan.out_gamma_mult, interleaved=interleaved,
    )


def _ring_ops(name):
    sw, sh, nw, nh, c, alpha, tile, uniform = RING_CASES[name]
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True,
                             alpha_index=alpha)
    return fr.prepare_fused_ring(
        block_banded(plan.v.op, tile=tile, uniform=uniform), lane_block_banded(plan.h.op, c), "cpu",
        alpha_index=alpha, in_gamma_mult=plan.in_gamma_mult, out_gamma_mult=plan.out_gamma_mult,
    )


def _pass_ops(name, cases, lanes):
    sw, sh, nw, nh, c, tin, mode = cases[name]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
    ib = IN_BYTES[tin]
    if lanes:
        lop = narrow_lop(plan.h.op, lane_block_banded(plan.h.op, c, in_bytes=ib), c, in_bytes=ib)
        return lk.prepare_lanes(lop, mode, "cpu")
    return bk.prepare_banded(block_banded(plan.v.op, in_bytes=ib), mode, "cpu")


# Each C entry point: (its Entry, operands prepared on the CPU at a small
# case of the kernel, or None where it has no operand set).
_ENTRIES = {
    "fused_int8_vh": lambda: (fk.LAUNCH, _ops("down_c3")),
    "fused_int8_hv": lambda: (fk.LAUNCH, _ops("edge_up128_c3")),
    "fused_int8_hv_gamma": lambda: (fk.LAUNCH, _ops("gamma_up_c4a")),
    "fused_ring": lambda: (fr.LAUNCH, _ring_ops("uniform_2x_c4a")),
    "fused_ring_max_clusters": lambda: (fr.MAX_CLUSTERS, None),
    "fused_split_vh": lambda: (fs.LAUNCH, _split_ops("down_c4_u16_u16_tb4")),
    "fused_split_hv": lambda: (fs.LAUNCH, _split_ops("up_c4_u16_u8")),
    "planar": lambda: (pk.LAUNCH, _planar_ops("up_c4_u16_gamma_a3", False)),
    "planar2": lambda: (pk.LAUNCH, _planar_ops("down_c4_u8_gamma_a0_tb2", True)),
    "banded": lambda: (bk.LAUNCH, _pass_ops("up_c3_u16_split3", BANDED_CASES, False)),
    "lanes": lambda: (lk.LAUNCH, _pass_ops("up_c4_u16_split3", LANES_CASES, True)),
    "gamma_prologue": lambda: (gp.LAUNCH, None),
    "wavefront": lambda: (wf.LAUNCH, None),
}


def _held_ptrs(ops) -> set:
    """data_ptr() of every tensor the operands hold (K6's: and its K1
    operands')."""
    held = [getattr(ops, f.name) for f in dataclasses.fields(ops)]
    ptrs = {t.data_ptr() for t in held if isinstance(t, torch.Tensor)}
    return ptrs | (_held_ptrs(ops.k1) if isinstance(ops, fr.FusedRingOperands) else set())


@pytest.mark.parametrize("name", list(_ENTRIES))
def test_launch_entry_packs_what_its_c_definition_takes(name):
    """Each C entry point's parameter table (launch.Entry) is its csrc/
    definition's, names, order and C types; an operand set's packed values,
    after placeholders for one call's own and the stream, are one for each
    parameter and convert under its type; every packed pointer is that of
    a tensor the operands hold; at_rows operands pack their own slice
    ranges and runs."""
    entry, ops = _ENTRIES[name]()
    assert list(entry.params) == _c_params(entry)
    if ops is None:
        assert entry.fixed == ()
        return
    args = [0] * (len(entry.params) - len(entry.fixed)) + list(ops.packed)
    assert len(args) == len(entry.params)
    for (_, ctype), value in zip(entry.params, args):
        ctype.from_param(value)
    held = _held_ptrs(ops)
    for (param, ctype), value in zip(entry.fixed, ops.packed):
        assert ctype is not ctypes.c_void_p or value is None or value in held, param
    if name == "fused_int8_hv":
        slot = {param: i for i, (param, _) in enumerate(entry.fixed)}
        assert ops.rows == 128
        for rows in (64, 32):
            other = fk.at_rows(ops, rows)
            assert other.packed[slot["rows"]] == rows
            assert other.packed[slot["slice_range"]] == other.slice_range.data_ptr()
            assert other.packed[slot["runs"]] == other.runs.data_ptr() != ops.packed[slot["runs"]]
