"""The unfused two-kernel route of the port (the row pass K2, the lane pass
K3, their routing and the AVIR/LANCIR unfused executors) against the JAX
package on the CPU.  The JAX package's Pallas kernels run in interpret
mode, patched in at call time; the port runs its kernels' plain versions.
The kernels themselves are held against their plain versions on the card
only (tests/test_torch_cuda.py).

Tolerances:
  - blocked operators (the lane form at the base tile included) are
    array-equal to the JAX package's;
  - one pass (K2's and K3's plain versions) sums in another order than
    XLA and Pallas: within max|ref| * 1e-5;
  - whole resizes cross a bf16 re-split between the passes: integers
    within 1 LSB, float32 within max|ref| * 1e-4 (the split gate of
    tests/test_torch_split.py);
  - goldens at tests/test_device_exec.py's gate."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden, psnr, xorshift128_fill

import avir_tpu
from avir_tpu.models import runtime as jax_runtime
from avir_tpu.ops import lanes as jax_lanes
from avir_tpu.ops.banded import apply_blocked as jax_apply_blocked
from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.pallas import banded_kernel as jax_bk
from avir_tpu.ops.pallas import fused_kernel as jax_fk
from avir_tpu.ops.pallas import lanes_kernel as jax_lk
from avir_tpu.plan.lancir_plan import build_lancir_plan as jax_build_lancir_plan
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from torch_cases import BANDED_CASES, IN_BYTES, LANES_CASES, NP_TYPES, split_source

import avir_tpu_torch
from avir_tpu_torch.models import runtime
from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import banded_kernel as bk
from avir_tpu_torch.ops.cuda import fused_split as fs
from avir_tpu_torch.ops.cuda import lanes_kernel as lk
from avir_tpu_torch.ops.lanes import lane_block_banded, narrow_lop, pick_lane_tile
from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
from avir_tpu_torch.plan.plan import build_resize_plan

from test_torch_plan import DT, _M

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _interpret(fn, *args):
    """Run ``fn`` with the JAX package's Pallas kernels in interpret mode
    (tests/test_pallas_kernel.py:_interpret_executor)."""

    def interp(orig):
        def call(*a, **kw):
            kw["interpret"] = True
            return orig(*a, **kw)

        return call

    with mock.patch.object(
        jax_fk, "apply_fused_pallas", interp(jax_fk.apply_fused_pallas)
    ), mock.patch.object(
        jax_bk, "apply_blocked_pallas", interp(jax_bk.apply_blocked_pallas)
    ), mock.patch.object(
        jax_lk, "apply_lanes_pallas", interp(jax_lk.apply_lanes_pallas)
    ):
        return np.asarray(fn(*args))


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= np.abs(ref).max() * rel, (
        np.abs(got - ref).max(), np.abs(ref).max()
    )


# ---------------------------------------------------------------------------
# One pass: K2 and K3 plain versions against XLA and interpret-mode Pallas
# ---------------------------------------------------------------------------

# (src_w, src_h, new_w, new_h): an upsize and a downsize, both ragged.
PASS_SHAPES = {"up": (53, 37, 90, 71), "down": (150, 97, 61, 40)}


def _pass_inputs(shape, tin, c):
    sw, sh, nw, nh = PASS_SHAPES[shape]
    types = (NP_TYPES[tin], np.float32)
    return (
        (sw, sh, nw, nh),
        jax_build_resize_plan(sw, sh, nw, nh, c, *types),
        build_resize_plan(sw, sh, nw, nh, c, *types),
        split_source(f"{shape}{tin}{c}", sh, sw, c, tin),
    )


@pytest.mark.parametrize("shape", list(PASS_SHAPES))
@pytest.mark.parametrize("c", [1, 3, 4])
def test_unfused_operators_match_jax(shape, c):
    """The row operator and the lane operator at the base tile
    (``pick_lane_tile(wide=False)``, ``narrow_lop``) are the JAX
    package's, array for array."""
    (sw, sh, nw, nh), jplan, plan, _ = _pass_inputs(shape, "u8", c)
    assert pick_lane_tile(plan.h.op, c, wide=False) == jax_lanes.pick_lane_tile(
        jplan.h.op, c, wide=False
    )
    jlop = jax_runtime._narrow_lop(
        jplan.h.op, jax_lanes.lane_block_banded(jplan.h.op, c), c
    )
    lop = narrow_lop(plan.h.op, lane_block_banded(plan.h.op, c), c)
    assert lop.tile == jlop.tile
    np.testing.assert_array_equal(lop.offs_l, np.asarray(jlop.offs_l))
    for ours, theirs in ((lop.taps_hi, jlop.taps_hi), (lop.taps_lo, jlop.taps_lo)):
        np.testing.assert_array_equal(
            ours.view(torch.int16).numpy(), np.asarray(theirs).view(np.int16)
        )
    vop, jvop = block_banded(plan.v.op), jax_block_banded(jplan.v.op)
    np.testing.assert_array_equal(vop.offs, np.asarray(jvop.offs))
    np.testing.assert_array_equal(
        vop.taps_hi.view(torch.int16).numpy(), np.asarray(jvop.taps_hi).view(np.int16)
    )


@pytest.mark.parametrize("tin", ["u8", "u16", "f32"])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("mode", ["split2", "split3", "exact"])
def test_row_pass_plain_matches_jax(mode, c, tin):
    """K2's plain version (``apply_blocked`` on the kernel's taps) against
    the JAX package's ``apply_blocked`` and interpret-mode
    ``apply_blocked_pallas`` on the same operator: within max|ref| * 1e-5
    (exact: the kernel's hi + lo taps differ from the float32 taps by
    2^-17 of a tap)."""
    shape = "up" if c != 3 else "down"
    (sw, sh, nw, nh), jplan, plan, x = _pass_inputs(shape, tin, c)
    ib = IN_BYTES[tin]
    jvop = jax_block_banded(jplan.v.op, in_bytes=ib)
    ops = bk.prepare_banded(block_banded(plan.v.op, in_bytes=ib), mode, "cpu")
    got = bk.apply_banded(ops, torch.from_numpy(x)).numpy()
    assert got.shape == (nh, sw * c) and got.dtype == np.float32
    xla = jax_apply_blocked(jvop, jnp.asarray(x, jnp.float32), mode)
    _close(got, xla, 1e-5)
    pallas = jax_bk.apply_blocked_pallas(jvop, jnp.asarray(x), mode, interpret=True)
    _close(got, pallas, 1e-5)


def _scan_k_range(nz: np.ndarray, rows: int) -> np.ndarray:
    """Each ``rows``-row slice's nonzero tap rows of ``nz`` [B, T, W],
    found one slice at a time and rounded out to 32; (0, 0) for none."""
    b, t, w = nz.shape
    out = np.zeros((b, -(-t // rows), 2), dtype=np.int64)
    for bi in range(b):
        for s in range(out.shape[1]):
            used = np.flatnonzero(nz[bi, s * rows : (s + 1) * rows].any(axis=0))
            if used.size:
                out[bi, s] = used[0] // 32 * 32, min(-(-(used[-1] + 1) // 32) * 32, w)
    return out


@pytest.mark.parametrize("mode", ["split2", "split3", "exact"])
@pytest.mark.parametrize(
    "size",
    [(53, 37, 90, 71), (150, 97, 61, 40), (300, 20, 1400, 41), (40, 300, 64, 900),
     (1280, 720, 1920, 1080)],
)
def test_row_pass_k_range_is_a_scan_of_each_slice(size, mode):
    """K2's k_range at the slice height its kernel runs (SPLIT_ROWS = 64
    rows in every mode) equals a direct scan of each slice's nonzero tap
    rows; the launch grid has B x slices row blocks."""
    plan = build_resize_plan(*size, 3, np.uint8, np.float32)
    bop = block_banded(plan.v.op)
    ops = bk.prepare_banded(bop, mode, "cpu")
    assert ops.rows == 64 and bk.SPLIT_ROWS == 64
    nz = (bop.taps_hi != 0).numpy() | (bop.taps_lo != 0).numpy()
    np.testing.assert_array_equal(ops.k_range.numpy(), _scan_k_range(nz, ops.rows))


def test_banded_cases_reach_their_edges():
    """The card cases of K2 (tests/torch_cases.py BANDED_CASES) cover the
    edges of its tensor-core tiling, for the split modes and for exact
    apart (exact stores up to three limb planes): u8, u16 and f32 in each
    mode; rows whose width in bytes is off 16 (scalar loads) and on it
    (16-byte loads); R off a multiple of 8; n_out off the 64-row slices; a
    slice whose nonzero taps end inside a 16-deep MMA step; several row
    blocks."""
    seen = {"split": set(), "exact": set()}
    for sw, sh, nw, nh, c, tin, mode in BANDED_CASES.values():
        ib = IN_BYTES[tin]
        plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
        bop = block_banded(plan.v.op, in_bytes=ib)
        r = sw * c
        ops = bk.prepare_banded(bop, mode, "cpu")
        nz = (bop.taps_hi != 0).numpy() | (bop.taps_lo != 0).numpy()
        ends = {
            int(np.flatnonzero(nz[b, s : s + ops.rows].any(axis=0))[-1]) + 1
            for b in range(nz.shape[0]) for s in range(0, nz.shape[1], ops.rows)
            if nz[b, s : s + ops.rows].any()
        }
        seen["exact" if mode == "exact" else "split"] |= {
            f"{tin}_{mode}",
            "vector_rows" if (r * ib) % 16 == 0 else "scalar_rows",
            *(["r_off_8"] if r % 8 else []),
            *(["n_out_off_slices"] if nh % ops.rows else []),
            *(["end_inside_mma_step"] if any(e % 16 for e in ends) else []),
            *(["row_blocks"] if bop.n_blocks > 1 else []),
        }
    edges = {"vector_rows", "scalar_rows", "r_off_8", "n_out_off_slices",
             "end_inside_mma_step", "row_blocks"}
    types = ("u8", "u16", "f32")
    assert seen == {
        "split": {*(f"{t}_{m}" for t in types for m in ("split2", "split3")), *edges},
        "exact": {*(f"{t}_exact" for t in types), *edges},
    }


def _limbs(x: torch.Tensor, n: int) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The kernel's split of ``x`` into ``n`` bf16 limbs (csrc/banded.cu
    store_x): limb p is bf16 (round to nearest even) of what limbs 0..p-1
    left, the remainders taken in float32; returns the limbs and what they
    leave."""
    rest = x.float()
    limbs = []
    for _ in range(n):
        limb = rest.to(torch.bfloat16)
        limbs.append(limb)
        rest = rest - limb.float()
    return limbs, rest


def _limb_draws(tin: str) -> np.ndarray:
    """Every u8 and u16 value; float32 of both signs over 2^-60..2^60."""
    if tin != "f32":
        return np.arange(np.iinfo(NP_TYPES[tin]).max + 1).astype(NP_TYPES[tin])
    rng = np.random.default_rng(17)
    mant = rng.random(200_000) + 1.0
    sign = rng.choice([-1.0, 1.0], 200_000)
    return (sign * np.ldexp(mant, rng.integers(-60, 61, 200_000))).astype(np.float32)


@pytest.mark.parametrize("tin", ["u8", "u16", "f32"])
def test_exact_limbs_sum_back_to_the_input(tin):
    """K2 exact splits each input value into EXACT_LIMBS bf16 limbs (1 for
    u8, 2 for u16, 3 for float32) that sum back to it exactly, and one limb
    fewer does not (some value leaves a remainder)."""
    x = torch.from_numpy(_limb_draws(tin))
    n = bk.EXACT_LIMBS[x.dtype]
    limbs, rest = _limbs(x, n)
    assert not rest.any()
    total = sum(limb.double() for limb in limbs)
    assert torch.equal(total, x.double())
    if n > 1:
        assert _limbs(x, n - 1)[1].any()


@pytest.mark.parametrize("tin", ["u8", "u16", "f32"])
def test_exact_limb_products_are_the_taps_times_the_input(tin):
    """On a small blocked operator, each product of K2 exact (a tap plane,
    hi or lo, times an input limb) is exact in float64, and the products of
    one tap and one input value sum in float64 to f32(hi + lo) * x exactly;
    summed over the band they are within max|plain| * 1e-5 of the plain
    version (apply_banded_reference)."""
    sw, sh, nw, nh, c = 53, 37, 90, 71, 3
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
    bop = block_banded(plan.v.op, in_bytes=IN_BYTES[tin])
    ops = bk.prepare_banded(bop, "exact", "cpu")
    x = torch.from_numpy(split_source(f"limbs{tin}", sh, sw, c, tin))
    if tin == "f32":
        x = x * 2 - 1  # both signs, as K3's output has
    limbs, _ = _limbs(x, bk.EXACT_LIMBS[x.dtype])
    b_, t_, w_ = ops.hi.shape
    out = torch.zeros(b_ * t_, sw * c, dtype=torch.float64)
    taps = ops.hi.double() + ops.lo.double()
    for b in range(b_):
        o = int(bop.offs[b])
        rows = slice(o, min(o + w_, sh))
        k = rows.stop - rows.start

        def window(t):
            return t[rows].double()[None, :, :]

        products = sum(
            tap[b, :, :k, None].double() * window(limb)
            for tap in (ops.hi, ops.lo) for limb in limbs
        )
        assert torch.equal(products, taps[b, :, :k, None] * window(x))
        out[b * t_ : (b + 1) * t_] = products.sum(dim=1)
    want = bk.apply_banded_reference(ops, x).double()
    got = out[: bop.n_out]
    assert got.shape == want.shape == (nh, sw * c)
    assert (got - want).abs().max() <= want.abs().max() * 1e-5


@pytest.mark.parametrize("tin", ["u8", "u16", "f32"])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("mode", ["split2", "split3"])
def test_lane_pass_plain_matches_jax(mode, c, tin):
    """K3's plain version against ``apply_lanes_xla`` and interpret-mode
    ``apply_lanes_pallas`` at the base tile: within max|ref| * 1e-5; and
    the kernel's operands (the chunked lane taps over each chunk's nonzero
    range ``h_range``) hold every nonzero tap of the dense blocks."""
    shape = "up" if c != 4 else "down"
    (sw, sh, nw, nh), jplan, plan, x = _pass_inputs(shape, tin, c)
    ib = IN_BYTES[tin]
    jlop = jax_runtime._narrow_lop(
        jplan.h.op, jax_lanes.lane_block_banded(jplan.h.op, c, in_bytes=ib), c,
        in_bytes=ib,
    )
    lop = narrow_lop(
        plan.h.op, lane_block_banded(plan.h.op, c, in_bytes=ib), c, in_bytes=ib
    )
    ops = lk.prepare_lanes(lop, mode, "cpu")
    got = lk.apply_lanes(ops, torch.from_numpy(x)).numpy()
    assert got.shape == (sh, nw * c) and got.dtype == np.float32
    _close(got, jax_lk.apply_lanes_xla(jlop, jnp.asarray(x, jnp.float32), mode), 1e-5)
    pallas = jax_lk.apply_lanes_pallas(jlop, jnp.asarray(x), mode, interpret=True)
    _close(got, pallas, 1e-5)
    # The chunked taps inside each chunk's h_range, expanded back, are the
    # dense form: nothing nonzero lies outside a range.
    for chunked, dense in ((ops.thh, lop.taps_hi), (ops.thl, lop.taps_lo)):
        np.testing.assert_array_equal(_expand_chunks(ops, chunked), dense.float().numpy())


def _expand_chunks(ops, chunked):
    """The kernel's chunked taps [Bh, n_ch, win_c, 128], read only inside
    each chunk's h_range, as the dense blocks [Bh, win_l, TC]."""
    lop = ops.lop
    bh, n_ch = chunked.shape[:2]
    tc = lop.tile * lop.c
    hr = ops.h_range.numpy()
    assert hr.shape == (bh, n_ch, 2) and (hr % 32 == 0).all()
    dense = np.zeros((bh, lop.win_l, n_ch * 128), np.float32)
    taps = chunked.float().numpy()
    for b in range(bh):
        for j, r in enumerate(ops.rel.tolist()):
            lo, hi = hr[b, j]
            dense[b, r + lo : r + hi, j * 128 : (j + 1) * 128] = taps[b, j, lo:hi]
    assert not dense[:, :, tc:].any()
    return dense[:, :, :tc]


def _lanes_case(name, device="cpu"):
    """(lane operator at the base tile, K3 operands) of a LANES_CASES case."""
    sw, sh, nw, nh, c, tin, mode = LANES_CASES[name]
    ib = IN_BYTES[tin]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
    lop = narrow_lop(
        plan.h.op, lane_block_banded(plan.h.op, c, in_bytes=ib), c, in_bytes=ib
    )
    return lop, lk.prepare_lanes(lop, mode, device)


@pytest.mark.parametrize("name", list(LANES_CASES))
def test_lane_operands_are_k1_splits_chunked_form(name):
    """K3's operands are the chunked lane taps, chunk offsets and nonzero
    ranges that K1 split builds from the same operator, with the window
    starts as int32; the taps' window is whole 32-lane steps."""
    lop, ops = _lanes_case(name)
    plan = build_resize_plan(*LANES_CASES[name][:5], np.uint8, np.float32)
    fops = fs.prepare_fused_split(
        block_banded(plan.v.op), lop, "vh", "split3", "split3", "cpu"
    )
    for ours, k1 in ((ops.thh, fops.thh), (ops.thl, fops.thl), (ops.rel, fops.rel),
                     (ops.h_range, fops.h_range), (ops.offs_l, fops.offs_l)):
        assert ours.dtype == k1.dtype and torch.equal(ours, k1)
    bh, n_ch, win_c, lanes = ops.thh.shape
    assert (bh, lanes) == (lop.n_blocks, 128) and n_ch * 128 >= lop.tile * lop.c
    assert win_c % 32 == 0 and ops.thh.dtype == torch.bfloat16
    assert ops.offs_l.dtype == ops.rel.dtype == ops.h_range.dtype == torch.int32
    assert ops.n_ch == n_ch and ops.launch_key == f"lanes_{ops.mode}"


def test_lanes_cases_reach_their_edges():
    """The card cases of K3 (LANES_CASES) cover what their comment
    promises: every input type in both modes, rows off 64 over several row
    blocks, a chunk whose nonzero range is one 32-lane step and a chunk
    with none, C in {1, 2, 3, 4, 5, 8}, u8 / u16 rows off and on a 16-byte
    pitch (f32 on it), a wide f32 upsize, and an odd lanes_out."""
    seen = set()
    for name, (sw, sh, nw, nh, c, tin, mode) in LANES_CASES.items():
        lop, ops = _lanes_case(name)
        hr = ops.h_range.numpy()
        spans = set((hr[..., 1] - hr[..., 0]).ravel().tolist())
        vec = (sw * c * IN_BYTES[tin]) % 16 == 0
        seen |= {
            f"{tin}_{mode}", f"c{c}", f"{tin}_{'vector' if vec else 'scalar'}",
            *(["rows_off_64"] if sh % 64 and sh > 64 else []),
            *(["one_step_chunk"] if 32 in spans else []),
            *(["empty_chunk"] if 0 in spans else []),
            *(["wide_f32_up"] if tin == "f32" and nw > sw and lop.n_blocks > 8 else []),
            *(["odd_lanes_out"] if (nw * c) % 2 else []),
        }
    assert seen >= {
        *(f"{t}_{m}" for t in ("u8", "u16", "f32") for m in ("split2", "split3")),
        *(f"c{c}" for c in (1, 2, 3, 4, 5, 8)),
        "u8_vector", "u8_scalar", "u16_vector", "u16_scalar", "f32_vector",
        "rows_off_64", "one_step_chunk", "empty_chunk", "wide_f32_up",
        "odd_lanes_out",
    }


@pytest.mark.parametrize(
    "bad",
    ["width", "float64", "three_dims", "strided", "too_many_rows"],
)
def test_lane_pass_checks_its_input(bad):
    """``check_input`` (the kernel path's checks) refuses what the kernel
    does not take and passes u8, u16 and float32 images of the operator's
    width."""
    lop, ops = _lanes_case("up_c3_u8_split3")
    width = lop.n_in * lop.c
    for dt in (torch.uint8, torch.uint16, torch.float32):
        lk.check_input(ops, torch.zeros((5, width), dtype=dt))
    x = {
        "width": torch.zeros((5, width + 1), dtype=torch.uint8),
        "float64": torch.zeros((5, width), dtype=torch.float64),
        "three_dims": torch.zeros((5, width, 1), dtype=torch.uint8),
        "strided": torch.zeros((5, 2 * width), dtype=torch.uint8)[:, ::2],
        "too_many_rows": torch.empty(
            (65535 * lk.ROWS + 1, width), dtype=torch.uint8, device="meta"
        ),
    }[bad]
    with pytest.raises(ValueError):
        lk.check_input(ops, x)


# ---------------------------------------------------------------------------
# Routing against the JAX package's choose_fused (fused_viable taken true)
# ---------------------------------------------------------------------------

# (kind, src_w, src_h, new_w, new_h, c, in, out, options, int8 feasible,
#  route)
ROUTES = {
    "avir_down_u8": ("avir", 64, 48, 30, 20, 3, "u8", "u8", {}, True, "int8"),
    "avir_up_u8": ("avir", 30, 20, 64, 48, 3, "u8", "u8", {}, True, "int8"),
    "avir_up_u8_errdiff": ("avir", 30, 20, 64, 48, 3, "u8", "u8", {"errdiff": True}, True, "unfused"),
    "avir_down_u8_errdiff": ("avir", 64, 48, 30, 20, 3, "u8", "u8", {"errdiff": True}, True, "split"),
    "avir_up_u8_gamma": ("avir", 30, 20, 64, 48, 4, "u8", "u8", {"use_srgb_gamma": True, "alpha_index": 3}, True, "int8"),
    "avir_up_u8_gamma_errdiff": ("avir", 30, 20, 64, 48, 3, "u8", "u8", {"use_srgb_gamma": True, "errdiff": True}, True, "unfused"),
    "avir_up_u16": ("avir", 30, 20, 64, 48, 3, "u16", "u16", {}, True, "split"),
    "avir_up_f32": ("avir", 30, 20, 64, 48, 1, "f32", "f32", {}, True, "split"),
    "avir_up_u16_gamma_rgba": ("avir", 30, 20, 64, 48, 4, "u16", "u16", {"use_srgb_gamma": True, "alpha_index": 3}, True, "split"),
    "avir_up_f32_c3": ("avir", 30, 20, 64, 48, 3, "f32", "f32", {}, True, "split"),
    "avir_up_u8_u16": ("avir", 30, 20, 64, 48, 1, "u8", "u16", {}, True, "unfused"),
    "avir_up_u8_u16_big": ("avir", 800, 600, 2000, 1400, 3, "u8", "u16", {}, True, "split"),
    "avir_up_u8_gamma_big": ("avir", 800, 600, 2000, 1400, 3, "u8", "u16", {"use_srgb_gamma": True}, True, "unfused"),
    "avir_up_u8_bits6": ("avir", 30, 20, 64, 48, 3, "u8", "u8", {"res_bit_depth": 6}, True, "unfused"),
    "avir_up_u8_fast": ("avir", 30, 20, 64, 48, 3, "u8", "u8", {"precision": "fast"}, True, "unfused"),
    "avir_up_u8_exact": ("avir", 30, 20, 64, 48, 3, "u8", "u8", {"precision": "exact"}, True, "exact"),
    "avir_down_u8_infeasible": ("avir", 64, 48, 30, 20, 3, "u8", "u8", {}, False, "unfused"),
    "avir_up_u8_infeasible": ("avir", 30, 20, 64, 48, 4, "u8", "u8", {}, False, "unfused"),
    "lancir_up_u8_f32": ("lancir", 30, 20, 64, 48, 3, "u8", "f32", {}, True, "unfused"),
    "lancir_up_u8": ("lancir", 30, 20, 64, 48, 3, "u8", "u8", {}, True, "int8"),
    "lancir_down_u16_u8": ("lancir", 64, 48, 30, 20, 3, "u16", "u8", {}, True, "split"),
    "lancir_up_u16": ("lancir", 30, 20, 64, 48, 3, "u16", "u16", {}, True, "split"),
    "lancir_up_u8_u16": ("lancir", 30, 20, 64, 48, 4, "u8", "u16", {}, True, "unfused"),
    "lancir_up_u8_infeasible": ("lancir", 30, 20, 64, 48, 3, "u8", "u8", {}, False, "unfused"),
}


def _plans(kind, sw, sh, nw, nh, c, tin, tout, opts):
    opts = dict(opts)
    exec_kw = {
        k: opts.pop(k) for k in ("errdiff", "precision") if k in opts
    }
    types = (NP_TYPES[tin], NP_TYPES[tout])
    if kind == "lancir":
        return (
            jax_build_lancir_plan(sw, sh, nw, nh, c, *types),
            build_lancir_plan(sw, sh, nw, nh, c, *types),
            exec_kw,
        )
    return (
        jax_build_resize_plan(sw, sh, nw, nh, c, *types, **opts),
        build_resize_plan(sw, sh, nw, nh, c, *types, **opts),
        exec_kw,
    )


def _executors(kind, jplan, plan, exec_kw, feasible=True, engine="pallas"):
    """(JAX executor with its choose_fused outcome recorded, port
    executor on the CPU), with ``int8_feasible`` forced false in both
    packages when ``feasible`` is false."""
    seen = []
    orig = jax_fk.choose_fused

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out)
        return out

    patches = [
        mock.patch.object(jax_fk, "choose_fused", spy),
        mock.patch.object(jax_fk, "fused_viable", lambda *a, **kw: True),
    ]
    if not feasible:
        patches += [
            mock.patch.object(jax_fk, "int8_feasible", lambda *a, **kw: False),
            mock.patch.object(runtime, "int8_feasible", lambda *a, **kw: False),
        ]
    for p in patches:
        p.start()
    try:
        if kind == "lancir":
            jfn = jax_runtime.make_lancir_executor(
                jplan, precision=exec_kw.get("precision", "auto"), engine=engine
            )
            fn = runtime.make_lancir_executor(plan, device="cpu", **exec_kw)
        else:
            jfn = jax_runtime.make_avir_executor(jplan, engine=engine, **exec_kw)
            fn = runtime.make_avir_executor(plan, device="cpu", **exec_kw)
    finally:
        for p in reversed(patches):
            p.stop()
    return jfn, (seen[0] if seen else None), fn


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_matches_jax_choose_fused(name):
    kind, sw, sh, nw, nh, c, tin, tout, opts, feasible, route = ROUTES[name]
    jplan, plan, exec_kw = _plans(kind, sw, sh, nw, nh, c, tin, tout, opts)
    _, jax_choice, fn = _executors(kind, jplan, plan, exec_kw, feasible)
    assert fn.route == route
    if route == "exact":
        assert jax_choice is None
        return
    jax_fused, jax_order = jax_choice
    assert (fn.route != "unfused") == jax_fused
    if fn.route != "unfused":
        assert fn.order == jax_order
    if fn.route == "unfused":
        assert fn.order in ("vh", "hv")
        # The pass that reads the image runs the first mode.
        exact_bf16 = (
            jplan.in_exact_bf16 if kind == "lancir"
            else runtime.in_exact_bf16(plan)
        )
        first, second = (
            (fn.ops.lanes, fn.ops.rows) if fn.order == "hv"
            else (fn.ops.rows, fn.ops.lanes)
        )
        assert (first.mode, second.mode) == jax_runtime.resolve_modes(
            exec_kw.get("precision", "auto"), exact_bf16
        )
        assert fn.ops.lanes.lop.tile == pick_lane_tile(
            plan.h if kind == "lancir" else plan.h.op, c, wide=False
        )


# ---------------------------------------------------------------------------
# Unfused executors against the JAX package's Pallas-engine executors
# ---------------------------------------------------------------------------

# ROUTES entries, plus a forced "vh" pass order on an upsize.
EXEC_CASES = {
    "avir_up_u8_errdiff": ("avir_up_u8_errdiff", None),
    "avir_up_u8_gamma_errdiff_c4": ("avir_up_u8_gamma_errdiff", None),
    "avir_up_u8_u16": ("avir_up_u8_u16", None),
    "avir_up_u8_bits6": ("avir_up_u8_bits6", None),
    "avir_up_u8_fast": ("avir_up_u8_fast", None),
    "avir_down_u8_infeasible": ("avir_down_u8_infeasible", None),
    "avir_up_u8_infeasible_c4": ("avir_up_u8_infeasible", None),
    "lancir_up_u8_f32": ("lancir_up_u8_f32", None),
    "lancir_up_u8_u16_c4": ("lancir_up_u8_u16", None),
    "lancir_up_u8_infeasible": ("lancir_up_u8_infeasible", None),
    "avir_up_u8_u16_forced_vh": ("avir_up_u8_u16", "vh"),
    "lancir_up_u8_f32_forced_vh": ("lancir_up_u8_f32", "vh"),
}


@pytest.mark.parametrize("name", list(EXEC_CASES))
def test_unfused_executor_matches_jax_pallas_engine(name, monkeypatch):
    route_name, forced = EXEC_CASES[name]
    kind, sw, sh, nw, nh, c, tin, tout, opts, feasible, _ = ROUTES[route_name]
    if forced is not None:
        monkeypatch.setattr(runtime, "lanes_order", lambda *a: forced)
    jplan, plan, exec_kw = _plans(kind, sw, sh, nw, nh, c, tin, tout, opts)
    jfn, _, fn = _executors(kind, jplan, plan, exec_kw, feasible)
    assert fn.route == "unfused"
    if forced is not None:
        assert fn.order == forced
    x = xorshift128_fill((sh, sw * c), NP_TYPES[tin], sum(map(ord, name)))
    got = fn(torch.from_numpy(x)).numpy()
    patches = [mock.patch.object(jax_fk, "fused_viable", lambda *a, **kw: True)]
    if not feasible:
        patches.append(
            mock.patch.object(jax_fk, "int8_feasible", lambda *a, **kw: False)
        )
    for p in patches:
        p.start()
    try:
        ref = _interpret(jfn, jnp.asarray(x))
    finally:
        for p in reversed(patches):
            p.stop()
    assert got.shape == ref.shape == (nh, nw * c) and got.dtype == ref.dtype
    if tout == "f32":
        _close(got, ref, 1e-4)
    else:
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


# The goldens, through the unfused route: int8-eligible u8 goldens whose
# int8 limbs are forced infeasible (rule 1), at tests/test_device_exec.py's
# gate (u8: 1 LSB and >= 60 dB).
UNFUSED_GOLDENS = ["a_up3u8", "a_down3u8", "a_rgba8gamma", "a_preset_ultra", "l_up3u8", "l_down4u8"]


@pytest.mark.parametrize("name", UNFUSED_GOLDENS)
def test_goldens_through_the_unfused_route(name, monkeypatch):
    monkeypatch.setattr(runtime, "int8_feasible", lambda *a, **kw: False)
    cfg = _M[name]
    src = xorshift128_fill(
        (cfg["sh"], cfg["sw"], cfg["ch"]), DT[cfg["tin"]], cfg["seed"]
    )
    assert (cfg["tin"], cfg["tout"]) == ("u8", "u8")
    if cfg.get("kind") == "lancir":
        kw = dict(kx=cfg["kx"], ky=cfg["ky"], ox=cfg["ox"], oy=cfg["oy"], la=cfg["la"])
        plan = build_lancir_plan(
            cfg["sw"], cfg["sh"], cfg["nw"], cfg["nh"], cfg["ch"], np.uint8,
            np.uint8, **kw,
        )
        assert runtime.make_lancir_executor(plan, device="cpu").route == "unfused"
        out = avir_tpu_torch.LancIR().resize(
            src, cfg["nw"], cfg["nh"], device="cpu", **kw
        )
        jax_out = avir_tpu.LancIR().resize(src, cfg["nw"], cfg["nh"], **kw)
    else:
        kw = dict(
            k=cfg["k"], ox=cfg["ox"], oy=cfg["oy"],
            use_srgb_gamma=bool(cfg["gamma"]), alpha_index=cfg.get("alphaidx", -1),
        )
        params = avir_tpu_torch.preset(cfg["preset"])
        plan = build_resize_plan(
            cfg["sw"], cfg["sh"], cfg["nw"], cfg["nh"], cfg["ch"], np.uint8,
            np.uint8, params=params, **kw,
        )
        assert runtime.make_avir_executor(plan, device="cpu").route == "unfused"
        out = avir_tpu_torch.ImageResizer(params=params).resize(
            src, cfg["nw"], cfg["nh"], device="cpu", **kw
        )
        jax_out = avir_tpu.ImageResizer(
            params=avir_tpu.preset(cfg["preset"])
        ).resize(src, cfg["nw"], cfg["nh"], **kw)
    ref = load_golden(name)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.abs(out.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    assert psnr(out, ref, 255.0) >= 60.0
    assert np.abs(out.astype(np.int16) - jax_out.astype(np.int16)).max() <= 1


def test_unfused_kernels_raise_on_mismatched_devices():
    """A wrapper given a CPU image and CUDA-resident operands (or the
    reverse) raises; it never falls back to its plain version."""
    plan = build_resize_plan(30, 20, 64, 48, 3, np.uint8, np.uint8)
    ops = bk.prepare_banded(block_banded(plan.v.op), "split2", "cpu")
    fake = ops.__class__(**{**ops.__dict__, "hi": ops.hi.to("meta")})
    with pytest.raises(ValueError, match="CUDA device"):
        bk.apply_banded(fake, torch.zeros((20, 90), dtype=torch.uint8))
    lops = lk.prepare_lanes(lane_block_banded(plan.h.op, 3, tile=128), "split3", "cpu")
    fake = lops.__class__(**{**lops.__dict__, "thh": lops.thh.to("meta")})
    with pytest.raises(ValueError, match="CUDA device"):
        lk.apply_lanes(fake, torch.zeros((20, 90), dtype=torch.uint8))
