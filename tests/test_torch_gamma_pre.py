"""The linearize-once gamma route of the port (the prologue kernel K5 and
K1 int8's limb-plane input) against the JAX package on the CPU, and its
selection by ``AVIR_TPU_GAMMA_ROUTE``.  The JAX package's Pallas kernels
run in interpret mode; the port runs its kernels' plain versions.  The
kernels themselves are held against their plain versions on the card only
(tests/test_torch_cuda.py).

Every comparison here is bit-equal: the prologue evaluates the same
float32 polynomial with the same fused multiply-adds as K1's in-kernel
stage (ops/gamma.py), and the limb split is an exact integer
decomposition."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import xorshift128_fill

from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.lanes import lane_block_banded as jax_lane_block_banded
from avir_tpu.ops.pallas import fused_kernel as jax_fk
from avir_tpu.ops.pallas.gamma_prologue import (
    apply_gamma_prologue as jax_apply_gamma_prologue,
)
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from torch_cases import GAMMA_PRE_CASES, GAMMA_PRE_HV_CASES

import avir_tpu_torch
from avir_tpu_torch.models import runtime
from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import fused_kernel as fk
from avir_tpu_torch.ops.cuda import gamma_prologue as gp
from avir_tpu_torch.ops.lanes import lane_block_banded
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _case(name):
    sw, sh, nw, nh, c, tile, order, alpha = GAMMA_PRE_CASES[name]
    kw = dict(use_srgb_gamma=True, alpha_index=alpha)
    x = xorshift128_fill((sh, sw * c), np.uint8, sum(map(ord, name)))
    return (
        (sw, sh, nw, nh, c, tile, order),
        jax_build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, **kw),
        build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, **kw),
        x,
    )


@pytest.mark.parametrize("name", list(GAMMA_PRE_CASES))
def test_prologue_plain_matches_pallas(name):
    """K5's plain version against interpret-mode ``apply_gamma_prologue``:
    bit-equal over the port's planes, and the TPU layout's extra padding
    (256 x 1536 blocks) holds only zeros."""
    (sw, sh, nw, nh, c, tile, _), jplan, plan, x = _case(name)
    vop = block_banded(plan.v.op)
    lop = lane_block_banded(plan.h.op, c, tile=tile)
    hi, lo = gp.apply_gamma_prologue(
        torch.from_numpy(x), vop.n_in_pad, lop.lanes_pad, c, plan.alpha_index,
        plan.in_gamma_mult,
    )
    rows_p, lanes_p = hi.shape
    assert (rows_p, lanes_p) == gp.plane_shape(sh, sw * c, vop.n_in_pad, lop.lanes_pad)
    assert hi.dtype == lo.dtype == torch.int8
    jhi, jlo = jax_apply_gamma_prologue(
        jnp.asarray(x), vop.n_in_pad, lop.lanes_pad, c, jplan.alpha_index,
        jplan.in_gamma_mult, interpret=True,
    )
    for ours, theirs in ((hi, jhi), (lo, jlo)):
        theirs = np.asarray(theirs)
        ext = np.zeros(
            (max(rows_p, theirs.shape[0]), max(lanes_p, theirs.shape[1])), np.int8
        )
        ext[: theirs.shape[0], : theirs.shape[1]] = theirs
        np.testing.assert_array_equal(ours.numpy(), ext[:rows_p, :lanes_p])
        assert not ext[rows_p:].any() and not ext[:, lanes_p:].any()
    # The limbs recombine to the in-kernel stage's 13-bit values.
    q = hi.int() * 128 + lo.int()
    assert int(q.max()) <= 8192 and int(q.min()) >= 0


@pytest.mark.parametrize("name", list(GAMMA_PRE_CASES))
def test_int8_limb_plane_input_matches_pallas_and_inkernel(name):
    """K1 int8's plain version reading K5's planes is bit-equal to
    interpret-mode ``apply_fused_pallas(..., x_lo=lo)`` and to the port's
    in-kernel gamma plain version on the same image."""
    (sw, sh, nw, nh, c, tile, order), jplan, plan, x = _case(name)
    gkw = dict(
        gamma=True, alpha_index=plan.alpha_index,
        in_gamma_mult=plan.in_gamma_mult, out_gamma_mult=plan.out_gamma_mult,
    )
    vop = block_banded(plan.v.op)
    lop = lane_block_banded(plan.h.op, c, tile=tile)
    pre = fk.prepare_fused_int8(vop, lop, order, "cpu", gamma_pre=True, **gkw)
    inkernel = fk.prepare_fused_int8(vop, lop, order, "cpu", **gkw)
    assert pre.launch_key == f"fused_int8_{order}_gamma_pre"
    hi, lo = gp.apply_gamma_prologue(
        torch.from_numpy(x), pre.rows_pad, pre.lanes_pad, c, plan.alpha_index,
        plan.in_gamma_mult,
    )
    got = fk.apply_fused_int8(pre, hi, lo).numpy()
    np.testing.assert_array_equal(
        got, fk.apply_fused_int8(inkernel, torch.from_numpy(x)).numpy()
    )

    jvop = jax_block_banded(jplan.v.op)
    jlop = jax_lane_block_banded(jplan.h.op, c, tile=tile)
    jkw = dict(
        out_dtype=jnp.uint8, order=order, gamma=True,
        alpha_index=jplan.alpha_index, in_gamma_mult=jplan.in_gamma_mult,
        out_gamma_mult=jplan.out_gamma_mult, interpret=True,
    )
    jhi, jlo = jax_apply_gamma_prologue(
        jnp.asarray(x), jvop.n_in_pad, jlop.lanes_pad, c, jplan.alpha_index,
        jplan.in_gamma_mult, interpret=True,
    )
    ref = np.asarray(
        jax_fk.apply_fused_pallas(jvop, jlop, jhi, "int8", "int8", x_lo=jlo, **jkw)
    )[:nh, : nw * c]
    np.testing.assert_array_equal(got, ref)


def test_gamma_prologue_load_path():
    """K5 reads an image by 16-byte loads ("vector") only where every row
    starts 16-byte aligned: lanes a multiple of 16 and an aligned base;
    else byte by byte.  An image on neither the card nor the CPU raises."""
    assert gp.load_path(torch.zeros((3, 5760), dtype=torch.uint8)) == "vector"
    assert gp.load_path(torch.zeros((3, 600), dtype=torch.uint8)) == "byte"
    base = torch.zeros(1 + 3 * 5760, dtype=torch.uint8)
    assert gp.load_path(base[1:].view(3, 5760)) == "byte"
    assert gp.load_path(torch.zeros((3, 5759), dtype=torch.uint8)) == "byte"
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gp.apply_gamma_prologue(
            torch.zeros((3, 5760), dtype=torch.uint8, device="meta"),
            3, 5760, 3, -1, 1 / 255,
        )


def test_gamma_pre_cases_reach_their_edges():
    """GAMMA_PRE_CASES (K5 on the card) cover both load paths, C = 4 with
    the alpha lane at 0 and at 3 on each, planes taller and wider than the
    image, and more than one block of 16-lane groups (64) on the vector
    path."""
    seen = set()
    for name, (sw, sh, nw, nh, c, tile, order, alpha) in GAMMA_PRE_CASES.items():
        plan = build_resize_plan(
            sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True,
            alpha_index=alpha,
        )
        vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile)
        rows_p, lanes_p = gp.plane_shape(sh, sw * c, vop.n_in_pad, lop.lanes_pad)
        path = gp.load_path(torch.zeros((sh, sw * c), dtype=torch.uint8))
        seen |= {
            path,
            *([f"{path}_alpha{gp.alpha_lane(c, alpha)}"] if c == 4 else []),
            *(["rows_p_gt_rows"] if rows_p > sh else []),
            *(["lanes_p_gt_lanes"] if lanes_p > sw * c else []),
            *(["groups_gt_64"] if path == "vector" and lanes_p // 16 > 64 else []),
        }
    assert seen >= {
        "vector", "byte", "vector_alpha0", "vector_alpha3", "byte_alpha0",
        "byte_alpha3", "rows_p_gt_rows", "lanes_p_gt_lanes", "groups_gt_64",
    }


def test_limb_plane_input_checks_its_operands():
    (sw, sh, nw, nh, c, tile, order), _, plan, x = _case("down_c3")
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, c)
    with pytest.raises(ValueError, match="gamma route"):
        fk.prepare_fused_int8(vop, lop, order, "cpu", gamma_pre=True)
    pre = fk.prepare_fused_int8(
        vop, lop, order, "cpu", gamma=True, gamma_pre=True,
        in_gamma_mult=plan.in_gamma_mult,
    )
    hi, lo = gp.apply_gamma_prologue(
        torch.from_numpy(x), pre.rows_pad, pre.lanes_pad, c, -1, plan.in_gamma_mult
    )
    with pytest.raises(ValueError, match="limb planes"):
        fk.apply_fused_int8(pre, hi)
    with pytest.raises(ValueError, match="covering"):
        fk.apply_fused_int8(pre, hi[:-1, :-16], lo[:-1, :-16])


@pytest.mark.parametrize("name", list(GAMMA_PRE_CASES))
def test_limb_plane_operands_of_each_kernel(name):
    """Both orders from the limb planes run K1's s8 tensor-core kernels:
    their operands carry those kernels' fields as the operands without
    gamma do: each chunk's nonzero lane range, the lane alignment, and vh
    32-row slices (whose ranges are k_range's) with the packed lane taps,
    hv the slice height slice_rows picks for two input planes, its ranges,
    the intermediate's rows and the transposed lane taps."""
    (sw, sh, nw, nh, c, tile, order), _, plan, _ = _case(name)
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile)
    pre = fk.prepare_fused_int8(vop, lop, order, "cpu", gamma=True, gamma_pre=True)
    plain = fk.prepare_fused_int8(vop, lop, order, "cpu")
    assert pre.lane_align == plain.lane_align
    assert torch.equal(pre.h_range, plain.h_range)
    assert pre.launch_key == f"fused_int8_{order}_gamma_pre"
    if order == "vh":
        assert pre.rows == plain.rows == 32
        assert torch.equal(pre.slice_range, pre.k_range)
        assert torch.equal(pre.h1p, plain.h1p)
        return
    v1, v0 = pre.v1.numpy(), pre.v0.numpy()
    n_chunks = pre.h_range.shape[0] * pre.h_range.shape[1]
    assert pre.rows == fk.slice_rows("hv", v1, v0, n_chunks, 0, planes=2)
    sr, kwin = fk._slice_fields(v1, v0, pre.rows)
    assert torch.equal(pre.slice_range, torch.from_numpy(sr)) and pre.kwin == kwin
    assert torch.equal(pre.h1t, plain.h1t) and torch.equal(pre.h0t, plain.h0t)
    assert pre.h1p is None and pre.h0p is None


def test_limb_plane_hv_cases_reach_their_edges():
    """The card cases of the limb-plane hv kernel (GAMMA_PRE_HV_CASES) are
    int8 gamma hv resizes that cover what their comment promises: a slice
    range above the intermediate's rows (windows at 32-row slices), C = 4
    with the alpha lane first and last, lanes_in off a multiple of 4, C = 2
    and C = 5, and a ragged last slice at 128 rows."""
    seen = set()
    for sw, sh, nw, nh, c, tile, alpha in GAMMA_PRE_HV_CASES.values():
        plan = build_resize_plan(
            sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True, alpha_index=alpha
        )
        vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile)
        assert runtime.choose_fused(vop, lop, "int8", True, c) == (True, "hv")
        pre = fk.prepare_fused_int8(
            vop, lop, "hv", "cpu", gamma=True, gamma_pre=True, alpha_index=alpha
        )
        span = int((pre.slice_range[..., 1] - pre.slice_range[..., 0]).max())
        seen |= {
            f"c{c}",
            *([f"alpha{alpha}"] if pre.epi.alpha_lane >= 0 else []),
            *(["windows"] if span > fk.KWIN_MAX else []),
            *(["lanes_in_off_4"] if pre.lanes_in % 4 else []),
            *(["ragged_128"] if pre.rows_out % 128 and pre.v1.shape[1] >= 128
              and fk.at_rows(pre, 128).rows == 128 else []),
        }
    assert seen >= {"c1", "c2", "c3", "c4", "c5", "alpha0", "alpha3", "windows",
                    "lanes_in_off_4", "ragged_128"}


# An H100 SXM's SMs (the card of PERF.md's measurements).
H100_SMS = 132


@pytest.mark.parametrize(
    "size, rows",
    [((1920, 1080, 3840, 2160), 128), ((1280, 720, 1920, 1080), 128),
     ((640, 480, 1024, 768), 64)],
)
def test_limb_plane_hv_slice_height_on_an_h100(size, rows, monkeypatch):
    """The slice height of the limb-plane hv kernel on the prologue route
    of a u8 RGB gamma upsize, on an H100: slice_rows with two input planes
    gives the height the kernel launches, the tallest whose grid keeps two
    blocks per SM and whose shared memory (hv_smem_bytes with both planes'
    image tiles) lets two blocks share an SM; the same height as without
    gamma at these sizes (128 rows would leave 640x480 -> 1024x768 with
    fewer than two blocks per SM)."""
    monkeypatch.setattr(fk, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "prologue")
    plan = build_resize_plan(*size, 3, np.uint8, np.uint8, use_srgb_gamma=True)
    fn = runtime.make_avir_executor(plan, device="cpu")
    ops = fn.ops
    assert fn.order == "hv" and ops.launch_key == "fused_int8_hv_gamma_pre"
    n_chunks = ops.h_range.shape[0] * ops.h_range.shape[1]
    v1, v0 = ops.v1.numpy(), ops.v0.numpy()
    assert ops.rows == rows == fk.slice_rows("hv", v1, v0, n_chunks, H100_SMS, planes=2)
    assert fk.hv_smem_bytes(ops.kwin, 2) <= fk.two_blocks_smem(fk.H100_SM_SMEM) == 115_712
    assert n_chunks * v1.shape[0] * -(-v1.shape[1] // rows) >= 2 * H100_SMS
    monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV)
    plain = runtime.make_avir_executor(
        build_resize_plan(*size, 3, np.uint8, np.uint8), device="cpu"
    ).ops
    assert plain.rows == rows


# ---------------------------------------------------------------------------
# Route selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", [None, "inkernel", "auto", "prologue", "ring"])
def test_gamma_route_env(route, monkeypatch):
    """"prologue" runs K5 and K1's limb-plane variant (launch key
    ``*_gamma_pre``), bit-equal to the in-kernel route; "ring" (K6) is not
    viable on this upsize, so it warns, as the JAX package does, and takes
    the in-kernel route; unset, "auto" or anything else is the in-kernel
    route, silently."""
    if route is None:
        monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV, raising=False)
    else:
        monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, route)
    plan = build_resize_plan(
        97, 61, 151, 83, 4, np.uint8, np.uint8, use_srgb_gamma=True, alpha_index=3
    )
    if route == "ring":
        with pytest.warns(UserWarning, match="ring"):
            fn = runtime.make_avir_executor(plan, device="cpu")
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            fn = runtime.make_avir_executor(plan, device="cpu")
    assert fn.route == "int8" and fn.order == "hv"
    want = "fused_int8_hv_gamma" + ("_pre" if route == "prologue" else "")
    assert fn.ops.launch_key == want
    x = torch.from_numpy(xorshift128_fill((61, 97 * 4), np.uint8, 5))
    monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV, raising=False)
    base = runtime.make_avir_executor(plan, device="cpu")
    assert base.ops.launch_key == "fused_int8_hv_gamma"
    np.testing.assert_array_equal(fn(x).numpy(), base(x).numpy())


def test_gamma_route_is_part_of_the_cache_key(monkeypatch):
    src = xorshift128_fill((61, 97, 3), np.uint8, 9)
    rz = avir_tpu_torch.ImageResizer()
    monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV, raising=False)
    base = rz.resize(src, 151, 83, use_srgb_gamma=True, device="cpu")
    assert len(rz._cache) == 1
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "prologue")
    pre = rz.resize(src, 151, 83, use_srgb_gamma=True, device="cpu")
    assert len(rz._cache) == 2
    np.testing.assert_array_equal(pre, base)
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "ring")
    with pytest.warns(UserWarning, match="ring"):
        ring = rz.resize(src, 151, 83, use_srgb_gamma=True, device="cpu")
    assert len(rz._cache) == 3
    np.testing.assert_array_equal(ring, base)
    # Without gamma the variable changes nothing.
    plain = rz.resize(src, 151, 83, device="cpu")
    monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV)
    np.testing.assert_array_equal(plain, rz.resize(src, 151, 83, device="cpu"))
