"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips without a
card.  The file imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: K1 int8 (its limb-plane input and its in-kernel gamma
included, at every slice height),
K4 (at every row grouping), K5 and K6 are bit-equal (exact integer sums; the same float32 operations in the same
order, gamma and the round-half-even epilogue included).  K1 split-bf16,
K7 and K8 sum in another order than their plain versions: float32 within
max|plain| * 1e-4 (after a split2 second pass, plus the flip of one bf16
ulp of the intermediate, ``torch_cases.split2_tol``), integers within 1
LSB, or one quantization step when ``trunc_bits`` > 0 (16-bit output
through gamma-out: max * 1e-4 plus one step).  K2 and K3 (one pass each) sum in another order: float32 within
max|plain| * 1e-5."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from torch_cases import (
    BANDED_CASES,
    FUSED_CASES,
    GAMMA_PRE_CASES,
    GAMMA_PRE_HV_CASES,
    GAMMA_PRE_VH_CASES,
    HV_RUN_CASES,
    HV_RUN_MODES,
    IN_BYTES,
    LANES_CASES,
    INT8_EPI_CASES,
    NP_TYPES,
    PLANAR_CASES,
    RING_CASES,
    RING_CLUSTER_CASES,
    SPLIT_CASES,
    SPLIT_EPI_CASES,
    SPLIT_HV_EDGE_CASES,
    VH_RING_CASES,
    VH_RING_EPI_CASES,
    VH_RING_PRE_CASES,
    WAVEFRONT_CASES,
    WAVEFRONT_GROUP_CASES,
    WAVEFRONT_GROUP_WARPS,
    WAVEFRONT_WARP_CASES,
    WAVEFRONT_WARP_OUTS,
    epi_kwargs,
    float_image,
    order_of,
    plane_width,
    split2_tol,
    split_source,
    unaligned_copy,
)

from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import banded_kernel as bk
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

_TORCH = {"u8": torch.uint8, "u16": torch.uint16, "f32": torch.float32}
_RING = {**RING_CASES, **RING_CLUSTER_CASES}
_SPLIT_EPI = {**SPLIT_EPI_CASES, **SPLIT_HV_EDGE_CASES}
# The vh ring's edges in each input mode beside the tiling's cases.
_FUSED = {**FUSED_CASES, **VH_RING_CASES}
_INT8_EPI = {**INT8_EPI_CASES, **VH_RING_EPI_CASES}
_PRE_VH = {**GAMMA_PRE_VH_CASES, **VH_RING_PRE_CASES}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_FUSED))
def test_int8_kernel_matches_plain_on_card(name, cuda_device):
    sw, sh, nw, nh, c, tile = _FUSED[name]
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op),
        lane_block_banded(plan.h.op, c, tile=tile),
        order_of(sw, sh, nw, nh),
        cuda_device,
    )
    x = torch.randint(
        0, 256, (sh, sw * c), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(3),
    ).to(cuda_device)
    got = fk.apply_fused_int8(ops, x)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.apply_fused_int8_reference(ops, x))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 64, 128])
@pytest.mark.parametrize("name", [n for n in FUSED_CASES if n.startswith("edge")])
def test_int8_kernel_every_slice_height_on_card(name, rows, cuda_device):
    """The tensor-core kernels at every slice height they take (vh 32, hv
    also 64 and 128), whatever slice_rows would pick: bit-equal to the
    plain version."""
    sw, sh, nw, nh, c, tile = FUSED_CASES[name]
    order = order_of(sw, sh, nw, nh)
    if order == "vh" and rows != 32:
        pytest.skip("the vh kernel takes 32-row slices")
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile),
        order, cuda_device,
    )
    try:
        ops = fk.at_rows(ops, rows)
    except ValueError:
        pytest.skip(f"{rows}-row slice ranges exceed the hv intermediate")
    x = torch.from_numpy(
        np.random.default_rng(sum(map(ord, name)) + rows).integers(
            0, 256, (sh, sw * c), dtype=np.uint8
        )
    ).to(cuda_device)
    got = fk.apply_fused_int8(ops, x)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.apply_fused_int8_reference(ops, x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_kernel_matches_plain_on_card(name, cuda_device):
    sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb = SPLIT_CASES[name]
    out_max = 255.0 if tout == "u8" else 65535.0
    ib = IN_BYTES[tin]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout])
    ops = fs.prepare_fused_split(
        block_banded(plan.v.op, in_bytes=ib),
        lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib),
        order, mv, mh, cuda_device, out_dtype=_TORCH[tout],
        out_max=out_max, trunc_bits=tb,
    )
    x = torch.from_numpy(split_source(name, sh, sw, c, tin)).to(cuda_device)
    got = fs.apply_fused_split(ops, x)
    torch.cuda.synchronize()
    want = fs.apply_fused_split_reference(ops, x)
    diff = (got.double() - want.double()).abs().max().item()
    assert diff <= split2_tol(
        ops, tout, want.double().abs().max().item(), x.double().abs().max().item(),
        out_max, tb,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_INT8_EPI))
def test_int8_epilogue_kernel_matches_plain_on_card(name, cuda_device):
    """Round-half-even with scale, and gamma with the C=4 alpha bypass."""
    sw, sh, nw, nh, c, tile, order, rm, scale, g, alpha = _INT8_EPI[name]
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=g,
        alpha_index=alpha,
    )
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile),
        order, cuda_device, **epi_kwargs(plan, rm, scale, g, alpha),
    )
    x = torch.from_numpy(
        np.random.default_rng(sum(map(ord, name))).integers(
            0, 256, (sh, sw * c), dtype=np.uint8
        )
    ).to(cuda_device)
    before = fk.launches[ops.launch_key]
    got = fk.apply_fused_int8(ops, x)
    torch.cuda.synchronize()
    assert fk.launches[ops.launch_key] == before + 1
    assert torch.equal(got, fk.apply_fused_int8_reference(ops, x))


_INT8_GAMMA = [n for n, case in INT8_EPI_CASES.items() if case[9]]


def _int8_gamma_case(name, device):
    """(in-kernel gamma operands, u8 image) of an INT8_EPI_CASES gamma case."""
    sw, sh, nw, nh, c, tile, order, rm, scale, g, alpha = INT8_EPI_CASES[name]
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True, alpha_index=alpha,
    )
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, c, tile=tile),
        order, device, **epi_kwargs(plan, rm, scale, g, alpha),
    )
    x = torch.from_numpy(
        np.random.default_rng(sum(map(ord, name)) + 5).integers(
            0, 256, (sh, sw * c), dtype=np.uint8
        )
    ).to(device)
    return ops, x


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 64, 128])
@pytest.mark.parametrize("name", _INT8_GAMMA)
def test_int8_gamma_kernel_every_slice_height_on_card(name, rows, cuda_device):
    """K1 int8 with the in-kernel gamma (the s8 tensor-core kernels,
    linearizing the image from their shared table) at every slice height
    at_rows takes (vh 32; hv also 64 and 128): bit-equal to the plain
    version, one launch each."""
    ops, x = _int8_gamma_case(name, cuda_device)
    if ops.order == "vh" and rows != 32:
        pytest.skip("the vh kernel takes 32-row slices")
    try:
        ops = fk.at_rows(ops, rows)
    except ValueError:
        pytest.skip(f"{rows}-row slice ranges exceed the hv intermediate")
    before = fk.launches[ops.launch_key]
    got = fk.apply_fused_int8(ops, x)
    torch.cuda.synchronize()
    assert fk.launches[ops.launch_key] == before + 1
    assert torch.equal(got, fk.apply_fused_int8_reference(ops, x))


@pytest.mark.cuda
def test_int8_gamma_hv_repeats_bit_equal_on_card(cuda_device):
    """10 launches of a many-block in-kernel gamma hv (a 32-row image
    group converted in shared memory each step, several groups and chunks
    a block) give the plain version's bytes each time: a missing barrier
    after the conversion would show here."""
    ops, x = _int8_gamma_case("gamma_edge_rows_up_c3", cuda_device)
    assert ops.order == "hv" and ops.slice_range.shape[1] > 1
    want = fk.apply_fused_int8_reference(ops, x)
    for _ in range(10):
        got = fk.apply_fused_int8(ops, x)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_SPLIT_EPI))
def test_split_epilogue_kernel_matches_plain_on_card(name, cuda_device):
    """The epilogue variants, and the edges of the hv kernel's tiling."""
    (sw, sh, nw, nh, c, tile, order, mv, mh, tin, tout, tb, rm, scale, g,
     alpha) = _SPLIT_EPI[name]
    out_max = 255.0 if tout == "u8" else 65535.0
    ib = IN_BYTES[tin]
    plan = build_resize_plan(
        sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout], use_srgb_gamma=g,
        alpha_index=alpha,
    )
    ops = fs.prepare_fused_split(
        block_banded(plan.v.op, in_bytes=ib),
        lane_block_banded(plan.h.op, c, tile=tile, in_bytes=ib),
        order, mv, mh, cuda_device, out_dtype=_TORCH[tout], out_max=out_max,
        trunc_bits=tb, **epi_kwargs(plan, rm, scale, g, alpha),
    )
    x = torch.from_numpy(split_source(name, sh, sw, c, tin)).to(cuda_device)
    got = fs.apply_fused_split(ops, x)
    torch.cuda.synchronize()
    want = fs.apply_fused_split_reference(ops, x)
    diff = (got.double() - want.double()).abs().max().item()
    assert diff <= split2_tol(
        ops, tout, want.double().abs().max().item(), x.double().abs().max().item(),
        out_max, tb, g, scale,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, c, tb, om", WAVEFRONT_CASES)
def test_wavefront_kernel_matches_plain_on_card(h, w, c, tb, om, cuda_device):
    img = torch.from_numpy(float_image(h, w, c, om, h + w)).to(cuda_device)
    for rows in (None, 5):
        got = wf.errdiff_wavefront(img, tb, om, block_rows=rows)
        torch.cuda.synchronize()
        want = wf.errdiff_wavefront_reference(img, tb, om, block_rows=rows)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", WAVEFRONT_GROUP_WARPS)
@pytest.mark.parametrize("name", list(WAVEFRONT_GROUP_CASES))
def test_wavefront_groups_match_plain_on_card(name, warps, cuda_device):
    """K4 with row groups of one, four and 32 warps, all groups in one
    launch: bit-equal to the plain version in every output type."""
    h, w, c, tb, om, tout = WAVEFRONT_GROUP_CASES[name]
    img = torch.from_numpy(float_image(h, w, c, om, h * 7 + w)).to(cuda_device)
    rows = warps * 32 // c
    before = wf.launches["wavefront"]
    got = wf.errdiff_wavefront(img, tb, om, out_dtype=_TORCH[tout], block_rows=rows)
    torch.cuda.synchronize()
    assert wf.launches["wavefront"] == before + 1
    want = wf.errdiff_wavefront_reference(img, tb, om).to(_TORCH[tout])
    assert got.dtype == _TORCH[tout] and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 4, 32, None])
def test_wavefront_groups_agree_over_repeats_on_card(warps, cuda_device):
    """A race between groups or between the warps of a group would show
    only sometimes: 20 runs of one image of many groups (groups of 1, 4
    and 32 warps, and the default), each bit-equal to the plain version."""
    h, w, c, tb, om, _ = WAVEFRONT_GROUP_CASES["c3_tall_u8"]
    img = torch.from_numpy(float_image(h, w, c, om, 11)).to(cuda_device)
    want = wf.errdiff_wavefront_reference(img, tb, om)
    rows = None if warps is None else warps * 32 // c
    for _ in range(20):
        got = wf.errdiff_wavefront(img, tb, om, block_rows=rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tout", list(WAVEFRONT_WARP_OUTS))
@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("name", list(WAVEFRONT_WARP_CASES))
def test_wavefront_warp_edges_match_plain_on_card(name, scan, tout, cuda_device):
    """K4's exchange at its edges (torch_cases.WAVEFRONT_WARP_CASES): the
    shuffle inside a warp, the ring between warps, the hand-off between
    groups, in both sum orders and every output type, bit-equal to the
    plain version."""
    h, w, c, rows = WAVEFRONT_WARP_CASES[name]
    om, tb = WAVEFRONT_WARP_OUTS[tout]
    img = torch.from_numpy(float_image(h, w, c, om, h * 5 + w + c)).to(cuda_device)
    got = wf.errdiff_wavefront(
        img, tb, om, out_dtype=_TORCH[tout], block_rows=rows, scan_order=scan
    )
    torch.cuda.synchronize()
    want = wf.errdiff_wavefront_reference(img, tb, om, scan_order=scan).to(_TORCH[tout])
    assert got.dtype == _TORCH[tout] and torch.equal(got, want)


@pytest.mark.cuda
def test_wavefront_forms_at_the_cell_shape_on_card(cuda_device):
    """The errdiff cell's K4 (3840x2160x3 into u8) runs the 256-thread
    instantiation at the default groups, and groups of 32 warps the
    1024-thread one; both give the same bits."""
    h, w, c = 2160, 3840, 3
    img = torch.from_numpy(float_image(h, w, c, 255.0, 29)).to(cuda_device)
    before = dict(wf.forms)
    small = wf.errdiff_wavefront(img, 0, 255.0, out_dtype=torch.uint8)
    assert wf.forms == {**before, 256: before[256] + 1}
    large = wf.errdiff_wavefront(img, 0, 255.0, out_dtype=torch.uint8, block_rows=32 * 32 // c)
    torch.cuda.synchronize()
    assert wf.forms == {256: before[256] + 1, 1024: before[1024] + 1}
    assert torch.equal(small, large)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [-1, 3])
@pytest.mark.parametrize("size", [(181, 77, 60, 33), (45, 31, 97, 70)])
def test_int8_gamma_table_every_value_on_card(size, alpha, cuda_device):
    """K1 int8 gamma reads its linearization from a shared table: every u8
    value on every lane (vh and hv), bit-equal to the plain version."""
    sw, sh, nw, nh = size
    c = 4
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True, alpha_index=alpha
    )
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, c),
        order_of(sw, sh, nw, nh), cuda_device,
        **epi_kwargs(plan, "biased", 1.0, True, alpha),
    )
    x = (torch.arange(sh * sw * c, dtype=torch.int64) * 7 % 256).to(torch.uint8)
    x = x.reshape(sh, sw * c).to(cuda_device)
    got = fk.apply_fused_int8(ops, x)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.apply_fused_int8_reference(ops, x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BANDED_CASES))
def test_banded_kernel_matches_plain_on_card(name, cuda_device):
    """K2, the row pass: f32 within max|plain| * 1e-5."""
    sw, sh, nw, nh, c, tin, mode = BANDED_CASES[name]
    ib = IN_BYTES[tin]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
    ops = bk.prepare_banded(block_banded(plan.v.op, in_bytes=ib), mode, cuda_device)
    x = torch.from_numpy(split_source(name, sh, sw, c, tin)).to(cuda_device)
    before = bk.launches[ops.launch_key]
    got = bk.apply_banded(ops, x)
    torch.cuda.synchronize()
    assert bk.launches[ops.launch_key] == before + 1
    want = bk.apply_banded_reference(ops, x)
    assert got.shape == want.shape == (nh, sw * c)
    assert (got - want).abs().max().item() <= want.abs().max().item() * 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LANES_CASES))
def test_lanes_kernel_matches_plain_on_card(name, cuda_device):
    """K3, the lane pass at the base tile: f32 within max|plain| * 1e-5."""
    sw, sh, nw, nh, c, tin, mode = LANES_CASES[name]
    ib = IN_BYTES[tin]
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], np.float32)
    lop = narrow_lop(
        plan.h.op, lane_block_banded(plan.h.op, c, in_bytes=ib), c, in_bytes=ib
    )
    ops = lk.prepare_lanes(lop, mode, cuda_device)
    x = torch.from_numpy(split_source(name, sh, sw, c, tin)).to(cuda_device)
    before = lk.launches[ops.launch_key]
    got = lk.apply_lanes(ops, x)
    torch.cuda.synchronize()
    assert lk.launches[ops.launch_key] == before + 1
    want = lk.apply_lanes_reference(ops, x)
    assert got.shape == want.shape == (sh, nw * c)
    assert (got - want).abs().max().item() <= want.abs().max().item() * 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GAMMA_PRE_CASES))
def test_gamma_prologue_and_limb_input_match_plain_on_card(name, cuda_device):
    """K5 bit-equal to its plain version; K1 int8 reading its planes
    bit-equal to its plain version and to the in-kernel gamma kernel."""
    sw, sh, nw, nh, c, tile, order, alpha = GAMMA_PRE_CASES[name]
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True,
        alpha_index=alpha,
    )
    gkw = dict(
        gamma=True, alpha_index=alpha, in_gamma_mult=plan.in_gamma_mult,
        out_gamma_mult=plan.out_gamma_mult,
    )
    vop = block_banded(plan.v.op)
    lop = lane_block_banded(plan.h.op, c, tile=tile)
    pre = fk.prepare_fused_int8(vop, lop, order, cuda_device, gamma_pre=True, **gkw)
    inkernel = fk.prepare_fused_int8(vop, lop, order, cuda_device, **gkw)
    x = torch.from_numpy(
        np.random.default_rng(sum(map(ord, name))).integers(
            0, 256, (sh, sw * c), dtype=np.uint8
        )
    ).to(cuda_device)
    args = (pre.rows_pad, pre.lanes_pad, c, alpha, plan.in_gamma_mult)
    hi, lo = gp.apply_gamma_prologue(x, *args)
    torch.cuda.synchronize()
    phi, plo = gp.apply_gamma_prologue_reference(x, *args)
    assert torch.equal(hi, phi) and torch.equal(lo, plo)
    before = fk.launches[pre.launch_key]
    got = fk.apply_fused_int8(pre, hi, lo)
    torch.cuda.synchronize()
    assert fk.launches[pre.launch_key] == before + 1
    assert torch.equal(got, fk.apply_fused_int8_reference(pre, hi, lo))
    assert torch.equal(got, fk.apply_fused_int8(inkernel, x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GAMMA_PRE_CASES))
def test_gamma_prologue_paths_match_plain_on_card(name, cuda_device):
    """K5 on both load paths (the image as allocated, and a copy at an odd
    address, which takes the byte path): each bit-equal to the plain
    version, one launch each."""
    sw, sh, nw, nh, c, tile, order, alpha = GAMMA_PRE_CASES[name]
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True,
        alpha_index=alpha,
    )
    vop = block_banded(plan.v.op)
    lop = lane_block_banded(plan.h.op, c, tile=tile)
    x = torch.from_numpy(
        np.random.default_rng(sum(map(ord, name)) + 1).integers(
            0, 256, (sh, sw * c), dtype=np.uint8
        )
    ).to(cuda_device)
    odd = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda_device)[1:]
    odd = odd.view(x.shape).copy_(x)
    assert gp.load_path(odd) == "byte"
    args = (vop.n_in_pad, lop.lanes_pad, c, alpha, plan.in_gamma_mult)
    want = gp.apply_gamma_prologue_reference(x, *args)
    for img in (x, odd):
        before = gp.launches["gamma_prologue"]
        got = gp.apply_gamma_prologue(img, *args)
        torch.cuda.synchronize()
        assert gp.launches["gamma_prologue"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _ring_case(name, device):
    """(K6 operands, K1 in-kernel gamma operands on the default blocking,
    u8 image) of a ring case."""
    sw, sh, nw, nh, c, alpha, tile, uniform = _RING[name]
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True,
        alpha_index=alpha,
    )
    gkw = dict(alpha_index=alpha, in_gamma_mult=plan.in_gamma_mult,
               out_gamma_mult=plan.out_gamma_mult)
    lop = lane_block_banded(plan.h.op, c)
    ops = fr.prepare_fused_ring(
        block_banded(plan.v.op, tile=tile, uniform=uniform), lop, device, **gkw
    )
    inkernel = fk.prepare_fused_int8(
        block_banded(plan.v.op, tile=tile), lop, "vh", device, gamma=True, **gkw
    )
    x = torch.from_numpy(
        np.random.default_rng(sum(map(ord, name))).integers(
            0, 256, (sh, sw * c), dtype=np.uint8
        )
    ).to(device)
    return ops, inkernel, x


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_RING))
def test_ring_kernel_matches_plain_and_inkernel_on_card(name, cuda_device):
    """K6 (one launch, clusters of 4 to 16 blocks) bit-equal to its plain
    version and to K1's in-kernel gamma kernel on the default blocking."""
    ops, inkernel, x = _ring_case(name, cuda_device)
    before = fr.launches[ops.launch_key]
    got = fr.apply_fused_ring(ops, x)
    torch.cuda.synchronize()
    assert fr.launches[ops.launch_key] == before + 1
    assert torch.equal(got, fr.apply_fused_ring_reference(ops, x))
    assert torch.equal(got, fk.apply_fused_int8(inkernel, x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["win8_c3_narrow", "win16_c1"])
def test_ring_kernel_repeats_bit_equal_on_card(name, cuda_device):
    """20 launches of one shape give the same bytes, at one part and at
    many (a race across the cluster barriers would show here)."""
    ops, _, x = _ring_case(name, cuda_device)
    want = fr.apply_fused_ring_reference(ops, x)
    for parts in (1, None):
        o = ops if parts is None else dataclasses.replace(
            ops, part_ptr=torch.tensor([0, ops.slices.shape[0]], dtype=torch.int32,
                                       device=cuda_device))
        for _ in range(20):
            assert torch.equal(fr.apply_fused_ring(o, x), want)


def _limb_case(sw, sh, nw, nh, c, tile, alpha, device, seed, order="vh"):
    """(limb-plane operands, in-kernel operands, u8 image, K5's planes) of
    an int8 gamma resize in pass order ``order``."""
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True,
        alpha_index=alpha,
    )
    gkw = dict(
        gamma=True, alpha_index=alpha, in_gamma_mult=plan.in_gamma_mult,
        out_gamma_mult=plan.out_gamma_mult,
    )
    vop = block_banded(plan.v.op)
    lop = lane_block_banded(plan.h.op, c, tile=tile)
    pre = fk.prepare_fused_int8(vop, lop, order, device, gamma_pre=True, **gkw)
    inkernel = fk.prepare_fused_int8(vop, lop, order, device, **gkw)
    x = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, (sh, sw * c), dtype=np.uint8)
    ).to(device)
    hi, lo = gp.apply_gamma_prologue(
        x, pre.rows_pad, pre.lanes_pad, c, alpha, plan.in_gamma_mult
    )
    return pre, inkernel, x, hi, lo


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_PRE_VH))
def test_limb_input_vh_tensor_cores_match_plain_on_card(name, cuda_device):
    """K1 int8 vh from K5's limb planes (the s8 tensor-core kernel) at the
    edges of its tiling and of its ring: bit-equal to its plain version and
    to the in-kernel gamma kernel."""
    sw, sh, nw, nh, c, tile, alpha = _PRE_VH[name]
    pre, inkernel, x, hi, lo = _limb_case(
        sw, sh, nw, nh, c, tile, alpha, cuda_device, sum(map(ord, name))
    )
    assert pre.slice_range is not None and pre.rows == 32
    before = fk.launches[pre.launch_key]
    got = fk.apply_fused_int8(pre, hi, lo)
    torch.cuda.synchronize()
    assert fk.launches[pre.launch_key] == before + 1
    assert torch.equal(got, fk.apply_fused_int8_reference(pre, hi, lo))
    assert torch.equal(got, fk.apply_fused_int8(inkernel, x))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [1, 3, 5])
def test_limb_input_vh_narrow_planes_on_card(extra, cuda_device):
    """Planes wider than the windows reach by ``extra`` lanes (a width off
    a multiple of 4 and 16: the kernel's narrow loads) give the same
    bytes."""
    pre, inkernel, x, hi, lo = _limb_case(
        1031, 517, 200, 97, 3, None, -1, cuda_device, 11
    )
    wide = [torch.nn.functional.pad(p, (0, extra)).contiguous() for p in (hi, lo)]
    got = fk.apply_fused_int8(pre, *wide)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.apply_fused_int8_reference(pre, hi, lo))
    assert torch.equal(got, fk.apply_fused_int8(inkernel, x))


@pytest.mark.cuda
def test_limb_input_vh_repeats_bit_equal_on_card(cuda_device):
    """20 launches of the limb-plane vh kernel give the same bytes."""
    pre, _, _, hi, lo = _limb_case(1031, 517, 200, 97, 4, None, 3, cuda_device, 5)
    want = fk.apply_fused_int8_reference(pre, hi, lo)
    for _ in range(20):
        assert torch.equal(fk.apply_fused_int8(pre, hi, lo), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 64, 128])
@pytest.mark.parametrize("name", list(GAMMA_PRE_HV_CASES))
def test_limb_input_hv_tensor_cores_match_plain_on_card(name, rows, cuda_device):
    """K1 int8 hv from K5's limb planes (the s8 tensor-core kernel) at every
    slice height (fk.at_rows), whatever slice_rows would pick: bit-equal to
    its plain version and to the in-kernel hv gamma kernel."""
    sw, sh, nw, nh, c, tile, alpha = GAMMA_PRE_HV_CASES[name]
    pre, inkernel, x, hi, lo = _limb_case(
        sw, sh, nw, nh, c, tile, alpha, cuda_device, sum(map(ord, name)) + rows, "hv"
    )
    try:
        ops = fk.at_rows(pre, rows)
    except ValueError:
        pytest.skip(f"{rows}-row slice ranges exceed the hv intermediate")
    before = fk.launches[ops.launch_key]
    got = fk.apply_fused_int8(ops, hi, lo)
    torch.cuda.synchronize()
    assert fk.launches[ops.launch_key] == before + 1
    assert torch.equal(got, fk.apply_fused_int8_reference(pre, hi, lo))
    assert torch.equal(got, fk.apply_fused_int8(inkernel, x))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [1, 4, 12])
def test_limb_input_hv_narrow_planes_on_card(extra, cuda_device):
    """Planes wider than the windows reach by ``extra`` lanes (a width off a
    multiple of 16: 32-bit word loads in place of cp.async, byte loads
    where it is also off 4) give the same bytes, with the alpha lane."""
    pre, inkernel, x, hi, lo = _limb_case(
        80, 60, 200, 150, 4, None, 3, cuda_device, 13, "hv"
    )
    wide = [torch.nn.functional.pad(p, (0, extra)).contiguous() for p in (hi, lo)]
    got = fk.apply_fused_int8(pre, *wide)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.apply_fused_int8_reference(pre, hi, lo))
    assert torch.equal(got, fk.apply_fused_int8(inkernel, x))


@pytest.mark.cuda
def test_limb_input_hv_repeats_bit_equal_on_card(cuda_device):
    """20 launches of the limb-plane hv kernel give the same bytes."""
    pre, _, _, hi, lo = _limb_case(150, 100, 400, 300, 3, None, -1, cuda_device, 7, "hv")
    want = fk.apply_fused_int8_reference(pre, hi, lo)
    for _ in range(20):
        assert torch.equal(fk.apply_fused_int8(pre, hi, lo), want)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2, "2+table"])
def test_hv_smem_bytes_match_the_kernel(planes, cuda_device):
    """The host's copies of the tensor-core kernels' shared-memory layouts
    (fk.hv_smem_bytes, which slice_rows reads, with one plane, two, and
    two plus the in-kernel gamma's table; fk.vh_smem_bytes of the u8, limb-
    plane and in-kernel gamma rings, each within two blocks an SM) equal the
    kernels' own (csrc: hv_mma_smem_bytes, VhMma<IN>::kBytes), and the card's SM
    shared memory is read from the device (an H100's is the value the CPU
    assumes)."""
    from avir_tpu_torch.ops.cuda.build import load_library

    table = planes == "2+table"
    planes = 2 if table else planes
    fn = load_library("fused_int8").avir_int8_mma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for kwin in (32, 64, 128, 160, 256):
        assert fk.hv_smem_bytes(kwin, planes, table) == fn(1, kwin, planes, int(table))
    assert fk.vh_smem_bytes(planes, table) == fn(0, 0, planes, int(table))
    assert fk.vh_smem_bytes(planes, table) <= fk.two_blocks_smem(fk.H100_SM_SMEM)
    props = torch.cuda.get_device_properties(cuda_device)
    assert fk._sm_smem(cuda_device) == props.shared_memory_per_multiprocessor
    if "H100" in props.name:
        assert fk._sm_smem(cuda_device) == fk.H100_SM_SMEM


def _hv_run_case(name, mode, device):
    """(operands at slice_rows' height, u8 image, the kernel's input, the
    in-kernel gamma operands or None) of an HV_RUN_CASES case in an input
    mode of HV_RUN_MODES."""
    sw, sh, nw, nh, c, alpha, _, _ = HV_RUN_CASES[name]
    gamma = mode in ("gamma", "planes")
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=gamma,
                             alpha_index=alpha if gamma else -1)
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, c)
    rm, scale = ("even", 0.75) if mode == "even_scale" else ("biased", 1.0)
    kw = epi_kwargs(plan, rm, scale, gamma, alpha)
    ops = fk.prepare_fused_int8(vop, lop, "hv", device, gamma_pre=mode == "planes", **kw)
    x = torch.from_numpy(
        np.random.default_rng(sum(map(ord, name + mode))).integers(
            0, 256, (sh, sw * c), dtype=np.uint8)
    ).to(device)
    if mode != "planes":
        return ops, x, (x,), None
    args = gp.apply_gamma_prologue(x, ops.rows_pad, ops.lanes_pad, c, alpha, plan.in_gamma_mult)
    return ops, x, args, fk.prepare_fused_int8(vop, lop, "hv", device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", HV_RUN_MODES)
@pytest.mark.parametrize("name,rows", [(n, r) for n, case in HV_RUN_CASES.items()
                                       for r in case[7]])
def test_int8_hv_runs_match_plain_on_card(name, rows, mode, cuda_device):
    """K1 int8 hv walking runs of tiles (or one tile a block) in every
    input mode at every slice height it takes: bit-equal to the
    plain version (and, from K5's limb planes, to the in-kernel gamma
    kernel), one launch counted under its pipeline form, the form at
    slice_rows' height the one HV_RUN_CASES records for an H100."""
    ops, x, args, inkernel = _hv_run_case(name, mode, cuda_device)
    if rows == ops.rows and torch.cuda.get_device_properties(
            cuda_device).multi_processor_count == 132:
        assert ops.hv_form == HV_RUN_CASES[name][6]
    ops = fk.at_rows(ops, rows)
    assert ops.blocks == fk.hv_blocks(
        ops.n_tiles, ops.kwin, fk._sm_count(cuda_device), planes=2 if ops.epi.gamma else 1,
        table=ops.epi.gamma and not ops.gamma_pre, sm_smem=fk._sm_smem(cuda_device))
    before = dict(fk.hv_forms)
    got = fk.apply_fused_int8(ops, *args)
    torch.cuda.synchronize()
    assert fk.hv_forms[ops.hv_form] == before[ops.hv_form] + 1
    assert sum(fk.hv_forms.values()) == sum(before.values()) + 1
    assert torch.equal(got, fk.apply_fused_int8_reference(ops, *args))
    if inkernel is not None:
        assert torch.equal(got, fk.apply_fused_int8(fk.at_rows(inkernel, rows), x))


@pytest.mark.cuda
def test_int8_hv_runs_repeat_bit_equal_on_card(cuda_device):
    """20 launches of the u8 hv kernel on runs of tiles at 1080p -> 4K give
    the same bytes: a buffer refilled for the next window before every
    warp is done with it would show here."""
    ops, _, args, _ = _hv_run_case("runs_1080p_c3", "u8", cuda_device)
    assert ops.hv_form == "runs" or fk._sm_count(cuda_device) * 2 >= ops.n_tiles
    want = fk.apply_fused_int8(ops, *args)
    for _ in range(20):
        assert torch.equal(fk.apply_fused_int8(ops, *args), want)

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_planar_kernels_match_plain_on_card(name, cuda_device):
    """K7 on ``deinterleave``'s planes and K8 on the interleaved image (by
    its raw span tile where the case allows one, and by strided loads from
    an unaligned copy), each within the split gate of its plain version
    (``split2_tol``)."""
    sw, sh, nw, nh, c, tin, tout, mv, mh, tb, g, alpha = PLANAR_CASES[name]
    out_max = 65535.0 if tout == "u16" else 255.0
    plan = build_resize_plan(
        sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout],
        res_bit_depth=16 if tout == "u16" else 8, use_srgb_gamma=g, alpha_index=alpha,
    )
    vop, pop = block_banded(plan.v.op), lane_block_banded(plan.h.op, 1)
    kw = dict(mode_v=mv, mode_h=mh, out_dtype=_TORCH[tout], out_max=out_max,
              trunc_bits=tb)
    if g:
        kw.update(gamma=True, in_gamma_mult=plan.in_gamma_mult,
                  out_gamma_mult=plan.out_gamma_mult)
    x = torch.from_numpy(split_source(name, sh, sw, c, tin)).to(cuda_device)
    xp = pk.deinterleave(x, sh, sw, c, pk.plane_stride(vop), plane_width(name, sw, pop.lanes_pad))
    runs = [(pk, pk.prepare_planar(vop, pop, c, cuda_device, alpha_plane=alpha, **kw),
             xp, pk.apply_planar, pk.apply_planar_reference)]
    k8 = p2.prepare_planar2(vop, pop, c, cuda_device, alpha_index=alpha, **kw)
    runs += [(p2, k8, src, p2.apply_planar2, p2.apply_planar2_reference)
             for src in (x, unaligned_copy(x))]
    xmax = x.double().abs().max().item()
    for mod, ops, src, apply, plain in runs:
        before = mod.launches[ops.launch_key]
        got = apply(ops, src)
        torch.cuda.synchronize()
        assert mod.launches[ops.launch_key] == before + 1
        want = plain(ops, src)
        assert got.shape == want.shape == ops.out_shape
        diff = (got.double() - want.double()).abs().max().item()
        ref_max = want.double().abs().max().item()
        tol = split2_tol(ops, tout, ref_max, xmax, out_max, tb, g)
        assert diff <= tol, (ops.launch_key, pk.raw_row_bytes(ops, src), diff, tol)


# ---------------------------------------------------------------------------
# The public API beyond resize: batch staging, device functions,
# errdiff-device (K4 in the sequential scan's sum order), lane subsets
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("h, w, c, tb, om", WAVEFRONT_CASES)
def test_wavefront_sum_orders_match_plain_on_card(h, w, c, tb, om, scan, cuda_device):
    img = torch.from_numpy(float_image(h, w, c, om, h * 3 + w)).to(cuda_device)
    for rows in (None, 3):
        got = wf.errdiff_wavefront(img, tb, om, block_rows=rows, scan_order=scan)
        torch.cuda.synchronize()
        want = wf.errdiff_wavefront_reference(
            img, tb, om, block_rows=rows, scan_order=scan
        )
        assert torch.equal(got, want)


def _frames(n, h, w, c, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random((n, h, w, c), dtype=np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, (n, h, w, c), dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw, dtype, c",
    [
        ({}, np.uint8, 3),
        ({"res_bit_depth": 16}, np.uint16, 3),
        ({"dither": "errdiff"}, np.uint8, 4),
        ({"out_dtype": np.float32}, np.float32, 5),
    ],
)
def test_resize_batch_equals_single_resizes_on_card(kw, dtype, c, cuda_device):
    """Each frame of resize_batch is resize of that frame, bit for bit; the
    kernels launch once per frame; the pinned staging buffers of the first
    call are the ones of the second."""
    import avir_tpu_torch

    frames = _frames(5, 67, 93, c, dtype, c)
    kw = dict(kw)
    rz = avir_tpu_torch.ImageResizer(res_bit_depth=kw.pop("res_bit_depth", 8))
    singles = np.stack([rz.resize(f, 61, 41, **kw) for f in frames])
    got = rz.resize_batch(frames, 61, 41, **kw)
    np.testing.assert_array_equal(got, singles)
    runner = rz._cache.get_or_build(
        ("batch",) + rz._route(67, 93, c, np.dtype(dtype), 61, 41, **kw).key,
        lambda: None,
    )
    ptrs = [t.data_ptr() for ts in runner.staging.values() for t in ts]
    assert all(t.is_pinned() for t in runner.staging["in_host"] + runner.staging["out_host"])
    out = np.empty_like(singles)
    assert rz.resize_batch(frames[::-1], 61, 41, out=out, **kw) is out
    np.testing.assert_array_equal(out, singles[::-1])
    assert [t.data_ptr() for ts in runner.staging.values() for t in ts] == ptrs


@pytest.mark.cuda
def test_lancir_resize_batch_on_card(cuda_device):
    import avir_tpu_torch

    frames = _frames(3, 80, 120, 3, np.uint8, 9)
    lz = avir_tpu_torch.LancIR()
    got = lz.resize_batch(frames, 50, 30)
    for i in range(3):
        np.testing.assert_array_equal(got[i], lz.resize(frames[i], 50, 30))


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True])
def test_make_resize_fn_on_card(flat, cuda_device):
    """A function on CUDA tensors: no host synchronisation (sync debug mode
    "error"), one K1 launch, a CUDA tensor out, resize's bits."""
    import avir_tpu_torch

    src = _frames(1, 90, 120, 3, np.uint8, 2)[0]
    fn = avir_tpu_torch.make_resize_fn((90, 120, 3), np.uint8, 50, 40, flat=flat)
    x = torch.from_numpy(src.reshape(90, -1) if flat else src).to(cuda_device)
    fn(x)  # the kernel's library loads on the first call
    torch.cuda.synchronize()
    before = dict(fk.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = fn(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert y.is_cuda
    assert sum(fk.launches.values()) - sum(before.values()) == 1
    want = avir_tpu_torch.resize(src, 50, 40)
    np.testing.assert_array_equal(y.cpu().numpy().reshape(want.shape), want)


@pytest.mark.cuda
def test_make_lancir_resize_fn_on_card(cuda_device):
    import avir_tpu_torch

    src = _frames(1, 90, 120, 3, np.uint8, 3)[0]
    fn = avir_tpu_torch.make_lancir_resize_fn((90, 120, 3), np.uint8, 50, 40)
    y = fn(torch.from_numpy(src).to(cuda_device))
    assert y.is_cuda
    np.testing.assert_array_equal(y.cpu().numpy(), avir_tpu_torch.lancir_resize(src, 50, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, bits", [(np.uint8, 8), (np.uint16, 16)])
def test_errdiff_device_runs_k4_once_on_card(dtype, bits, cuda_device):
    """dither="errdiff-device" launches K4 once, in the sequential scan's
    sum order: bit-equal to the plain version of that order on the same
    pre-dither image, within one step of dither="errdiff"."""
    import avir_tpu_torch

    src = _frames(1, 60, 80, 3, dtype, 4)[0]
    rz = avir_tpu_torch.ImageResizer(res_bit_depth=bits)
    rz.resize(src, 96, 72, dither="errdiff-device")
    before = wf.launches["wavefront"]
    got = rz.resize(src, 96, 72, dither="errdiff-device")
    assert wf.launches["wavefront"] == before + 1
    pre = rz._route(60, 80, 3, np.dtype(dtype), 96, 72, dither=lambda *a: a[0]).fn(
        torch.from_numpy(src.reshape(60, -1)).to(cuda_device)
    )
    om = 255.0 if dtype == np.uint8 else 65535.0
    want = wf.errdiff_wavefront_reference(
        pre.reshape(72, 96, 3), 0, om, scan_order=True
    ).cpu().numpy()
    np.testing.assert_array_equal(got, want.astype(dtype))
    other = rz.resize(src, 96, 72, dither="errdiff")
    assert np.abs(got.astype(np.int64) - other.astype(np.int64)).max() <= 1


@pytest.mark.cuda
def test_lane_subset_operator_on_card(cuda_device):
    """A zoom whose windows end before the image does (85x60 -> 19x88 at
    k=0.2836, float in, u16 out): the card within the split gate of the
    plain version."""
    import avir_tpu_torch

    src = np.random.default_rng(8).random((60, 85, 2), dtype=np.float32)
    kw = dict(k=0.2836, ox=0.711, oy=-1.365, out_dtype=np.uint16)
    rz = avir_tpu_torch.ImageResizer(
        res_bit_depth=16, params=avir_tpu_torch.preset("high")
    )
    got = rz.resize(src, 19, 88, **kw)
    want = rz.resize(src, 19, 88, device="cpu", **kw)
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["int8", "split", "int8_overlap"])
@pytest.mark.parametrize("d", range(4))
def test_sharded_strip_kernels_match_plain_on_card(route, d, cuda_device):
    """Rank d's strip of a 4-rank row mesh (parallel/sharded.py) on the
    card: each K1 launch of its strip body (K1 int8 vh, or split vh at
    precision="fast"; with halo_overlap the border, interior and border
    launches) against its plain version on the same ext buffer or strip,
    int8 bit-equal, split within 1 LSB; and the strip's rows the same on
    the card as on the CPU (split: within 1 LSB)."""
    from avir_tpu_torch.parallel import sharded
    from avir_tpu_torch.parallel.multihost import DpSpMesh

    sw, sh, nw, nh = (32, 1536, 16, 768) if route == "int8_overlap" else (96, 256, 64, 160)
    plan = build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8)
    kw = dict(
        int8={}, split=dict(precision="fast"),
        int8_overlap=dict(pallas_tile=64, halo_overlap=True),
    )[route]
    fns = {
        dev: sharded.make_sharded_avir_executor(
            plan, DpSpMesh(1, 4, 0, d, None, None, torch.device(dev)), **kw
        )
        for dev in (cuda_device, "cpu")
    }
    fn = fns[cuda_device]
    assert fn.route == route.split("_")[0]
    flat = torch.from_numpy(
        np.random.default_rng(10 + d).integers(0, 256, (sh, sw * 3), dtype=np.uint8)
    )
    sv = fn.svop
    x = flat[d * sv.strip : (d + 1) * sv.strip].contiguous()
    halos = sharded.halo_rows(flat, sv, d)
    ext = fn.strip.ext(x, *halos)
    assert len(fn.strip.parts) == (3 if route == "int8_overlap" else 1)
    for ops, on_ext in fn.strip.parts:
        inp = (ext if on_ext else x).to(cuda_device)
        if route == "split":
            got = fs.apply_fused_split(ops, inp)
            want = fs.apply_fused_split_reference(ops, inp)
            assert (got.int() - want.int()).abs().max().item() <= 1
        else:
            got = fk.apply_fused_int8(ops, inp)
            assert torch.equal(got, fk.apply_fused_int8_reference(ops, inp))
    rows = fn.strip(x.to(cuda_device), *(h.to(cuda_device) for h in halos))
    plain = fns["cpu"].strip(x, *halos)
    assert (rows.cpu().int() - plain.int()).abs().max().item() <= (route == "split")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int8_2x2", "split_2x2", "int8_overlap", "int8_odd_1x4", "gamma_rgba"])
def test_sharded_tile_kernels_match_plain_on_card(case, cuda_device):
    """Every tile of a 4-rank 2-D mesh (parallel/sharded.py) on the card:
    each K1 launch of its tile body (int8 vh, split vh at precision="fast",
    the three launches of halo_overlap, tiles whose lanes are no multiple
    of 16, int8 vh gamma with the alpha bypass) against its plain version
    on the same tile, int8 bit-equal, split within 1 LSB; and the tile's
    output the same on the card as on the CPU (split: within 1 LSB)."""
    from avir_tpu_torch.parallel import sharded
    from avir_tpu_torch.parallel.multihost import DpSpCpMesh

    (sw, sh, nw, nh, c), plan_kw, kw, (sp, cp) = {
        "int8_2x2": ((256, 192, 128, 96, 3), {}, {}, (2, 2)),
        "split_2x2": ((256, 192, 128, 96, 3), {}, dict(precision="fast"), (2, 2)),
        "int8_overlap": ((1200, 400, 600, 200, 3), {}, dict(pallas_tile=32, halo_overlap=True), (2, 2)),
        "int8_odd_1x4": ((70, 90, 50, 62, 3), {}, {}, (1, 4)),
        "gamma_rgba": ((70, 90, 50, 62, 4), dict(use_srgb_gamma=True, alpha_index=3), {}, (2, 2)),
    }[case]
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, **plan_kw)
    src = np.random.default_rng(20).integers(0, 256, (sh, sw * c), dtype=np.uint8)
    flat = sharded.pad_cols(sharded.pad_rows(src, sp), cp, c)
    for i in range(sp):
        for j in range(cp):
            fns = {
                dev: sharded.make_sharded_avir_executor_2d(
                    plan, DpSpCpMesh(1, sp, cp, 0, i, j, None, None, None, torch.device(dev)), **kw
                )
                for dev in (cuda_device, "cpu")
            }
            fn = fns[cuda_device]
            assert fn.route == case.split("_")[0].replace("gamma", "int8")
            tiles = [torch.from_numpy(t) for t in sharded.halo_tiles(flat, fn.svop, fn.slb, i, j)]
            on_card = dict(zip(("x", "xc", "ext"), (t.to(cuda_device) for t in tiles)))
            assert len(fn.tile.parts) == (3 if case == "int8_overlap" else 1)
            for ops, on in fn.tile.parts:
                inp = on_card[on]
                if fn.route == "split":
                    got = fs.apply_fused_split(ops, inp)
                    want = fs.apply_fused_split_reference(ops, inp)
                    assert (got.int() - want.int()).abs().max().item() <= 1
                else:
                    got = fk.apply_fused_int8(ops, inp)
                    assert torch.equal(got, fk.apply_fused_int8_reference(ops, inp)), (i, j, on)
            out = fn.tile.compute(*on_card.values())
            plain = fns["cpu"].tile.compute(*tiles)
            assert (out.cpu().int() - plain.int()).abs().max().item() <= (fn.route == "split")
