"""The planar kernels of the port (K7, ops/cuda/planar.py, and K8,
ops/cuda/planar2.py) against the JAX package on the CPU.  The JAX
package's Pallas kernels run in interpret mode; the port runs its kernels'
plain versions.  The kernels themselves are held against their plain
versions on the card only (tests/test_torch_cuda.py).

Tolerances: the layout helpers and the operators are equal.  The resizes
are the split-bf16 modes, whose inter-pass bf16 re-split is not
bit-stable across summation orders (the split gate of ROADMAP.md):
float32 within max|ref| * 1e-4; integers within 1 LSB (one quantization
step with ``trunc_bits``); 16-bit output through gamma-out within
max * 1e-4 of its range plus one step.  Float32 output after a split2
second pass adds one bf16 ulp of the intermediate times the H taps'
absolute sum (``torch_cases.split2_tol``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import xorshift128_fill

from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.lanes import lane_block_banded as jax_lane_block_banded
from avir_tpu.ops.pallas import planar2_kernel as jax_p2
from avir_tpu.ops.pallas import planar_kernel as jax_pk
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from torch_cases import NP_TYPES, PLANAR_CASES, plane_width, split2_tol, unaligned_copy

from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import planar as pk
from avir_tpu_torch.ops.cuda import planar2 as p2
from avir_tpu_torch.ops.lanes import lane_block_banded
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)

_JAX = {"u8": jnp.uint8, "u16": jnp.uint16, "f32": jnp.float32}
_TORCH = {"u8": torch.uint8, "u16": torch.uint16, "f32": torch.float32}


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _case(name):
    """(case, both plans, the image [sh, sw*c], the port's V and dense H
    operators, the JAX package's, and each side's keyword arguments)."""
    sw, sh, nw, nh, c, tin, tout, mv, mh, tb, g, alpha = case = PLANAR_CASES[name]
    bits = 16 if tout == "u16" else 8
    kw = dict(res_bit_depth=bits, use_srgb_gamma=g, alpha_index=alpha)
    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout], **kw)
    plan = build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout], **kw)
    seed = sum(map(ord, name))
    if tin == "f32":
        x = np.random.default_rng(seed).random((sh, sw * c), dtype=np.float32)
    else:
        x = xorshift128_fill((sh, sw * c), NP_TYPES[tin], seed)
    out_max = 65535.0 if tout == "u16" else 255.0
    common = dict(out_max=out_max, trunc_bits=tb)
    gk = dict(gamma=True, in_gamma_mult=plan.in_gamma_mult,
              out_gamma_mult=plan.out_gamma_mult) if g else {}
    jgk = dict(gamma=True, in_gamma_mult=jplan.in_gamma_mult,
               out_gamma_mult=jplan.out_gamma_mult) if g else {}
    ours = (block_banded(plan.v.op), lane_block_banded(plan.h.op, 1),
            dict(mode_v=mv, mode_h=mh, out_dtype=_TORCH[tout], **common, **gk))
    theirs = (jax_block_banded(jplan.v.op), jax_lane_block_banded(jplan.h.op, 1),
              dict(mode_v=mv, mode_h=mh, out_dtype=_JAX[tout], **common, **jgk))
    return case, x, ours, theirs


def _check(got, ref, case, ops, x):
    *_, tout, _, _, tb, g, _ = case
    out_max = 65535.0 if tout == "u16" else 255.0
    assert got.shape == ref.shape
    ref_max = float(np.abs(ref.astype(np.float64)).max())
    diff = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max())
    tol = split2_tol(ops, tout, ref_max, float(np.abs(x).max()), out_max, tb, g)
    assert diff <= tol, diff


def test_planar_layout_helpers_match_jax():
    """plane_stride, deinterleave, reinterleave and regroup_channels."""
    (sw, sh, nw, nh, c, *_), x, (vop, pop, _), (jvop, jpop, _) = _case("down_c3_u8_u8")
    hp = pk.plane_stride(vop)
    assert hp == jax_pk.plane_stride(jvop) and hp % 32 == 0
    wp = max(sw, pop.lanes_pad)
    xp = pk.deinterleave(torch.from_numpy(x), sh, sw, c, hp, wp)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(jax_pk.deinterleave(jnp.asarray(x), sh, sw, c, hp, wp))
    )
    bv_tv = vop.n_blocks * vop.tile
    planar = np.arange(c * bv_tv * 2 * pop.tile, dtype=np.float32).reshape(c * bv_tv, -1)
    np.testing.assert_array_equal(
        pk.reinterleave(torch.from_numpy(planar), c, bv_tv, nh, nw).numpy(),
        np.asarray(jax_pk.reinterleave(jnp.asarray(planar), c, bv_tv, nh, nw)),
    )
    grouped = planar.reshape(bv_tv, -1)
    np.testing.assert_array_equal(
        p2.regroup_channels(torch.from_numpy(grouped), c, pop.tile, nh, nw).numpy(),
        np.asarray(jax_p2.regroup_channels(jnp.asarray(grouped), c, pop.tile, nh, nw)),
    )


@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_dense_lane_operator_and_budgets_match_jax(name):
    """The dense H operator ``lane_block_banded(op, 1)`` and the reference's
    VMEM budgets ``planar_viable`` / ``planar2_viable``."""
    (*_, c, _, _, _, _, _, _, _), _, (vop, pop, _), (jvop, jpop, _) = _case(name)
    for f in ("n_in", "n_out", "c", "tile", "win_l", "lanes_pad", "chunk_rel", "win_c"):
        assert getattr(pop, f) == getattr(jpop, f), f
    np.testing.assert_array_equal(pop.offs_l, np.asarray(jpop.offs_l))
    for t, j in ((pop.taps_hi, jpop.taps_hi), (pop.taps_lo, jpop.taps_lo)):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    assert pk.planar_viable(vop, pop) == jax_pk.planar_viable(jvop, jpop)
    assert p2.planar2_viable(vop, pop, c) == jax_p2.planar2_viable(jvop, jpop, c)


@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_planar_plain_matches_pallas(name):
    """K7's plain version against interpret-mode ``apply_planar_pallas``
    on the planes ``deinterleave`` makes."""
    case, x, (vop, pop, kw), (jvop, jpop, jkw) = _case(name)
    sw, sh, nw, nh, c, *_, alpha = case
    hp, wp = pk.plane_stride(vop), plane_width(name, sw, pop.lanes_pad)
    xp = pk.deinterleave(torch.from_numpy(x), sh, sw, c, hp, wp)
    ops = pk.prepare_planar(vop, pop, c, "cpu", alpha_plane=alpha, **kw)
    before = pk.launches["planar"]
    got = pk.apply_planar(ops, xp).numpy()
    assert pk.launches["planar"] == before  # no kernel on the CPU
    ref = np.asarray(jax_pk.apply_planar_pallas(
        jvop, jpop, jnp.asarray(xp.numpy()), c, alpha_plane=alpha, interpret=True, **jkw
    ))
    assert got.shape == ops.out_shape == (c * vop.n_blocks * vop.tile, pop.n_blocks * pop.tile)
    _check(got, ref, case, ops, x)


@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_planar2_plain_matches_pallas(name):
    """K8's plain version against interpret-mode ``apply_planar2_pallas``
    on the interleaved image, and, re-interleaved, equal to K7's where the
    two take the same alpha channel past gamma-in (none, or alpha 0 or 3
    at C = 4)."""
    case, x, (vop, pop, kw), (jvop, jpop, jkw) = _case(name)
    sw, sh, nw, nh, c, *_, alpha = case
    ops = p2.prepare_planar2(vop, pop, c, "cpu", alpha_index=alpha, **kw)
    before = p2.launches["planar2"]
    got = p2.apply_planar2(ops, torch.from_numpy(x)).numpy()
    assert p2.launches["planar2"] == before
    ref = np.asarray(jax_p2.apply_planar2_pallas(
        jvop, jpop, jnp.asarray(x), c, alpha_index=alpha, interpret=True, **jkw
    ))
    assert got.shape == ops.out_shape == (vop.n_blocks * vop.tile, pop.n_blocks * c * pop.tile)
    _check(got, ref, case, ops, x)

    if ops.alpha >= 0 and not (c == 4 and ops.alpha in (0, 3)):
        return
    hp, wp = pk.plane_stride(vop), plane_width(name, sw, pop.lanes_pad)
    k7 = pk.apply_planar(
        pk.prepare_planar(vop, pop, c, "cpu", alpha_plane=alpha, **kw),
        pk.deinterleave(torch.from_numpy(x), sh, sw, c, hp, wp),
    )
    np.testing.assert_array_equal(
        p2.regroup_channels(torch.from_numpy(got), c, pop.tile, nh, nw).numpy(),
        pk.reinterleave(k7, c, vop.n_blocks * vop.tile, nh, nw).numpy(),
    )


@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_planar_k_range_at_the_slice_height(name):
    """The kernel's k_range: per ``ROWS``-row slice of each V block, a
    32-aligned range of window rows that holds every nonzero tap of the
    slice (the kernel's first pass runs over it and nothing else)."""
    case, _, (vop, pop, kw), _ = _case(name)
    ops = pk.prepare_planar(vop, pop, case[4], "cpu", **kw)
    rows = pk.ROWS
    bv, tv, wv = vop.taps_hi.shape
    kr = ops.k_range.numpy()
    assert kr.shape == (bv, -(-tv // rows), 2)
    assert (kr % 32 == 0).all() and (kr[..., 1] <= wv).all()
    nz = ((vop.taps_hi != 0) | (vop.taps_lo != 0)).numpy()
    for b in range(bv):
        for sl in range(kr.shape[1]):
            cols = np.flatnonzero(nz[b, sl * rows : (sl + 1) * rows].any(axis=0))
            lo, hi = kr[b, sl]
            assert cols.size == 0 or (lo <= cols.min() and cols.max() < hi), (b, sl)


@pytest.mark.parametrize(
    "c, dtype, width, ld",
    [(3, torch.uint8, 80, 400), (6, torch.uint8, 16, 784), (7, torch.uint8, 16, 0),
     (3, torch.uint16, 8, 784), (4, torch.uint16, 8, 0), (1, torch.float32, 4, 528),
     (2, torch.float32, 4, 0), (3, torch.uint8, 77, 0)],
)
def test_k8_raw_span_tile_where_it_fits(c, dtype, width, ld):
    """K8's raw span tile: a 128-pixel span of all channels plus a 16-byte
    lead a row, used where 32 rows fit RAW_TILE_BYTES and the rows (width
    pixels of C channels) and the base are 16-byte aligned; never for K7."""
    _, _, (vop, pop, kw), _ = _case("down_c3_u8_u8")
    kw = dict(kw, out_dtype=torch.float32)
    x = torch.zeros((4, width * c), dtype=dtype)
    k8 = p2.prepare_planar2(vop, pop, c, "cpu", **kw)
    assert pk.raw_row_bytes(k8, x) == ld and 32 * ld <= pk.RAW_TILE_BYTES
    assert pk.raw_row_bytes(k8, unaligned_copy(x)) == 0
    assert pk.raw_row_bytes(pk.prepare_planar(vop, pop, c, "cpu", **kw), x) == 0


def test_planar_operands_check_their_arguments():
    _, x, (vop, pop, kw), _ = _case("down_c3_u8_u8")
    with pytest.raises(ValueError, match="split2/split3"):
        pk.prepare_planar(vop, pop, 3, "cpu", mode_v="exact")
    with pytest.raises(ValueError, match="dense lane form"):
        pk.prepare_planar(vop, lane_block_banded(_plan_h("down_c3_u8_u8"), 3), 3, "cpu")
    ops = pk.prepare_planar(vop, pop, 3, "cpu", **kw)
    with pytest.raises(ValueError, match="K8"):
        pk.apply_planar(p2.prepare_planar2(vop, pop, 3, "cpu", **kw), torch.from_numpy(x))
    with pytest.raises(ValueError, match="K7"):
        p2.apply_planar2(ops, torch.from_numpy(x))


def _plan_h(name):
    sw, sh, nw, nh, c, tin, tout, *_ = PLANAR_CASES[name]
    return build_resize_plan(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout]).h.op
