"""The shift-ring gamma route of the port (K6, ops/cuda/fused_ring.py) and
the uniform blocking it runs on, against the JAX package on the CPU.  The
JAX package's Pallas kernels run in interpret mode; the port runs its
kernels' plain versions.  The kernel itself is held against its plain
version on the card only (tests/test_torch_cuda.py).

Every comparison of outputs is bit-equal: the ring route computes the same
exact integer sums as K1's int8 gamma route, whose rounding steps the
port repeats step for step (ops/gamma.py)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import xorshift128_fill

import avir_tpu
from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.lanes import lane_block_banded as jax_lane_block_banded
from avir_tpu.ops.pallas import fused_ring_kernel as jax_ring
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from torch_cases import RING_CASES

from avir_tpu_torch.models import runtime
from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import fused_kernel as fk
from avir_tpu_torch.ops.cuda import fused_ring as fr
from avir_tpu_torch.ops.lanes import lane_block_banded
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)

# The two shapes of the reference's ring route table (runtime.py:388-395
# there), u8 RGB with gamma: only their operators are built here.
FULL_SIZE = {"8k_to_1080p": (7680, 4320, 1920, 1080), "4k_to_720p": (3840, 2160, 1280, 720)}


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _plans(sw, sh, nw, nh, c, alpha):
    kw = dict(use_srgb_gamma=True, alpha_index=alpha)
    return (
        jax_build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, **kw),
        build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8, **kw),
    )


def _ring_ops(plan, c, tile, uniform):
    vop = block_banded(plan.v.op, tile=tile, uniform=uniform)
    lop = lane_block_banded(plan.h.op, c)
    return vop, lop


def _assert_same_blocking(ours, theirs):
    for f in ("n_in", "n_out", "n_in_pad", "tile", "win", "q_shift", "q_abs1",
              "q_abs0", "pad_top"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.l1_max == theirs.l1_max
    np.testing.assert_array_equal(ours.offs, np.asarray(theirs.offs))
    np.testing.assert_array_equal(ours.taps, np.asarray(theirs.taps))
    np.testing.assert_array_equal(ours.taps_q1, np.asarray(theirs.taps_q1))
    np.testing.assert_array_equal(ours.taps_q0, np.asarray(theirs.taps_q0))
    for t, j in ((ours.taps_hi, theirs.taps_hi), (ours.taps_lo, theirs.taps_lo)):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("name", list(RING_CASES))
def test_uniform_blocking_matches_jax(name):
    """The case's ring operator, and its uniform blocking (or the same
    refusal), equal to the JAX package's."""
    sw, sh, nw, nh, c, alpha, tile, uniform = RING_CASES[name]
    jplan, plan = _plans(sw, sh, nw, nh, c, alpha)
    ours = block_banded(plan.v.op, tile=tile, uniform=uniform)
    theirs = jax_block_banded(jplan.v.op, tile=tile, uniform=uniform)
    _assert_same_blocking(ours, theirs)
    assert fr.uniform_delta(ours.offs) == jax_ring.uniform_delta(theirs.offs) > 0
    try:
        ours = block_banded(plan.v.op, tile=tile, uniform=True)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            jax_block_banded(jplan.v.op, tile=tile, uniform=True)
        return
    _assert_same_blocking(ours, jax_block_banded(jplan.v.op, tile=tile, uniform=True))


@pytest.mark.parametrize("name", list(FULL_SIZE))
def test_uniform_blocking_full_size_geometry(name):
    """The ring operators of the two full-size shapes, on the host only:
    8K -> 1080p [17, 64, 384], delta 256, n_pre 1, pad_top 64, n_in_pad
    4480 with the lane operator [15, 1792, 384] chunked [15, 3, 1024, 128];
    4K -> 720p [12, 64, 256], delta 192, n_pre 1, pad_top 32."""
    sw, sh, nw, nh = FULL_SIZE[name]
    jplan, plan = _plans(sw, sh, nw, nh, 3, -1)
    ours = block_banded(plan.v.op, uniform=True)
    _assert_same_blocking(ours, jax_block_banded(jplan.v.op, uniform=True))
    delta = fr.uniform_delta(ours.offs)
    n_pre = fr.n_preload(ours.win, delta)
    if name == "8k_to_1080p":
        assert tuple(ours.taps_hi.shape) == (17, 64, 384)
        assert (delta, n_pre, ours.pad_top, ours.n_in_pad) == (256, 1, 64, 4480)
        lop = lane_block_banded(plan.h.op, 3)
        assert tuple(lop.taps_hi.shape) == (15, 1792, 384)
        assert lop.ctaps_q1.shape == (15, 3, 1024, 128)
    else:
        assert tuple(ours.taps_hi.shape) == (12, 64, 256)
        assert (delta, n_pre, ours.pad_top) == (192, 1, 32)
    assert fr.ring_viable(ours, lane_block_banded(plan.h.op, 3), True, "vh")


@pytest.mark.parametrize("size, match", [
    ((100, 60, 50, 30), ">= 2 blocks"),
    ((100, 1000, 100, 333), "non-uniform stride"),
    ((100, 1000, 100, 800), "positive multiple of 32"),
])
def test_uniform_blocking_refuses_as_jax_does(size, match):
    sw, sh, nw, nh = size
    plan = build_resize_plan(sw, sh, nw, nh, 1, np.uint8, np.uint8)
    jplan = jax_build_resize_plan(sw, sh, nw, nh, 1, np.uint8, np.uint8)
    with pytest.raises(ValueError, match=match):
        block_banded(plan.v.op, uniform=True)
    with pytest.raises(ValueError, match=match):
        jax_block_banded(jplan.v.op, uniform=True)


@pytest.mark.parametrize("name", list(RING_CASES) + ["upsize"])
def test_ring_checks_match_jax(name):
    """ring_viable, uniform_delta and n_preload on the ring operators and
    on the default blocking, for both pass orders, with and without
    gamma."""
    if name in RING_CASES:
        sw, sh, nw, nh, c, alpha, tile, uniform = RING_CASES[name]
    else:
        sw, sh, nw, nh, c, alpha, tile, uniform = 80, 60, 200, 150, 3, -1, None, False
    jplan, plan = _plans(sw, sh, nw, nh, c, alpha)
    for uni in {False, uniform}:
        try:
            vop = block_banded(plan.v.op, tile=tile, uniform=uni)
        except ValueError:
            continue
        jvop = jax_block_banded(jplan.v.op, tile=tile, uniform=uni)
        lop = lane_block_banded(plan.h.op, c)
        jlop = jax_lane_block_banded(jplan.h.op, c)
        delta = fr.uniform_delta(vop.offs)
        assert delta == jax_ring.uniform_delta(jvop.offs)
        if delta:
            assert fr.n_preload(vop.win, delta) == jax_ring.n_preload(jvop.win, delta)
        for gamma in (True, False):
            for order in ("vh", "hv"):
                assert fr.ring_viable(vop, lop, gamma, order) == jax_ring.ring_viable(
                    jvop, jlop, gamma, order
                )


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_plain_matches_pallas_and_inkernel(name):
    """K6's plain version is bit-equal to interpret-mode
    ``apply_fused_ring_pallas`` and to the port's in-kernel int8 gamma
    route on the default blocking (the reference's own test,
    tests/test_pallas_kernel.py:844-891)."""
    sw, sh, nw, nh, c, alpha, tile, uniform = RING_CASES[name]
    jplan, plan = _plans(sw, sh, nw, nh, c, alpha)
    vop, lop = _ring_ops(plan, c, tile, uniform)
    gkw = dict(alpha_index=alpha, in_gamma_mult=plan.in_gamma_mult,
               out_gamma_mult=plan.out_gamma_mult)
    ops = fr.prepare_fused_ring(vop, lop, "cpu", **gkw)
    assert ops.pad_top == vop.pad_top and (ops.pad_top > 0) == uniform
    x = xorshift128_fill((sh, sw * c), np.uint8, sum(map(ord, name)))
    before = fr.launches["fused_ring_vh_gamma"]
    got = fr.apply_fused_ring(ops, torch.from_numpy(x)).numpy()
    assert fr.launches["fused_ring_vh_gamma"] == before  # no kernel on the CPU
    assert got.shape == (nh, nw * c)

    inkernel = fk.prepare_fused_int8(
        block_banded(plan.v.op, tile=tile), lop, "vh", "cpu", gamma=True, **gkw
    )
    np.testing.assert_array_equal(got, fk.apply_fused_int8(inkernel, torch.from_numpy(x)).numpy())

    jvop = jax_block_banded(jplan.v.op, tile=tile, uniform=uniform)
    jlop = jax_lane_block_banded(jplan.h.op, c)
    ref = np.asarray(jax_ring.apply_fused_ring_pallas(
        jvop, jlop, jnp.asarray(x), out_dtype=jnp.uint8, alpha_index=jplan.alpha_index,
        in_gamma_mult=jplan.in_gamma_mult, out_gamma_mult=jplan.out_gamma_mult,
        interpret=True,
    ))[:nh, : nw * c]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_schedule_covers_every_slice(name):
    """The kernel's schedule: every active slice is in exactly one part,
    in order; its tap rows fit the ring; every input segment the lane
    chunks' nonzero taps reach is swept by one column of blocks."""
    sw, sh, nw, nh, c, alpha, tile, uniform = RING_CASES[name]
    _, plan = _plans(sw, sh, nw, nh, c, alpha)
    ops = fr.prepare_fused_ring(*_ring_ops(plan, c, tile, uniform), "cpu", parts=2)
    part_ptr, slices, segs = (t.tolist() for t in (ops.part_ptr, ops.slices, ops.segs))
    assert part_ptr[0] == 0 and part_ptr[-1] == len(slices) and len(part_ptr) == 3
    assert slices == sorted(slices)
    kr = ops.k1.k_range.numpy()
    spans = (kr[..., 1] - kr[..., 0]).ravel()
    assert spans[slices].max() == ops.ring_rows
    assert ops.ring_rows % 32 == 0 and (spans[slices] > 0).all()
    assert int(ops.seg_ptr[-1]) == ops.pair_chunk.shape[0] == ops.pair_off.shape[0]
    assert (ops.pair_off.numpy() % 128 == 0).all()
    assert len(set(segs)) == len(segs)
    assert 1.0 <= fr.linearizations_per_input(ops) < 2.0


@pytest.mark.parametrize("size, c, alpha", [
    ((384, 768, 96, 192), 3, -1),
    ((256, 960, 128, 480), 4, 3),
    ((320, 1280, 80, 320), 1, -1),
])
def test_ring_route_of_the_executor(size, c, alpha, monkeypatch):
    """``AVIR_TPU_GAMMA_ROUTE=ring`` on a viable downsize runs K6 (launch
    key ``fused_ring_vh_gamma``), bit-equal to the in-kernel route
    (``AVIR_TPU_GAMMA_ROUTE=inkernel``) and within 1 LSB of
    ``avir_tpu.resize``."""
    sw, sh, nw, nh = size
    _, plan = _plans(sw, sh, nw, nh, c, alpha)
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "ring")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = runtime.make_avir_executor(plan, device="cpu")
    assert (fn.route, fn.order, fn.ops.launch_key) == ("int8", "vh", "fused_ring_vh_gamma")
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "inkernel")
    base = runtime.make_avir_executor(plan, device="cpu")
    assert base.ops.launch_key == "fused_int8_vh_gamma"
    src = xorshift128_fill((sh, sw, c), np.uint8, 41)
    got = fn(torch.from_numpy(src.reshape(sh, -1))).numpy()
    np.testing.assert_array_equal(got, base(torch.from_numpy(src.reshape(sh, -1))).numpy())
    ref = np.asarray(avir_tpu.resize(src, nw, nh, use_srgb_gamma=True, alpha_index=alpha))
    assert np.abs(got.reshape(nh, nw, c).astype(int) - ref.astype(int)).max() <= 1
