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

from torch_cases import RING_CASES, RING_CLUSTER_CASES

from avir_tpu_torch.models import runtime
from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import fused_kernel as fk
from avir_tpu_torch.ops.cuda import fused_ring as fr
from avir_tpu_torch.ops.gamma import _int8_limbs, gamma_q13_table
from avir_tpu_torch.ops.lanes import lane_block_banded
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)

# The two shapes of the reference's ring route table (runtime.py:388-395
# there), u8 RGB with gamma: only their operators are built here.
FULL_SIZE = {"8k_to_1080p": (7680, 4320, 1920, 1080), "4k_to_720p": (3840, 2160, 1280, 720)}

# K6's cluster plan at full size, on the host (u8 RGB unless C says;
# RGBA with alpha 3): (src_w, src_h, new_w, new_h, c) -> (blocks a
# cluster, ring rows, shared memory bytes a block).  K6 is viable ("ring"
# runs it) at the first five and at RGBA 8K -> 1080p, the shapes
# gamma_routes.py times on the card.
FULL_SIZE_PLANS = {
    "8k_to_1080p": ((7680, 4320, 1920, 1080, 3), (6, 192, 112_640)),
    "4k_to_720p": ((3840, 2160, 1280, 720, 3), (5, 160, 101_888)),
    "8k_to_720p": ((7680, 4320, 1280, 720, 3), (8, 256, 134_144)),
    "8k_to_540p": ((7680, 4320, 960, 540, 3), (12, 384, 177_152)),
    "8k_to_360p": ((7680, 4320, 640, 360, 3), (16, 512, 220_160)),
    "8k_to_1080p_rgba": ((7680, 4320, 1920, 1080, 4), (6, 192, 112_640)),
    "4k_to_1080p": ((3840, 2160, 1920, 1080, 3), (4, 128, 91_136)),
}
AUTO_RING = ("8k_to_1080p", "4k_to_720p", "8k_to_720p", "8k_to_540p", "8k_to_1080p_rgba")
ALL_RING_CASES = {**RING_CASES, **RING_CLUSTER_CASES}


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
    """The kernel's schedule: every slice with output rows is in exactly
    one part, in order, and the active ones' tap rows fit the ring; every
    output chunk has one cluster; each block owns one input segment the
    chunk's nonzero lane taps reach, or none, the owners first."""
    sw, sh, nw, nh, c, alpha, tile, uniform = RING_CASES[name]
    _, plan = _plans(sw, sh, nw, nh, c, alpha)
    ops = fr.prepare_fused_ring(*_ring_ops(plan, c, tile, uniform), "cpu", parts=2)
    part_ptr, slices = ops.part_ptr.tolist(), ops.slices[:, 0].tolist()
    assert part_ptr[0] == 0 and part_ptr[-1] == len(slices) and len(part_ptr) == 3
    k1 = ops.k1
    _, tv, _ = k1.v1.shape
    n_sl = k1.k_range.shape[1]
    assert slices == [g for g in range(k1.v1.shape[0] * n_sl)
                      if (g // n_sl) * tv + (g % n_sl) * 32 < k1.rows_out]
    kr = k1.k_range.numpy()
    np.testing.assert_array_equal(ops.slices[:, 1:3].numpy(), kr.reshape(-1, 2)[slices])
    assert ops.slices[:, 3].tolist() == [k1.offs_v_host[g // n_sl] for g in slices]
    spans = (kr[..., 1] - kr[..., 0]).ravel()
    assert spans[slices].max() == ops.ring_rows
    assert ops.ring_rows % 32 == 0
    bh, n_ch = k1.h1.shape[:2]
    assert ops.chunk_of.tolist() == [
        hb * n_ch + j for hb in range(bh) for j in range(n_ch)
        if hb * k1.tc + j * 128 < k1.lanes_out
    ]
    seg = ops.seg_of.numpy().reshape(-1, ops.cluster)
    owned = seg >= 0
    assert (owned[:, :-1] >= owned[:, 1:]).all()  # owners first
    assert owned.any(axis=1).all() and owned.all(axis=0)[0]
    assert (ops.off_of.numpy() % 128 == 0).all()
    assert ops.smem_bytes == fr.smem_bytes(ops.ring_rows) <= fr.MAX_SMEM
    assert 1.0 <= fr.linearizations_per_input(ops) < 4.0


@pytest.mark.parametrize("name", list(ALL_RING_CASES))
def test_cluster_plan_owns_every_pair(name):
    """Every (segment, chunk) pair of ``_pairs`` (a 128-lane group of a
    chunk's window with a nonzero lane tap) is owned by exactly one block
    of that chunk's cluster, at its window offset; no block owns anything
    else."""
    sw, sh, nw, nh, c, alpha, tile, uniform = ALL_RING_CASES[name]
    _, plan = _plans(sw, sh, nw, nh, c, alpha)
    ops = fr.prepare_fused_ring(*_ring_ops(plan, c, tile, uniform), "cpu")
    pairs = {(chunk, seg, off) for seg, lst in fr._pairs(ops.k1).items() for chunk, off in lst}
    seg = ops.seg_of.numpy().reshape(-1, ops.cluster)
    off = ops.off_of.numpy().reshape(-1, ops.cluster)
    owned = [
        (chunk, int(s), int(o))
        for chunk, ss, oo in zip(ops.chunk_of.tolist(), seg, off)
        for s, o in zip(ss, oo) if s >= 0
    ]
    assert len(owned) == len(set(owned)) == len(pairs)
    assert set(owned) == pairs
    assert ops.cluster == max(
        sum(1 for ch, _, _ in pairs if ch == chunk) for chunk in ops.chunk_of.tolist()
    )


def _cluster_emulation(ops: fr.FusedRingOperands, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, cluster by cluster: each
    block linearizes its segment (the q13 table), runs the V pass over each
    slice's nonzero tap rows, requantizes and multiplies the limbs by its
    chunk's lane taps of that segment; the cluster sums the blocks' shares
    and finishes every output of its chunk.  Each output is written by
    exactly one cluster."""
    k1 = ops.k1
    epi = k1.epi
    bv, tv, wv = k1.v1.shape
    n_sl = k1.k_range.shape[1]
    n = ops.cluster
    # The padded image's limbs, zero above (pad_top) and past the image.
    seg_all = ops.seg_of.numpy()
    lanes_p = 128 * (int(seg_all.max()) + 1)
    rows_p = max(k1.offs_v_host) + wv
    xi = torch.zeros((rows_p, lanes_p), dtype=torch.long)
    r = min(k1.rows_in, rows_p - ops.pad_top)
    l = min(k1.lanes_in, lanes_p)
    xi[ops.pad_top : ops.pad_top + r, :l] = x[:r, :l].long()
    lane = torch.arange(lanes_p)
    row = ((lane & 3) == epi.alpha_lane).long().expand_as(xi)
    xq = gamma_q13_table(epi.in_gamma_mult)[row, xi]
    xq1, xq0 = (q.to(torch.float64) for q in _int8_limbs(xq))
    v1, v0 = k1.v1.to(torch.float64), k1.v0.to(torch.float64)
    h1, h0 = k1.h1.to(torch.float64), k1.h0.to(torch.float64)
    bh, n_ch = k1.h1.shape[:2]
    acc = torch.zeros((k1.rows_out, k1.lanes_out), dtype=torch.float32)
    written = torch.zeros((k1.rows_out, k1.lanes_out), dtype=torch.int32)
    for i, chunk in enumerate(ops.chunk_of.tolist()):
        hb, j = divmod(chunk, n_ch)
        for g in ops.slices[:, 0].tolist():
            vb, r0 = g // n_sl, (g % n_sl) * 32
            pa = torch.zeros((32, 128), dtype=torch.float64)
            pb = torch.zeros_like(pa)
            k_lo, k_hi = k1.k_range.view(-1, 2)[g].tolist()
            for rank in range(n):
                seg = int(ops.seg_of[i * n + rank])
                if seg < 0 or k_lo == k_hi:
                    continue
                off = int(ops.off_of[i * n + rank])
                q1 = torch.zeros((32, k_hi - k_lo), dtype=torch.float64)
                q0 = torch.zeros_like(q1)
                rows = slice(r0, min(r0 + 32, tv))
                q1[: rows.stop - r0] = v1[vb, rows, k_lo:k_hi]
                q0[: rows.stop - r0] = v0[vb, rows, k_lo:k_hi]
                win = slice(k1.offs_v_host[vb] + k_lo, k1.offs_v_host[vb] + k_hi)
                lanes = slice(128 * seg, 128 * seg + 128)
                w1, w0 = xq1[win, lanes], xq0[win, lanes]
                fq = (q1 @ w1) * 16384.0 + (q1 @ w0 + q0 @ w1) * 128.0
                x1, x0 = fk._limbs(fq, k1.sh)
                t1, t0 = h1[hb, j, off : off + 128], h0[hb, j, off : off + 128]
                pa += x1 @ t1
                pb += x0 @ t1 + x1 @ t0
            out = fk._recombine(pa, pb, k1.out_exp)
            o_r = vb * tv + r0
            nr = max(0, min(32, tv - r0, k1.rows_out - o_r))
            o_l = hb * k1.tc + j * 128
            nl = max(0, min(128, k1.tc - j * 128, k1.lanes_out - o_l))
            acc[o_r : o_r + nr, o_l : o_l + nl] = out[:nr, :nl]
            written[o_r : o_r + nr, o_l : o_l + nl] += 1
    assert (written == 1).all()
    return fk.finish_reference(acc, epi).contiguous()


@pytest.mark.parametrize("name", list(ALL_RING_CASES))
def test_cluster_shares_sum_to_the_plain_version(name):
    """The cluster plan's per-segment shares, summed per chunk as the
    kernel's clusters sum them, give K6's plain version bit for bit."""
    sw, sh, nw, nh, c, alpha, tile, uniform = ALL_RING_CASES[name]
    _, plan = _plans(sw, sh, nw, nh, c, alpha)
    ops = fr.prepare_fused_ring(
        *_ring_ops(plan, c, tile, uniform), "cpu", alpha_index=alpha,
        in_gamma_mult=plan.in_gamma_mult, out_gamma_mult=plan.out_gamma_mult,
    )
    x = torch.from_numpy(xorshift128_fill((sh, sw * c), np.uint8, sum(map(ord, name))))
    assert torch.equal(_cluster_emulation(ops, x), fr.apply_fused_ring_reference(ops, x))


@pytest.mark.parametrize("name", list(FULL_SIZE_PLANS))
def test_cluster_plan_full_size(name):
    """Blocks a cluster, ring rows and shared memory a block at the seven
    full-size shapes, on the host only; within the H100's 16 blocks and
    232,448 bytes."""
    (sw, sh, nw, nh, c), (cluster, ring_rows, smem) = FULL_SIZE_PLANS[name]
    alpha = 3 if c == 4 else -1
    _, plan = _plans(sw, sh, nw, nh, c, alpha)
    ops = fr.prepare_fused_ring(
        block_banded(plan.v.op, uniform=True), lane_block_banded(plan.h.op, c), "cpu",
        alpha_index=alpha,
    )
    assert (ops.cluster, ops.ring_rows, ops.smem_bytes) == (cluster, ring_rows, smem)
    assert ops.cluster <= fr.MAX_CLUSTER and ops.smem_bytes <= fr.MAX_SMEM
    if name == "8k_to_1080p":
        assert ops.chunk_of.shape[0] == 45 and int((ops.seg_of >= 0).sum()) == 268
        assert 1.4 < fr.linearizations_per_input(ops) < 1.8  # K1: 2.98


@pytest.mark.parametrize("name", AUTO_RING)
def test_auto_gamma_route_runs_k6_at_full_size(name, monkeypatch):
    """At the full-size ring shapes ``AVIR_TPU_GAMMA_ROUTE=ring`` builds
    K6's executor, and unset ("auto") builds K1's with the in-kernel
    linearization, the faster route on the card at each of them (PERF.md
    §6); on the host: operands only, no image."""
    (sw, sh, nw, nh, c), _ = FULL_SIZE_PLANS[name]
    _, plan = _plans(sw, sh, nw, nh, c, 3 if c == 4 else -1)
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "ring")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = runtime.make_avir_executor(plan, device="cpu")
        assert (fn.route, fn.order, fn.ops.launch_key) == ("int8", "vh", "fused_ring_vh_gamma")
        monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV)
        auto = runtime.make_avir_executor(plan, device="cpu")
    assert (auto.route, auto.order, auto.ops.launch_key) == ("int8", "vh", "fused_int8_vh_gamma")


@pytest.mark.parametrize("route", [None, "auto"])
@pytest.mark.parametrize("name", AUTO_RING)
def test_auto_gamma_route_builds_no_ring_operands(name, route, monkeypatch):
    """Wherever K6 is viable, "auto" (or the variable unset) names the
    in-kernel route, as the JAX package's does, and builds none of K6's
    operands: set-up never reaches ``_ring_operands``."""
    (sw, sh, nw, nh, c), _ = FULL_SIZE_PLANS[name]
    _, plan = _plans(sw, sh, nw, nh, c, 3 if c == 4 else -1)
    if route is None:
        monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV, raising=False)
    else:
        monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, route)

    def refuse(*_):
        pytest.fail("auto built K6's operands")

    monkeypatch.setattr(runtime, "_ring_operands", refuse)
    fn = runtime.make_avir_executor(plan, device="cpu")
    assert (fn.route, fn.order, fn.ops.launch_key) == ("int8", "vh", "fused_int8_vh_gamma")


@pytest.mark.parametrize("size, c", [((4096, 640, 128, 160), 1), ((2561, 768, 128, 192), 1)])
def test_ring_refuses_windows_over_16_segments(size, c, monkeypatch):
    """A chunk window of more than 16 segments needs a larger cluster than
    the card has: ``prepare_fused_ring`` refuses it, "ring" warns and
    takes the in-kernel K1, and "auto" takes that route quietly, as it
    does at every shape; both give the ring's function (K1's in-kernel
    bits)."""
    sw, sh, nw, nh = size
    _, plan = _plans(sw, sh, nw, nh, c, -1)
    vop, lop = block_banded(plan.v.op, uniform=True), lane_block_banded(plan.h.op, c)
    assert fr.ring_viable(vop, lop, True, "vh")
    with pytest.raises(ValueError, match="more than the 16 blocks"):
        fr.prepare_fused_ring(vop, lop, "cpu")
    monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        auto = runtime.make_avir_executor(plan, device="cpu")
    assert (auto.route, auto.order, auto.ops.launch_key) == ("int8", "vh", "fused_int8_vh_gamma")
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "ring")
    with pytest.warns(UserWarning, match="ring not viable"):
        ring = runtime.make_avir_executor(plan, device="cpu")
    assert ring.ops.launch_key == "fused_int8_vh_gamma"


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
