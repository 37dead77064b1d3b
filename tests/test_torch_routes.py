"""The port's routing choices that the JAX package does not share, on the
CPU: the int8 gamma table against the JAX package's linearization, the
"auto" gamma route (K1 with the in-kernel linearization, as in the JAX
package; the ring kernel K6 only when named), the pass order of u16
upsizes, the u8 upsizes
that fuse H pass first, and the K4 wrapper's row groups.  The port runs its kernels' plain versions; every
comparison of outputs is bit-equal."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import xorshift128_fill

from avir_tpu.ops.pallas.fused_kernel import (
    _srgb_to_linear13_u8poly as jax_srgb_to_linear13_u8poly,
)

from torch_cases import (
    WAVEFRONT_GROUP_CASES,
    WAVEFRONT_GROUP_WARPS,
    WAVEFRONT_WARP_CASES,
    WAVEFRONT_WARP_OUTS,
    float_image,
)

import avir_tpu_torch
from avir_tpu_torch.models import runtime
from avir_tpu_torch.ops.cuda import wavefront as wf
from avir_tpu_torch.ops.gamma import f32, gamma_q13_table
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


# ---------------------------------------------------------------------------
# K1 int8's linearization table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out_dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("alpha", [-1, 0, 3])
def test_gamma_q13_table_matches_jax_poly(out_dtype, alpha):
    """Every u8 value of both lane kinds, at the ``in_gamma_mult`` of a u8
    gamma plan, bit for bit against the JAX package's
    ``_srgb_to_linear13_u8poly`` on [256, 4] lanes."""
    plan = build_resize_plan(
        30, 20, 15, 10, 4, np.uint8, out_dtype, use_srgb_gamma=True,
        alpha_index=alpha,
    )
    table = gamma_q13_table(plan.in_gamma_mult).numpy()
    x = np.arange(256, dtype=np.float32) * np.float32(f32(plan.in_gamma_mult))
    for a in (alpha, -1):
        ref = np.asarray(jax_srgb_to_linear13_u8poly(
            jnp.asarray(np.repeat(x, 4)[None, :]), 4, a
        )).reshape(256, 4)
        for lane in range(4):
            row = 1 if a in (0, 3) and lane == a else 0
            np.testing.assert_array_equal(table[row], ref[:, lane])
    assert table.dtype == np.int32 and table[:, 0].tolist() == [0, 0]
    assert table[1, 255] == 8192


# ---------------------------------------------------------------------------
# The "auto" int8 gamma route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", [None, "auto"])
@pytest.mark.parametrize("size, c, alpha", [
    ((384, 768, 96, 192), 3, -1),
    ((256, 960, 128, 480), 4, 3),
])
def test_auto_gamma_route_takes_the_ring_where_viable(route, size, c, alpha, monkeypatch):
    """Unset or "auto" on a ring-viable downsize runs K1 int8 vh with the
    in-kernel linearization (one ``fused_int8_vh_gamma`` launch), the
    fastest of the three routes on the card wherever K6 runs (PERF.md §6),
    and quietly; it is bit-equal to "ring", which runs K6 there, and to
    "inkernel"."""
    sw, sh, nw, nh = size
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True, alpha_index=alpha
    )
    if route is None:
        monkeypatch.delenv(runtime.GAMMA_ROUTE_ENV, raising=False)
    else:
        monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, route)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = runtime.make_avir_executor(plan, device="cpu")
    assert (fn.route, fn.order, fn.ops.launch_key) == ("int8", "vh", "fused_int8_vh_gamma")
    assert fn.ops.epi.gamma and fn.ops.epi.alpha_lane == (3 if alpha == 3 else -1)
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "ring")
    ring = runtime.make_avir_executor(plan, device="cpu")
    assert (ring.route, ring.order, ring.ops.launch_key) == ("int8", "vh", "fused_ring_vh_gamma")
    assert ring.ops.epi.gamma and ring.ops.epi.alpha_lane == fn.ops.epi.alpha_lane
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "inkernel")
    base = runtime.make_avir_executor(plan, device="cpu")
    assert base.ops.launch_key == "fused_int8_vh_gamma"
    x = torch.from_numpy(xorshift128_fill((sh, sw * c), np.uint8, 17))
    got = fn(x).numpy()
    np.testing.assert_array_equal(got, ring(x).numpy())
    np.testing.assert_array_equal(got, base(x).numpy())


@pytest.mark.parametrize("size, c, alpha", [
    ((97, 61, 151, 83), 4, 3),
    ((64, 48, 130, 100), 3, -1),
])
def test_auto_gamma_route_upsize_runs_k1_without_a_warning(size, c, alpha, monkeypatch):
    """An upsize cannot take the ring: "auto" runs K1 int8 hv with the
    in-kernel linearization, and says nothing (unlike "ring")."""
    sw, sh, nw, nh = size
    plan = build_resize_plan(
        sw, sh, nw, nh, c, np.uint8, np.uint8, use_srgb_gamma=True, alpha_index=alpha
    )
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "auto")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = runtime.make_avir_executor(plan, device="cpu")
    assert (fn.route, fn.order, fn.ops.launch_key) == ("int8", "hv", "fused_int8_hv_gamma")
    monkeypatch.setenv(runtime.GAMMA_ROUTE_ENV, "inkernel")
    base = runtime.make_avir_executor(plan, device="cpu")
    x = torch.from_numpy(xorshift128_fill((sh, sw * c), np.uint8, 23))
    np.testing.assert_array_equal(fn(x).numpy(), base(x).numpy())


def test_gamma_route_names():
    for value, route in ((None, "auto"), ("auto", "auto"), ("inkernel", "inkernel"),
                         ("prologue", "prologue"), ("ring", "ring"), ("other", "inkernel")):
        with pytest.MonkeyPatch.context() as mp:
            if value is None:
                mp.delenv(runtime.GAMMA_ROUTE_ENV, raising=False)
            else:
                mp.setenv(runtime.GAMMA_ROUTE_ENV, value)
            assert runtime.gamma_route() == route


# ---------------------------------------------------------------------------
# u16 upsizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["avir", "lancir"])
def test_u16_upsize_runs_vh_and_returns_the_executors_bits(kind):
    """A u16 upsize fuses V pass first, as the JAX package orders it, and
    the resizer returns the executor's bits on the CPU path."""
    src = xorshift128_fill((20, 30, 3), np.uint16, 3)
    if kind == "avir":
        out = avir_tpu_torch.ImageResizer(res_bit_depth=16).resize(src, 64, 48, device="cpu")
        plan = build_resize_plan(30, 20, 64, 48, 3, np.uint16, np.uint16, res_bit_depth=16)
        fn = runtime.make_avir_executor(plan, device="cpu")
    else:
        from avir_tpu_torch.plan.lancir_plan import build_lancir_plan

        out = avir_tpu_torch.LancIR().resize(src, 64, 48, device="cpu")
        fn = runtime.make_lancir_executor(
            build_lancir_plan(30, 20, 64, 48, 3, np.uint16, np.uint16), device="cpu"
        )
    want = fn(torch.from_numpy(src.reshape(20, -1))).numpy().reshape(48, 64, 3)
    assert out.dtype == np.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(out, want)
    assert fn.order == "vh"


# ---------------------------------------------------------------------------
# u8 upsizes to 4K: K1 split hv (choose_fused rule 4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c, out_dtype, plan_kw, exe_kw, want", [
    (3, np.uint8, {}, {"errdiff": True}, ("split", "hv", "split3", "split2")),
    (3, np.float32, {}, {}, ("split", "hv", "split3", "split2")),
    (3, np.uint16, {}, {}, ("split", "hv", "split3", "split2")),
    (3, np.uint8, {}, {"precision": "fast"}, ("split", "hv", "split2", "split2")),
    (4, np.uint8, {}, {"errdiff": True}, ("split", "hv", "split3", "split2")),
    (3, np.uint8, {"use_srgb_gamma": True}, {"errdiff": True}, ("unfused", "hv", None, None)),
], ids=["errdiff", "f32", "u16", "u8_fast", "rgba_errdiff", "gamma_errdiff"])
def test_u8_upsize_to_4k_routes(c, out_dtype, plan_kw, exe_kw, want):
    """1920x1080 -> 3840x2160 from u8: a split2 first pass without gamma
    and at least 8 M output values fuses H pass first (K1 split hv, the
    JAX package's rule at fused_kernel.py:719-725, and chip_smoke.py's
    1080p_to_4k_errdiff cell); with gamma the unfused route runs it."""
    plan = build_resize_plan(1920, 1080, 3840, 2160, c, np.uint8, out_dtype, **plan_kw)
    fn = runtime.make_avir_executor(plan, device="cpu", **exe_kw)
    modes = (fn.ops.mode_v, fn.ops.mode_h) if fn.route == "split" else (None, None)
    assert (fn.route, fn.order, *modes) == want
    if fn.route == "split":
        assert fn.ops.launch_key == "fused_split_hv"


# ---------------------------------------------------------------------------
# K4's row groups
# ---------------------------------------------------------------------------


def test_group_rows_and_critical_steps():
    for c in (1, 2, 3, 4):
        assert wf.group_rows_for(5000, c, None) == wf._GROUP_WARPS * 32 // c
        assert wf.group_rows_for(3, c, None) == 3
        assert wf.group_rows_for(100, c, 7) == 7
    assert wf.critical_steps(1080, 1920) == 1920 + 2 * 1079 == 4078
    assert wf.critical_steps(2160, 3840) == 8158
    assert wf.critical_steps(0, 5) == 0


@pytest.mark.parametrize("threads, bound", [
    (1, 256), (126, 256), (256, 256), (257, 1024), (1023, 1024), (1024, 1024),
])
def test_launch_bound_by_threads(threads, bound):
    """K4's instantiation is the one whose launch bound holds the block."""
    assert wf.launch_bound(threads) == bound


@pytest.mark.parametrize("threads", [0, 1025])
def test_launch_bound_rejects_what_no_block_holds(threads):
    with pytest.raises(ValueError, match="threads"):
        wf.launch_bound(threads)


def test_cell_shape_takes_the_small_instantiation():
    """The errdiff cell's K4 (3840x2160x3) at the default groups fills
    126 threads: the 256-thread instantiation; groups of 8 warps still
    take it, groups of 32 the 1024-thread one."""
    c = 3
    assert wf.launch_bound(wf.group_rows_for(2160, c, None) * c) == 256
    assert wf.launch_bound(wf.group_rows_for(2160, c, 8 * 32 // c) * c) == 256
    assert wf.launch_bound(wf.group_rows_for(2160, c, 32 * 32 // c) * c) == 1024
    assert set(wf.forms) == {256, 1024}


def test_plain_wavefront_counts_no_launch():
    """The plain version (a CPU tensor) launches nothing and counts no
    form."""
    before, forms = dict(wf.launches), dict(wf.forms)
    img = torch.from_numpy(float_image(5, 7, 3, 255.0, 1))
    wf.errdiff_wavefront(img, 0, 255.0, out_dtype=torch.uint8)
    assert wf.launches == before and wf.forms == forms


@pytest.mark.parametrize("name", list(WAVEFRONT_WARP_CASES))
def test_plain_wavefront_at_the_warp_cases(name):
    """The plain version blocked as the kernel groups rows at each of K4's
    exchange edges gives the single block's bits, in both sum orders."""
    h, w, c, rows = WAVEFRONT_WARP_CASES[name]
    om, tb = WAVEFRONT_WARP_OUTS["u16"]
    img = torch.from_numpy(float_image(h, w, c, om, h * 5 + w + c))
    for scan in (False, True):
        one = wf.errdiff_wavefront_reference(img, tb, om, block_rows=h, scan_order=scan)
        got = wf.errdiff_wavefront(
            img, tb, om, block_rows=wf.group_rows_for(h, c, rows), scan_order=scan
        )
        assert torch.equal(got, one), scan


@pytest.mark.parametrize("name", list(WAVEFRONT_GROUP_CASES))
def test_plain_wavefront_at_the_kernel_group_sizes(name):
    """The plain version blocked as the kernel groups rows (one, four and
    32 warps of (row, channel) threads) gives the single block's bits."""
    h, w, c, tb, om, tout = WAVEFRONT_GROUP_CASES[name]
    img = torch.from_numpy(float_image(h, w, c, om, h * 7 + w))
    one = wf.errdiff_wavefront_reference(img, tb, om, block_rows=h)
    for warps in WAVEFRONT_GROUP_WARPS:
        rows = warps * 32 // c
        got = wf.errdiff_wavefront(img, tb, om, block_rows=rows)
        assert torch.equal(got, one), warps
