"""The port's 2-D (rows x cols) mesh (avir_tpu_torch/parallel/sharded.py,
``make_sharded_{avir,lancir}_executor_2d``) against the JAX package's 2-D
executors, on the CPU.

The JAX side runs in this process on the virtual CPU devices that
tests/conftest.py gives, on a ("sp", "cp") mesh (("dp", "sp", "cp") with
frames), with ``engine="pallas", interpret=True`` (its kernel route) or
``engine="xla"`` (its library body, for the port's library-route cases).
The port's side runs in one gloo world of 4 CPU processes for the module
(tests/torch_mesh_worker.py's ``sharded2d`` suite, started once; the
kernels' plain versions), and tile by tile in this process through the
pure ``Tile.compute`` with tiles and halos cut from the padded image.

Tolerances: the planner's fields are array-equal (bf16 taps compared as
float32); the int8 route is bit-equal to the JAX interpret-mode kernel
route, tile by tile and assembled; the split route (u16, float, gamma
RGBA), error diffusion and the library route are within 1 LSB (float:
max|ref| * 1e-4), 16-bit error diffusion with ``trunc_bits`` within one
quantization step, the ROADMAP.md gates.  The three-launch overlap is
bit-equal to one launch, and tile-by-tile ``compute`` to the world."""

import json

import jax
import numpy as np
import pytest
import torch

from avir_tpu.parallel import sharded as jsh
from avir_tpu.plan.lancir_plan import build_lancir_plan as jax_build_lancir_plan
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

import torch_mesh_worker as W
from test_torch_sharded import World

from avir_tpu_torch.parallel import sharded
from avir_tpu_torch.parallel.multihost import DpSpCpMesh
from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)

CASES = {case[0]: case for case in W.CASES_2D}
# The port's library-route cases, held to the JAX library body.
LIBRARY = ("avir_exact", "avir_all_gather_rows", "avir_all_gather_cols",
           "lancir_exact", "lancir_f32")
INT8 = ("avir_int8_2x2", "avir_int8_1x4", "avir_int8_odd_1x4", "avir_int8_overlap",
        "avir_gamma_rgba_odd", "avir_gamma_rgba_up", "lancir_int8", "lancir_batch")
ROUTES = {
    **{n: "int8" for n in INT8}, **{n: "library" for n in LIBRARY},
    **{n: "split" for n in CASES if n not in INT8 and n not in LIBRARY},
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World("sharded2d", tmp_path_factory.mktemp("torch_mesh_2d"))
    yield w
    for p in w.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _jax_plan(case):
    _, kind, (sw, sh, nw, nh, c), tin, tout, plan_kw, *_ = case
    build = jax_build_resize_plan if kind == "avir" else jax_build_lancir_plan
    return build(sw, sh, nw, nh, c, W.NP_TYPES[tin], W.NP_TYPES[tout], **plan_kw)


def _jax_mesh(shape, names):
    """``jax.make_mesh`` on the first virtual devices, as the JAX tests
    build their 2-D meshes (tests/mesh/sharded_mesh.py:412): its axis types
    let ``_slice_padded_out`` cut sizes that do not divide the grid."""
    return jax.make_mesh(shape, names, devices=jax.devices()[: int(np.prod(shape))])


def _jax_output(case) -> np.ndarray:
    name, kind, *_, ex_kw, (dp, sp, cp), frames, _ = case
    if frames:
        mesh, axes = _jax_mesh((dp, sp, cp), ("dp", "sp", "cp")), dict(batch_axis="dp")
    else:
        mesh, axes = _jax_mesh((sp, cp), ("sp", "cp")), {}
    engine = dict(engine="xla") if name in LIBRARY else dict(engine="pallas", interpret=True)
    make = (
        jsh.make_sharded_avir_executor_2d if kind == "avir"
        else jsh.make_sharded_lancir_executor_2d
    )
    return np.asarray(make(_jax_plan(case), mesh, **axes, **engine, **ex_kw)(W.flat_2d(case)))


def _within_gate(case, got: np.ndarray, ref: np.ndarray) -> bool:
    """1 LSB, max|ref| * 1e-4 for float, or with ``trunc_bits`` one
    quantization level (levels of 65535 / 4095 land 16 or 17 integers
    apart)."""
    tout, plan_kw = case[4], case[5]
    if tout == "f32":
        return _diff(got, ref) <= float(np.abs(ref).max()) * 1e-4
    bits = 8 if tout == "u8" else 16
    trunc = bits - plan_kw.get("res_bit_depth", bits)
    if not trunc:
        return _diff(got, ref) <= 1.0
    out_max = (1 << bits) - 1
    step = out_max / (out_max >> trunc)
    return _diff(np.round(got / step), np.round(ref / step)) <= 1.0


def _diff(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def _stub_mesh(sp: int, cp: int, i: int, j: int) -> DpSpCpMesh:
    """Tile (i, j) of an sp x cp mesh in this process: enough to build its
    executor and run its pure tile function (no collective)."""
    return DpSpCpMesh(dp=1, sp=sp, cp=cp, dp_index=0, sp_index=i, cp_index=j,
                      sp_group=None, cp_group=None, dp_group=None,
                      device=torch.device("cpu"))


def _emulated(case) -> np.ndarray:
    """The case's image from every tile's ``compute`` in this process,
    with (x, xc, ext) cut from the padded image (``halo_tiles``)."""
    name, _, (sw, sh, nw, nh, c), *_, (_, sp, cp), _, _ = case
    plan, flat = W.port_plan(case), W.flat_2d(case)
    rows = []
    for i in range(sp):
        row = []
        for j in range(cp):
            fn = W.make_executor_2d(case, plan, _stub_mesh(sp, cp, i, j))
            tiles = sharded.halo_tiles(flat, fn.svop, fn.slb, i, j)
            row.append(fn.tile.compute(*(torch.from_numpy(t) for t in tiles)).numpy())
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)[:nh, : nw * c]


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

LANE_CASES = [
    # (src_w, new_w, c, n_dev): 128-lane and C-only low halos, the
    # all-gather, padding-only ranks, lanes_pad % C != 0, interior blocks.
    (256, 128, 3, 2), (256, 128, 3, 4), (70, 50, 4, 2), (70, 110, 4, 2),
    (48, 24, 3, 2), (96, 64, 3, 4), (101, 149, 3, 3), (16, 5, 3, 4),
    (1200, 600, 3, 2), (640, 320, 1, 4), (90, 300, 2, 2),
]
LANE_FIELDS = ("n_out", "c", "m", "tile", "strip_lanes", "halo_lo", "halo_hi", "win_l",
               "lanes_pad", "offs_l", "taps_q1", "taps_q0", "q_shift", "chunk_rel",
               "win_c", "ctaps_q1", "ctaps_q0", "l1_max", "q_abs1", "q_abs0",
               "use_all_gather", "b_int0", "b_int1")


def _assert_lane_equal(got, want):
    for f in LANE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    for f in ("taps_hi", "taps_lo", "ctaps_hi", "ctaps_lo"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b).astype(np.float32), err_msg=f)


@pytest.mark.parametrize("src_w,new_w,c,n_dev", LANE_CASES)
@pytest.mark.parametrize("in_bytes", [1, 2])
def test_lane_planner_fields_equal_jax(src_w, new_w, c, n_dev, in_bytes):
    dt = np.uint8 if in_bytes == 1 else np.uint16
    op = build_resize_plan(src_w, 16, new_w, 8, c, dt, dt).h.op
    jop = jax_build_resize_plan(src_w, 16, new_w, 8, c, dt, dt).h.op
    padded = src_w + (-src_w) % n_dev
    _assert_lane_equal(
        sharded.shard_lane_blocked(op, n_dev, padded, c, in_bytes=in_bytes),
        jsh.shard_lane_blocked(jop, n_dev, padded, c, in_bytes=in_bytes),
    )


def test_lane_planner_covers_its_branches():
    """The cases reach both roundings of halo_lo, the all-gather, a rank
    that owns only padding columns, lanes_pad % C != 0 and interior
    blocks."""
    seen = set()
    for src_w, new_w, c, n_dev in LANE_CASES:
        op = build_resize_plan(src_w, 16, new_w, 8, c, np.uint8, np.uint8).h.op
        sl = sharded.shard_lane_blocked(op, n_dev, src_w + (-src_w) % n_dev, c)
        if sl.use_all_gather:
            seen.add("all_gather")
            continue
        seen.add("halo_128" if sl.halo_lo % 128 == 0 else "halo_c")
        if sl.lanes_pad % c:
            seen.add("lanes_pad_off_c")
        if sl.b_int1 > sl.b_int0:
            seen.add("interior")
        if (n_dev - 1) * sl.m >= new_w:
            seen.add("padding_rank")
    assert seen >= {"all_gather", "halo_128", "halo_c", "lanes_pad_off_c", "interior"}
    op = build_resize_plan(16, 16, 5, 8, 3, np.uint8, np.uint8).h.op
    assert (4 - 1) * sharded.shard_lane_blocked(op, 4, 16, 3).m >= 5


GRID_PLANS = [
    # (src_w, src_h, new_w, new_h, c): the 8K plan of
    # tests/test_scaling_model.py:110-126, a tall narrow one, odd shapes.
    (7680, 4320, 1920, 1080, 3), (64, 8192, 32, 4096, 3), (70, 90, 50, 62, 4),
    (256, 192, 128, 96, 3), (16, 64, 5, 32, 3), (1920, 1080, 3840, 2160, 3),
]


@pytest.mark.parametrize("plan_args", GRID_PLANS)
def test_grid_helpers_equal_jax(plan_args):
    sw, sh, nw, nh, c = plan_args
    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    for n in (1, 2, 3, 4, 6, 8):
        assert sharded.suggest_grid(plan, n) == jsh.suggest_grid(jplan, n), n
        padded_h, padded_w = sh + (-sh) % n, sw + (-sw) % n
        assert sharded._halo_fits(plan.v.op, n, padded_h) == jsh._halo_fits(jplan.v.op, n, padded_h)
        assert sharded._halo_fits(plan.h.op, n, padded_w, c) == jsh._halo_fits(jplan.h.op, n, padded_w, c)
    x = np.arange(2 * 3 * 7 * c, dtype=np.uint16).reshape(2, 3, 7 * c)
    for n in (1, 2, 3, 4):
        np.testing.assert_array_equal(sharded.pad_cols(x, n, c), jsh.pad_cols(x, n, c))


def test_suggest_grid_8k_and_tall():
    """The JAX package's own expectations (tests/test_scaling_model.py:110):
    pure columns at 8K, rows where a 64-pixel width cannot take them."""
    p8k = build_resize_plan(7680, 4320, 1920, 1080, 3, np.uint8, np.uint8)
    assert sharded.suggest_grid(p8k, 4) == (1, 4)
    assert sharded.suggest_grid(p8k, 8) == (1, 8)
    tall = build_resize_plan(64, 8192, 32, 4096, 3, np.uint8, np.uint8)
    r, s = sharded.suggest_grid(tall, 8)
    assert r > 1
    if s > 1:
        assert not sharded.shard_lane_blocked(tall.h.op, s, 64, 3).use_all_gather


# ---------------------------------------------------------------------------
# The gloo world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_2d_matches_jax(name, world):
    case = CASES[name]
    want = _jax_output(case)
    out = world.result()
    got = np.load(out / f"{name}.npy")
    assert got.shape == want.shape and got.dtype == want.dtype
    if name in INT8:
        np.testing.assert_array_equal(got, want)
    else:
        assert _within_gate(case, got, want), _diff(got, want)
    launches = 3 if name == "avir_int8_overlap" else 0 if name in LIBRARY else 1
    for rank in range(4):
        seen = json.loads((out / f"{name}_r{rank}.json").read_text())
        assert seen["route"] == ROUTES[name], (rank, seen)
        assert seen["k1_calls_a_frame"] == launches, (rank, seen)


@pytest.mark.parametrize(
    # The tile body's own output: not the library route's, not batches,
    # not error diffusion's pre-dither tiles.
    "name", [n for n in CASES if n not in LIBRARY and not CASES[n][8] and "dither" not in CASES[n][6]]
)
def test_tile_compute_matches_world_and_jax(name, world):
    """Tile by tile through the pure ``compute`` (tools/probe_strip2d_tpu.py's
    emulation there, ``test_sharded_2d_geom_emulation_matches_mesh``): bit-
    equal to the world's image; int8 bit-equal to the JAX kernel route."""
    case = CASES[name]
    got = _emulated(case)
    np.testing.assert_array_equal(got, np.load(world.result() / f"{name}.npy"))
    if name in INT8:
        np.testing.assert_array_equal(got, _jax_output(case))


def test_overlap_three_launches_with_the_same_bits():
    """halo_overlap=True splits a u8 tile with interior blocks on both axes
    (the precondition, asserted on the port's planner at the smallest such
    geometry of the cases) into the x, xc and ext launches, and gives the
    bits of the one launch over ext; both within 1 LSB of the JAX library
    body (bit-equality to the JAX kernel route: test_mesh_2d_matches_jax)."""
    case = CASES["avir_int8_overlap"]
    (sw, sh, nw, nh, c), (_, sp, cp) = case[2], case[7]
    plan = W.port_plan(case)
    svb = sharded.shard_v_blocked(plan.v.op, sp, sh, tile=32)
    slb = sharded.shard_lane_blocked(plan.h.op, cp, sw, c)
    assert 0 < svb.b_int0 < svb.b_int1 < svb.taps.shape[1]
    assert 0 < slb.b_int0 < slb.b_int1 < slb.n_blocks
    flat = W.flat_2d(case)
    for i in range(sp):
        for j in range(cp):
            split = W.make_executor_2d(case, plan, _stub_mesh(sp, cp, i, j))
            one = sharded.make_sharded_avir_executor_2d(plan, _stub_mesh(sp, cp, i, j), pallas_tile=32)
            assert [on for _, on in split.tile.parts] == ["x", "xc", "ext"]
            assert [on for _, on in one.tile.parts] == ["ext"]
            tiles = [torch.from_numpy(t) for t in sharded.halo_tiles(flat, split.svop, split.slb, i, j)]
            assert torch.equal(split.tile.compute(*tiles), one.tile.compute(*tiles))
    mesh = _jax_mesh((sp, cp), ("sp", "cp"))
    xla = np.asarray(jsh.make_sharded_avir_executor_2d(_jax_plan(case), mesh, engine="xla")(flat))
    assert _diff(_emulated(case), xla) <= 1


def test_library_route_without_a_world():
    """The library route's tiles need the collectives, so its build is
    checked for its operators: the rows' ShardedVOp and the transposed H
    pass's, each the JAX package's."""
    case = CASES["avir_all_gather_cols"]
    sw, sh, nw, nh, c = case[2]
    fn = W.make_executor_2d(case, W.port_plan(case), _stub_mesh(1, 4, 0, 1))
    assert fn.route == "library" and fn.tile is None
    jplan = _jax_plan(case)
    want = jsh.shard_v_op(jplan.h.op, 4, sw + (-sw) % 4, tile=64)
    assert fn.slb.use_all_gather and want.use_all_gather
    np.testing.assert_array_equal(fn.slb.taps, want.taps)


def test_engine_and_input_checks_2d():
    plan = build_resize_plan(48, 64, 24, 32, 3, np.uint8, np.uint8)
    mesh = _stub_mesh(2, 2, 0, 0)
    with pytest.raises(ValueError, match="precision='exact'"):
        sharded.make_sharded_avir_executor_2d(plan, mesh, engine="xla")
    with pytest.raises(ValueError, match="unknown dither"):
        sharded.make_sharded_avir_executor_2d(plan, mesh, dither="floyd")
    lplan = build_lancir_plan(48, 64, 24, 32, 3, np.uint8, np.uint8)
    with pytest.raises(ValueError, match="unknown engine"):
        sharded.make_sharded_lancir_executor_2d(lplan, mesh, engine="host")
    fn = sharded.make_sharded_avir_executor_2d(plan, mesh, engine="pallas")
    assert fn.route == "int8"
    with pytest.raises(ValueError, match="tile"):
        fn(torch.zeros((32, 48 * 3), dtype=torch.uint8))
