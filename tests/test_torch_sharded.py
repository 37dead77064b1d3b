"""The port's row-strip mesh (avir_tpu_torch/parallel/sharded.py) against
the JAX package's sharded executors, on the CPU.

The JAX side runs in this process on the virtual CPU devices that
tests/conftest.py gives, with ``engine="pallas", interpret=True`` (its
kernel route) or ``engine="xla"`` (its library route: the all-gather
fallback, ``precision="exact"``, LANCIR float output and, as
tests/mesh/sharded_mesh.py:380 runs it, 16-bit error diffusion).  The
port's side runs in one gloo world of 4 CPU processes for the module
(tests/torch_mesh_worker.py, started once; the kernels' plain versions),
and rank by rank in this process through the pure strip function.

Tolerances: the planner's fields are array-equal; the int8 route is
bit-equal to the JAX interpret-mode kernel route, rank by rank and
assembled; the split route (u16, float, gamma RGBA), error diffusion and
the library route are within 1 LSB (float: max|ref| * 1e-4), 16-bit error
diffusion with ``trunc_bits`` within one quantization step, the
ROADMAP.md gates.  Every case is also within 1 LSB (float: max * 1e-4;
16-bit error diffusion: one step) of the port's single-card resize on
``device="cpu"``."""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from avir_tpu.models.runtime import make_avir_executor as jax_make_avir_executor
from avir_tpu.parallel import sharded as jsh
from avir_tpu.plan.lancir_plan import build_lancir_plan as jax_build_lancir_plan
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

import torch_mesh_worker as W

import avir_tpu_torch
from avir_tpu_torch.parallel import sharded
from avir_tpu_torch.parallel.multihost import DpSpMesh
from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)

WORLD = 4
CASES = {case[0]: case for case in W.CASES}
# Cases the JAX package runs on its library route (engine="xla").
JAX_XLA = ("avir_all_gather", "avir_exact", "avir_errdiff_device_u16", "lancir_f32")
# Cases whose port route is int8: bit-equal to the JAX kernel route.
INT8 = ("avir_int8", "avir_int8_odd", "avir_int8_overlap", "avir_gamma_rgba",
        "avir_batch", "lancir_int8")
ROUTES = {
    **{n: "int8" for n in INT8},
    "avir_u16": "split", "avir_u16_gamma_rgba": "split", "avir_f32": "split",
    "avir_errdiff": "split", "avir_errdiff_device_u16": "split",
    "avir_all_gather": "library", "avir_exact": "library",
    "lancir_u16": "split", "lancir_f32": "library",
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """A gloo world of WORLD worker processes running one suite of
    tests/torch_mesh_worker.py; ``result()`` waits for it (with a limit,
    killing every worker past it) and returns the output directory."""

    def __init__(self, suite: str, outdir: pathlib.Path):
        env = dict(os.environ, TORCH_CPP_LOG_LEVEL="ERROR")
        init = f"tcp://127.0.0.1:{_free_port()}"
        self.outdir = outdir
        self.procs = [
            subprocess.Popen(
                [sys.executable, str(pathlib.Path(W.__file__)), suite, init,
                 str(r), str(WORLD), str(outdir)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(WORLD)
        ]
        self.outs = None

    def result(self, timeout: float = 240) -> pathlib.Path:
        if self.outs is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=timeout)[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            self.outs = outs
        for r, (p, out) in enumerate(zip(self.procs, self.outs)):
            assert p.returncode == 0, f"rank {r} failed (rc={p.returncode})\n{out[-6000:]}"
        return self.outdir


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World("sharded", tmp_path_factory.mktemp("torch_mesh"))
    yield w
    for p in w.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _jax_plan(case):
    _, kind, (sw, sh, nw, nh, c), tin, tout, plan_kw, *_ = case
    build = jax_build_resize_plan if kind == "avir" else jax_build_lancir_plan
    return build(sw, sh, nw, nh, c, W.NP_TYPES[tin], W.NP_TYPES[tout], **plan_kw)


def _flat(case) -> np.ndarray:
    src = W.source(case)
    sw, c, sp = case[2][0], case[2][4], case[7][1]
    return sharded.pad_rows(src.reshape(*src.shape[:-2], sw * c), sp)


def _jax_output(case) -> np.ndarray:
    name, kind, *_, ex_kw, (dp, sp), frames, _ = case
    devs = np.array(jax.devices()[: dp * sp])
    if frames:
        mesh, axes = Mesh(devs.reshape(dp, sp), ("dp", "sp")), dict(batch_axis="dp")
    else:
        mesh, axes = Mesh(devs, ("sp",)), {}
    engine = (
        dict(engine="xla") if name in JAX_XLA
        else dict(engine="pallas", interpret=True)
    )
    make = (
        jsh.make_sharded_avir_executor if kind == "avir"
        else jsh.make_sharded_lancir_executor
    )
    fn = make(_jax_plan(case), mesh, **axes, **engine, **ex_kw)
    return np.asarray(fn(_flat(case)))


def _single(case) -> np.ndarray:
    """The port's single-card resize of the case on the CPU, [.., new_h,
    new_w*C]."""
    _, kind, (sw, sh, nw, nh, c), tin, tout, plan_kw, ex_kw, *_ = case
    src = W.source(case)
    frames = src if src.ndim == 4 else src[None]
    if kind == "avir":
        rz = avir_tpu_torch.ImageResizer(res_bit_depth=plan_kw.get("res_bit_depth", 8))
        kw = {k: v for k, v in plan_kw.items() if k != "res_bit_depth"}
        kw.update((k, v) for k, v in ex_kw.items() if k in ("dither", "precision"))
        outs = [
            rz.resize(f, nw, nh, out_dtype=W.NP_TYPES[tout], device="cpu", **kw)
            for f in frames
        ]
    else:
        lz = avir_tpu_torch.LancIR()
        outs = [lz.resize(f, nw, nh, out_dtype=W.NP_TYPES[tout], device="cpu") for f in frames]
    out = np.stack([o.reshape(nh, nw * c) for o in outs])
    return out if src.ndim == 4 else out[0]


def _tol(case, ref: np.ndarray) -> float:
    """1 LSB, one 2^trunc_bits step, or max|ref| * 1e-4 for float."""
    tout, plan_kw = case[4], case[5]
    if tout == "f32":
        return float(np.abs(ref).max()) * 1e-4
    bits = 8 if tout == "u8" else 16
    trunc = bits - plan_kw.get("res_bit_depth", bits)
    out_max = (1 << bits) - 1
    return out_max / (out_max >> trunc) if trunc else 1.0


def _diff(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def _stub_mesh(sp: int, d: int) -> DpSpMesh:
    """Rank d of an sp mesh in this process: enough to build its executor
    and run its pure strip function (no collective)."""
    return DpSpMesh(dp=1, sp=sp, dp_index=0, sp_index=d, sp_group=None,
                    dp_group=None, device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

PLANNER_CASES = [
    # (src_h, new_h, n_dev): odd heights, the all-gather fallback (a wide
    # band over tiny strips), strips with no interior block, and one with.
    (256, 160, 1), (256, 160, 2), (256, 160, 3), (256, 160, 4), (256, 160, 8),
    (90, 62, 3), (97, 53, 4), (101, 149, 8), (77, 300, 2),
    (16, 8, 8), (16, 8, 4), (16, 5, 4), (400, 49, 8),
    (256, 128, 2), (1536, 768, 4), (1024, 512, 2),
]
SV_FIELDS = ("n_in", "n_out", "strip", "m", "halo_lo", "halo_hi", "win", "tile",
             "offs", "taps", "use_all_gather", "b_int0", "b_int1")


def _assert_sv_equal(got, want):
    for f in SV_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("src_h,new_h,n_dev", PLANNER_CASES)
@pytest.mark.parametrize("in_bytes", [1, 2])
def test_planner_fields_equal_jax(src_h, new_h, n_dev, in_bytes):
    dt = np.uint8 if in_bytes == 1 else np.uint16
    op = build_resize_plan(48, src_h, 32, new_h, 3, dt, dt).v.op
    jop = jax_build_resize_plan(48, src_h, 32, new_h, 3, dt, dt).v.op
    padded = src_h + (-src_h) % n_dev
    for tile in (64, 32):
        _assert_sv_equal(
            sharded.shard_v_op(op, n_dev, padded, tile=tile),
            jsh.shard_v_op(jop, n_dev, padded, tile=tile),
        )
    for tile in (None, 64):
        got = sharded.shard_v_blocked(op, n_dev, padded, tile=tile, in_bytes=in_bytes)
        _assert_sv_equal(
            got, jsh.shard_v_blocked(jop, n_dev, padded, tile=tile, in_bytes=in_bytes)
        )


def test_planner_covers_fallback_and_interior():
    """The planner cases reach the all-gather fallback, strips without an
    interior block and strips with one, and ranks that own only padding
    output rows."""
    seen = set()
    for src_h, new_h, n_dev in PLANNER_CASES:
        op = build_resize_plan(48, src_h, 32, new_h, 3, np.uint8, np.uint8).v.op
        sv = sharded.shard_v_op(op, n_dev, src_h + (-src_h) % n_dev)
        seen.add(
            "all_gather" if sv.use_all_gather
            else "interior" if sv.b_int1 > sv.b_int0 else "no_interior"
        )
        if (n_dev - 1) * sv.m >= new_h:
            seen.add("padding_rank")  # a rank that owns only padding rows
    assert seen == {"all_gather", "interior", "no_interior", "padding_rank"}


def test_pad_rows_matches_jax():
    x = np.arange(2 * 7 * 5, dtype=np.uint16).reshape(2, 7, 5)
    for n in (1, 2, 3, 4):
        np.testing.assert_array_equal(sharded.pad_rows(x, n), jsh.pad_rows(x, n))


# ---------------------------------------------------------------------------
# The assembled image from the gloo world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_jax_and_single_card(name, world):
    case = CASES[name]
    want = _jax_output(case)
    single = _single(case)
    out = world.result()
    got = np.load(out / f"{name}.npy")
    route = (out / f"{name}.json").read_text()
    assert f'"{ROUTES[name]}"' in route, route
    assert got.shape == want.shape == single.shape
    assert got.dtype == want.dtype
    if name in INT8:
        np.testing.assert_array_equal(got, want)
    else:
        assert _diff(got, want) <= _tol(case, want)
    assert _diff(got, single) <= _tol(case, single)


# ---------------------------------------------------------------------------
# One rank at a time, in this process
# ---------------------------------------------------------------------------


def _rank_rows(case, d: int):
    """(port strip of rank d, the JAX output's rows of rank d) for a
    kernel-route case."""
    name, kind, (sw, sh, nw, nh, c), *_, (dp, sp), frames, _ = case
    plan = W.port_plan(case)
    fn = W.make_executor(case, plan, _stub_mesh(sp, d))
    flat = torch.from_numpy(_flat(case))
    sv = fn.svop
    x = flat[d * sv.strip : (d + 1) * sv.strip].contiguous()
    rows = fn.strip(x, *sharded.halo_rows(flat, sv, d))
    return fn, rows, slice(d * sv.m, min((d + 1) * sv.m, nh))


@pytest.mark.parametrize(
    "name", ["avir_int8", "avir_int8_odd", "avir_int8_overlap", "avir_gamma_rgba",
             "lancir_int8", "avir_u16", "avir_f32"],
)
def test_rank_strips_match_jax(name):
    case = CASES[name]
    want = _jax_output(case)
    for d in range(case[7][1]):
        fn, rows, mine = _rank_rows(case, d)
        assert rows.shape[0] == fn.svop.m
        got = rows.numpy()[: mine.stop - mine.start]
        if name in INT8:
            assert fn.route == "int8"
            np.testing.assert_array_equal(got, want[mine], err_msg=f"rank {d}")
        else:
            assert _diff(got, want[mine]) <= _tol(case, want), f"rank {d}"


def test_overlap_launches_three_parts_with_the_same_bits():
    """halo_overlap=True splits a u8 strip into border, interior and
    border launches (the interior over the strip alone) and gives the bits
    of the one launch over the ext buffer."""
    case = CASES["avir_int8_overlap"]
    plan = W.port_plan(case)
    flat = torch.from_numpy(_flat(case))
    for d in range(4):
        split = W.make_executor(case, plan, _stub_mesh(4, d))
        one = sharded.make_sharded_avir_executor(plan, _stub_mesh(4, d), pallas_tile=64)
        assert [on_ext for _, on_ext in split.strip.parts] == [True, False, True]
        assert len(one.strip.parts) == 1
        sv = split.svop
        x = flat[d * sv.strip : (d + 1) * sv.strip].contiguous()
        halos = sharded.halo_rows(flat, sv, d)
        assert torch.equal(split.strip(x, *halos), one.strip(x, *halos))


def test_errdiff_predither_strips_match_jax_single_card():
    """With error diffusion the strip kernel emits the pre-dither float32
    image: each rank's rows within 255 * 1e-4 of the JAX package's
    single-card pre-dither image."""
    case = CASES["avir_errdiff"]
    sw, sh, nw, nh, c = case[2]
    jfn = jax_make_avir_executor(_jax_plan(case), errdiff=True, return_predither=True)
    want = np.asarray(jfn(W.source(case))).reshape(nh, nw * c)
    for d in range(4):
        fn, rows, mine = _rank_rows(case, d)
        assert rows.dtype == torch.float32 and fn.route == "split"
        assert _diff(rows.numpy()[: mine.stop - mine.start], want[mine]) <= 255 * 1e-4


def test_engine_and_input_checks():
    plan = build_resize_plan(48, 64, 24, 32, 3, np.uint8, np.uint8)
    mesh = _stub_mesh(2, 0)
    with pytest.raises(ValueError, match="precision='exact'"):
        sharded.make_sharded_avir_executor(plan, mesh, engine="xla")
    with pytest.raises(ValueError, match="unknown engine"):
        sharded.make_sharded_avir_executor(plan, mesh, engine="host")
    with pytest.raises(ValueError, match="unknown dither"):
        sharded.make_sharded_avir_executor(plan, mesh, dither="floyd")
    lplan = build_lancir_plan(48, 64, 24, 32, 3, np.uint8, np.uint8)
    with pytest.raises(ValueError, match="precision='exact'"):
        sharded.make_sharded_lancir_executor(lplan, mesh, engine="xla")
    fn = sharded.make_sharded_avir_executor(plan, mesh, engine="pallas")
    assert fn.route == "int8"
    with pytest.raises(ValueError, match="strip"):
        fn(torch.zeros((33, 48 * 3), dtype=torch.uint8))
