"""One rank of the port's meshes on the CPU, for the gloo worlds of
tests/test_torch_sharded.py, tests/test_torch_sharded_2d.py and
tests/test_torch_multihost.py (not a test module itself):

    python tests/torch_mesh_worker.py SUITE INIT_METHOD RANK WORLD OUTDIR

``sharded`` runs every case of ``CASES`` through the port's row-strip
executors on ``device="cpu"`` (the kernels' plain versions) and rank 0
writes each assembled image to OUTDIR/<case>.npy; ``sharded2d`` does the
same with ``CASES_2D`` on the 2-D (rows x cols) executors, and each rank
also writes its route and its count of K1 calls a frame to
OUTDIR/<case>_r<rank>.json; ``multihost`` writes what each rank saw of the
mesh helpers and collectives to OUTDIR/multihost_<rank>.json.  Imports no
JAX."""

from __future__ import annotations

import datetime
import json
import pathlib
import sys
import types
from unittest import mock

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (name, kind, (src_w, src_h, new_w, new_h, c), in type, out type,
#  plan kwargs, executor kwargs, (dp, sp), frames, seed)
CASES = (
    ("avir_int8", "avir", (96, 256, 64, 160, 3), "u8", "u8", {}, {}, (1, 4), 0, 11),
    # An odd height (pad_rows) and an ext buffer shorter than the windows.
    ("avir_int8_odd", "avir", (70, 90, 50, 62, 3), "u8", "u8", {}, {}, (1, 4), 0, 12),
    # Interior blocks [1, 2) of 3: border, interior and border launches.
    ("avir_int8_overlap", "avir", (32, 1536, 16, 768, 3), "u8", "u8", {},
     dict(pallas_tile=64, halo_overlap=True), (1, 4), 0, 13),
    ("avir_gamma_rgba", "avir", (64, 128, 32, 64, 4), "u8", "u8",
     dict(use_srgb_gamma=True, alpha_index=3), {}, (1, 4), 0, 14),
    ("avir_u16", "avir", (64, 128, 48, 96, 3), "u16", "u16",
     dict(res_bit_depth=16), {}, (1, 4), 0, 15),
    ("avir_u16_gamma_rgba", "avir", (64, 128, 48, 96, 4), "u16", "u16",
     dict(res_bit_depth=16, use_srgb_gamma=True, alpha_index=3), {}, (1, 4), 0, 16),
    ("avir_f32", "avir", (70, 90, 50, 62, 3), "f32", "f32", {}, {}, (1, 4), 0, 17),
    ("avir_errdiff", "avir", (96, 256, 64, 160, 3), "u8", "u8", {},
     dict(dither="errdiff"), (1, 4), 0, 18),
    ("avir_errdiff_device_u16", "avir", (64, 128, 32, 64, 3), "u16", "u16",
     dict(res_bit_depth=12), dict(dither="errdiff-device"), (1, 4), 0, 19),
    # The all-gather fallback, and a rank that owns only padding rows.
    ("avir_all_gather", "avir", (64, 16, 32, 5, 3), "u8", "u8", {}, {}, (1, 4), 0, 20),
    ("avir_exact", "avir", (32, 1536, 16, 768, 3), "u8", "u8", {},
     dict(precision="exact"), (1, 4), 0, 21),
    ("avir_batch", "avir", (48, 64, 24, 32, 3), "u8", "u8", {}, {}, (2, 2), 4, 22),
    ("lancir_int8", "lancir", (96, 256, 64, 160, 3), "u8", "u8", {}, {}, (1, 4), 0, 23),
    ("lancir_u16", "lancir", (64, 128, 48, 96, 2), "u16", "u16", {}, {}, (1, 4), 0, 24),
    ("lancir_f32", "lancir", (64, 128, 48, 96, 3), "u8", "f32", {}, {}, (1, 4), 0, 25),
)
NP_TYPES = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}

# The 2-D mesh: (name, kind, (src_w, src_h, new_w, new_h, c), in type, out
# type, plan kwargs, executor kwargs, (dp, sp, cp), frames, seed).
CASES_2D = (
    # lanes_pad % C != 0 at cp = 2 (the tile is not padded to it).
    ("avir_int8_2x2", "avir", (256, 192, 128, 96, 3), "u8", "u8", {}, {}, (1, 2, 2), 0, 808),
    ("avir_int8_1x4", "avir", (256, 192, 128, 96, 3), "u8", "u8", {}, {}, (1, 1, 4), 0, 811),
    # halo_lo rounded to C only; a tile whose lanes are not a multiple of 4.
    ("avir_int8_odd_1x4", "avir", (70, 90, 50, 62, 3), "u8", "u8", {}, {}, (1, 1, 4), 0, 812),
    # Interior blocks on both axes: three launches.
    ("avir_int8_overlap", "avir", (1200, 400, 600, 200, 3), "u8", "u8", {},
     dict(pallas_tile=32, halo_overlap=True), (1, 2, 2), 0, 914),
    ("avir_gamma_rgba_odd", "avir", (70, 90, 50, 62, 4), "u8", "u8",
     dict(use_srgb_gamma=True, alpha_index=3), {}, (1, 2, 2), 0, 912),
    ("avir_gamma_rgba_up", "avir", (70, 90, 110, 130, 4), "u8", "u8",
     dict(use_srgb_gamma=True, alpha_index=3), {}, (1, 2, 2), 0, 909),
    ("avir_u16_up", "avir", (128, 96, 192, 256, 4), "u16", "u16",
     dict(res_bit_depth=16), {}, (1, 2, 2), 0, 913),
    ("avir_u16_gamma_rgba_odd", "avir", (70, 90, 50, 62, 4), "u16", "u16",
     dict(res_bit_depth=16, use_srgb_gamma=True, alpha_index=0), {}, (1, 2, 2), 0, 915),
    ("avir_f32_odd", "avir", (70, 90, 50, 62, 3), "f32", "f32", {}, {}, (1, 2, 2), 0, 916),
    ("avir_errdiff_batch", "avir", (48, 64, 24, 32, 3), "u8", "u8", {},
     dict(dither="errdiff"), (2, 1, 2), 2, 5),
    ("avir_errdiff_device_u16", "avir", (64, 128, 32, 64, 3), "u16", "u16",
     dict(res_bit_depth=12), dict(dither="errdiff-device"), (1, 2, 2), 0, 917),
    # The library route: precision="exact", and an axis whose halos exceed
    # its strips (the all-gather), with ranks that own only padding.
    ("avir_exact", "avir", (256, 192, 128, 96, 3), "u8", "u8", {},
     dict(precision="exact"), (1, 2, 2), 0, 918),
    ("avir_all_gather_rows", "avir", (64, 16, 32, 5, 3), "u8", "u8", {}, {}, (1, 4, 1), 0, 919),
    ("avir_all_gather_cols", "avir", (16, 64, 5, 32, 3), "u8", "u8", {}, {}, (1, 1, 4), 0, 924),
    ("lancir_int8", "lancir", (256, 192, 128, 96, 3), "u8", "u8", {}, {}, (1, 2, 2), 0, 920),
    ("lancir_u16_odd", "lancir", (70, 90, 110, 130, 4), "u16", "u16", {}, {}, (1, 2, 2), 0, 921),
    ("lancir_batch", "lancir", (48, 64, 24, 32, 3), "u8", "u8", {}, {}, (2, 1, 2), 2, 930),
    ("lancir_exact", "lancir", (256, 192, 128, 96, 3), "u8", "u8", {},
     dict(precision="exact"), (1, 2, 2), 0, 922),
    ("lancir_f32", "lancir", (64, 128, 48, 96, 3), "u8", "f32", {}, {}, (1, 2, 2), 0, 923),
)


def source(case) -> np.ndarray:
    """The case's input, [frames, H, W, C] or [H, W, C]."""
    _, _, (sw, sh, _, _, c), tin, *_, frames, seed = case
    gen = np.random.default_rng(seed)
    shape = ((frames,) if frames else ()) + (sh, sw, c)
    if tin == "f32":
        return gen.random(shape, dtype=np.float32)
    return gen.integers(0, np.iinfo(NP_TYPES[tin]).max + 1, shape, dtype=NP_TYPES[tin])


def port_plan(case):
    from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
    from avir_tpu_torch.plan.plan import build_resize_plan

    _, kind, (sw, sh, nw, nh, c), tin, tout, plan_kw, *_ = case
    build = build_resize_plan if kind == "avir" else build_lancir_plan
    return build(sw, sh, nw, nh, c, NP_TYPES[tin], NP_TYPES[tout], **plan_kw)


def make_executor(case, plan, mesh):
    from avir_tpu_torch.parallel import sharded

    kind, ex_kw = case[1], case[6]
    make = (
        sharded.make_sharded_avir_executor if kind == "avir"
        else sharded.make_sharded_lancir_executor
    )
    return make(plan, mesh, **ex_kw)


def _sharded(outdir: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist

    from avir_tpu_torch.parallel import multihost, sharded

    meshes = {}
    for case in CASES:
        name, _, (sw, sh, nw, nh, c), *_, (dp, sp), frames, _ = case
        if (dp, sp) not in meshes:
            meshes[dp, sp] = multihost.make_dp_sp_mesh(sp=sp, device="cpu")
        mesh = meshes[dp, sp]
        plan = port_plan(case)
        fn = make_executor(case, plan, mesh)
        src = source(case)
        flat = sharded.pad_rows(src.reshape(*src.shape[:-2], sw * c), sp)
        y = fn(torch.from_numpy(np.ascontiguousarray(sharded.local_strip(mesh, flat))))
        full = sharded.assemble(mesh, y, nh)
        if dist.get_rank() == 0:
            np.save(outdir / f"{name}.npy", full.numpy())
            (outdir / f"{name}.json").write_text(json.dumps({"route": fn.route}))


def make_executor_2d(case, plan, mesh):
    from avir_tpu_torch.parallel import sharded

    kind, ex_kw = case[1], case[6]
    make = (
        sharded.make_sharded_avir_executor_2d if kind == "avir"
        else sharded.make_sharded_lancir_executor_2d
    )
    return make(plan, mesh, **ex_kw)


def flat_2d(case) -> np.ndarray:
    """The case's input as [frames, H_pad, W_pad*C] or [H_pad, W_pad*C]."""
    from avir_tpu_torch.parallel import sharded

    _, _, (sw, sh, _, _, c), *_, (_, sp, cp), _, _ = case
    src = source(case)
    return sharded.pad_cols(sharded.pad_rows(src.reshape(*src.shape[:-2], sw * c), sp), cp, c)


def _sharded_2d(outdir: pathlib.Path, rank: int) -> None:
    import torch

    from avir_tpu_torch.parallel import multihost, sharded

    k1 = sharded._k1
    calls = [0]

    def counted(ops, x):
        calls[0] += 1
        return k1(ops, x)

    sharded._k1 = counted
    meshes = {}
    for case in CASES_2D:
        name, _, (sw, sh, nw, nh, c), *_, (dp, sp, cp), frames, _ = case
        if (dp, sp, cp) not in meshes:
            meshes[dp, sp, cp] = multihost.make_dp_sp_cp_mesh(sp=sp, cp=cp, device="cpu")
        mesh = meshes[dp, sp, cp]
        fn = make_executor_2d(case, port_plan(case), mesh)
        calls[0] = 0
        y = fn(torch.from_numpy(np.ascontiguousarray(sharded.local_tile(mesh, flat_2d(case)))))
        per_frame = calls[0] / (frames // dp if frames else 1)
        full = sharded.assemble_2d(mesh, y, nh, nw * c)
        (outdir / f"{name}_r{rank}.json").write_text(json.dumps({
            "route": fn.route, "k1_calls_a_frame": per_frame,
            "parts": None if fn.tile is None else [on for _, on in fn.tile.parts],
            "tile_out": list(y.shape),
        }))
        if rank == 0:
            np.save(outdir / f"{name}.npy", full.numpy())


def _multihost(outdir: pathlib.Path, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from avir_tpu_torch.parallel import comm, multihost
    from avir_tpu_torch.parallel.sharded import ShardedVOp

    seen = {"initialize_again": multihost.initialize(backend="gloo")}
    for sp in (4, 2):
        mesh = multihost.make_dp_sp_mesh(sp=sp, device="cpu")
        peers = comm.all_gather_rows(torch.tensor([[rank]]), mesh.sp_group)
        cols = comm.all_gather_rows(torch.tensor([[rank]]), mesh.dp_group)
        seen[f"sp{sp}"] = dict(
            dp=mesh.dp, sp=mesh.sp, dp_index=mesh.dp_index, sp_index=mesh.sp_index,
            device=str(mesh.device), sp_peers=peers.ravel().tolist(),
            dp_peers=cols.ravel().tolist(),
        )
    # Halos of u16 rows above 32767 over the 4-rank row group, and an
    # all-gather of them: the bits must come back as they went.
    mesh = multihost.make_dp_sp_mesh(sp=4, device="cpu")
    x = (40000 + 1000 * rank + torch.arange(5 * 6, dtype=torch.int32)).reshape(5, 6)
    x = x.to(torch.uint16)
    svop = ShardedVOp(
        n_in=20, n_out=20, strip=5, m=5, halo_lo=2, halo_hi=3, win=0, tile=0,
        offs=np.zeros((4, 1), np.int32), taps=np.zeros((4, 1, 0, 0), np.float32),
        use_all_gather=False,
    )
    h_lo, h_hi = comm.exchange_halos(x, svop, mesh.sp_group)
    pend = comm.exchange_halos(x[None].expand(2, 5, 6), svop, mesh.sp_group, async_op=True)
    b_lo, b_hi = pend.wait()
    gathered = comm.all_gather_rows(x, mesh.sp_group)
    seen["halos"] = dict(
        dtype=str(h_lo.dtype),
        h_lo=h_lo.to(torch.int32).tolist(), h_hi=h_hi.to(torch.int32).tolist(),
        batched_equal=bool(
            torch.equal(b_lo[1].view(torch.int16), h_lo.view(torch.int16))
            and torch.equal(b_hi[0].view(torch.int16), h_hi.view(torch.int16))
        ),
        gathered=gathered.to(torch.int32).tolist(),
        f32_gather=comm.all_gather_rows(torch.full((1, 2), rank + 0.5), mesh.sp_group).tolist(),
    )
    # NCCL refuses two ranks on one card: four ranks on a host of one card.
    with mock.patch.object(torch.cuda, "device_count", lambda: 1):
        try:
            multihost.mesh_device("nccl", rank, 4, device="cuda:0")
            seen["nccl_shared_card"] = "no error"
        except ValueError as e:
            seen["nccl_shared_card"] = f"ValueError: {e}"
        seen["nccl_one_rank"] = str(multihost.mesh_device("nccl", 0, 1, device="cuda:0"))
    try:
        multihost.mesh_device("nccl", rank, 1, device="cpu")
        seen["nccl_cpu"] = "no error"
    except ValueError as e:
        seen["nccl_cpu"] = f"ValueError: {e}"
    # The (dp, sp, cp) meshes, cp minor, and the 2-D collectives: column
    # halos of u16 lanes above 32767 over the row band, and a tile gather.
    for sp, cp in ((2, 2), (1, 2), (1, 4)):
        m2 = multihost.make_dp_sp_cp_mesh(sp=sp, cp=cp, device="cpu")
        me = torch.tensor([[rank]])
        seen[f"dp_sp_cp_{sp}x{cp}"] = dict(
            dp=m2.dp, sp=m2.sp, cp=m2.cp, index=[m2.dp_index, m2.sp_index, m2.cp_index],
            device=str(m2.device),
            cp_peers=comm.all_gather_rows(me, m2.cp_group).ravel().tolist(),
            sp_peers=comm.all_gather_rows(me, m2.sp_group).ravel().tolist(),
            dp_peers=comm.all_gather_rows(me, m2.dp_group).ravel().tolist(),
        )
    m2 = multihost.make_dp_sp_cp_mesh(sp=2, cp=2, device="cpu")
    t = (40000 + 1000 * rank + torch.arange(3 * 7, dtype=torch.int32)).reshape(3, 7).to(torch.uint16)
    slb = types.SimpleNamespace(halo_lo=2, halo_hi=3)
    c_lo, c_hi = comm.exchange_col_halos(t, slb, m2.cp_group)
    p_lo, p_hi = comm.exchange_col_halos(t[None].expand(2, 3, 7), slb, m2.cp_group, async_op=True).wait()
    seen["col_halos"] = dict(
        dtype=str(c_lo.dtype), c_lo=c_lo.to(torch.int32).tolist(), c_hi=c_hi.to(torch.int32).tolist(),
        batched_equal=bool(
            torch.equal(p_lo[1].view(torch.int16), c_lo.view(torch.int16))
            and torch.equal(p_hi[0].view(torch.int16), c_hi.view(torch.int16))
        ),
        tiles=comm.all_gather_tiles(t, m2.cp_group, m2.sp_group).to(torch.int32).tolist(),
    )
    (outdir / f"multihost_{rank}.json").write_text(json.dumps(seen))


def main(argv) -> int:
    suite, init_method, rank, world, outdir = argv
    rank, world, outdir = int(rank), int(world), pathlib.Path(outdir)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from avir_tpu_torch.parallel import multihost

    multihost.initialize(
        backend="gloo", init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        if suite == "sharded":
            _sharded(outdir)
        elif suite == "sharded2d":
            _sharded_2d(outdir, rank)
        elif suite == "multihost":
            _multihost(outdir, rank)
        else:
            raise ValueError(f"unknown suite {suite!r}")
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
