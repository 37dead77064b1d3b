"""The port's mesh helpers and collectives (avir_tpu_torch/parallel/
multihost.py, comm.py): the (dp, sp) mesh of a gloo world of 4 CPU
processes (tests/torch_mesh_worker.py's ``multihost`` suite) against the
JAX helper's shapes (tests/mesh/sharded_mesh.py:120), ``initialize`` as a
no-op, the device rules, and halos and gathers of u16 rows above 32767."""

import json

import pytest
import torch
import torch.distributed as dist

from test_torch_sharded import WORLD, World

from avir_tpu_torch.parallel import comm, multihost


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    w = World("multihost", tmp_path_factory.mktemp("torch_multihost"))
    out = w.result()
    return [json.loads((out / f"multihost_{r}.json").read_text()) for r in range(WORLD)]


def test_mesh_shapes_and_groups(seen):
    for rank, s in enumerate(seen):
        # All ranks on the sp axis (make_dp_sp_mesh() there: sp 8, dp 1).
        assert s["sp4"] == dict(
            dp=1, sp=4, dp_index=0, sp_index=rank, device="cpu",
            sp_peers=[0, 1, 2, 3], dp_peers=[rank],
        )
        # sp minor: rank = dp_index * sp + sp_index (make_dp_sp_mesh(sp=4)
        # on 8 devices there: sp 4, dp 2).
        dp_i, sp_i = divmod(rank, 2)
        assert s["sp2"] == dict(
            dp=2, sp=2, dp_index=dp_i, sp_index=sp_i, device="cpu",
            sp_peers=[2 * dp_i, 2 * dp_i + 1], dp_peers=[sp_i, sp_i + 2],
        )


def test_initialize_is_a_no_op(seen, monkeypatch):
    # Already initialized (in the world) ...
    assert all(s["initialize_again"] is False for s in seen)
    # ... and a single process with no rendezvous in its environment.
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        multihost.make_dp_sp_mesh()


def test_u16_halos_round_trip_above_32767(seen):
    """Rank r's strip holds 40000 + 1000 r + i (5 rows of 6): its low halo
    is rank r-1's last 2 rows, its high halo rank r+1's first 3, zeros on
    the edge ranks; every value above 32767 comes back as it went."""
    def rows(r, lo, hi):
        return [[40000 + 1000 * r + 6 * i + j for j in range(6)] for i in range(lo, hi)]

    for r, s in enumerate(seen):
        h = s["halos"]
        assert h["dtype"] == "torch.uint16"
        assert h["h_lo"] == (rows(r - 1, 3, 5) if r > 0 else [[0] * 6] * 2)
        assert h["h_hi"] == (rows(r + 1, 0, 3) if r < WORLD - 1 else [[0] * 6] * 3)
        assert h["batched_equal"]
        assert h["gathered"] == [row for q in range(WORLD) for row in rows(q, 0, 5)]
        assert h["f32_gather"] == [[q + 0.5] * 2 for q in range(WORLD)]


def test_nccl_refuses_a_shared_card(seen):
    for s in seen:
        assert s["nccl_shared_card"].startswith("ValueError: NCCL refuses two ranks")
        assert s["nccl_one_rank"] == "cuda:0"
        assert s["nccl_cpu"].startswith("ValueError: NCCL moves CUDA tensors")


def test_mesh_device_rules(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.mesh_device("gloo", 0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.mesh_device("nccl", 0, 1)
    assert multihost.mesh_device("gloo", 3, 4, device="cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    # The default device is the card local_rank % count; gloo ranks share.
    assert multihost.mesh_device("gloo", 3, 4) == torch.device("cuda", 1)
    assert multihost.mesh_device("nccl", 1, 2) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        multihost.mesh_device("nccl", 1, 3)


def test_unknown_backend_raises(monkeypatch):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "mpi")
    with pytest.raises(ValueError, match="unknown backend 'mpi'"):
        comm._backend(None)


def test_dp_sp_cp_mesh_shapes_groups_and_rank_order(seen):
    """rank = (dp_index * sp + sp_index) * cp + cp_index, cp minor, as
    jax.make_mesh((dp, sp, cp), ("dp", "sp", "cp")) lays the devices
    (tests/mesh/sharded_mesh.py:449); cp_group is the rank's row band,
    sp_group its column band, dp_group its tile in the other frame groups."""
    for rank, s in enumerate(seen):
        for sp, cp in ((2, 2), (1, 2), (1, 4)):
            dp = WORLD // (sp * cp)
            d, rest = divmod(rank, sp * cp)
            i, j = divmod(rest, cp)

            def rank_of(d_, i_, j_):
                return (d_ * sp + i_) * cp + j_

            assert s[f"dp_sp_cp_{sp}x{cp}"] == dict(
                dp=dp, sp=sp, cp=cp, index=[d, i, j], device="cpu",
                cp_peers=[rank_of(d, i, q) for q in range(cp)],
                sp_peers=[rank_of(d, q, j) for q in range(sp)],
                dp_peers=[rank_of(q, i, j) for q in range(dp)],
            )


def test_u16_column_halos_and_tile_gather(seen):
    """On the 2 x 2 mesh rank r's tile holds 40000 + 1000 r + i (3 rows of
    7 lanes): its low column halo is the last 2 lanes of its left
    neighbour in the row band, its high one the first 3 of its right one,
    zeros on the edges; the tile gather is the 6 x 14 image."""
    def tile(r):
        return [[40000 + 1000 * r + 7 * i + k for k in range(7)] for i in range(3)]

    for r, s in enumerate(seen):
        h = s["col_halos"]
        j = r % 2
        left = [row[5:] for row in tile(r - 1)] if j == 1 else [[0, 0]] * 3
        right = [row[:3] for row in tile(r + 1)] if j == 0 else [[0, 0, 0]] * 3
        assert h["dtype"] == "torch.uint16"
        assert h["c_lo"] == left and h["c_hi"] == right
        assert h["batched_equal"]
        rows = [tile(2 * i)[k] + tile(2 * i + 1)[k] for i in range(2) for k in range(3)]
        assert h["tiles"] == rows


def test_dp_sp_cp_mesh_needs_a_world(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="not initialized"):
        multihost.make_dp_sp_cp_mesh(2, 2)
