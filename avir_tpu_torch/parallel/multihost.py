"""Multi-process setup of the sharded meshes.

Counterpart of the JAX package's ``parallel/multihost.py``: start
``torch.distributed`` and build the (dp, sp) mesh that
``parallel/sharded.py``'s row-strip executors run on, with the row strips
(sp) on the cards of one host and batch data-parallelism (dp) across
hosts, or the (dp, sp, cp) mesh of its 2-D (rows x cols) executors, whose
tiles split the rows over sp and the columns over cp.

Typical use, the same program on every process, started by ``torchrun``
(which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``):

    from avir_tpu_torch.parallel import multihost, sharded
    multihost.initialize()                  # NCCL, one process per card
    mesh = multihost.make_dp_sp_mesh(sp=4)  # rows over 4 cards
    fn = sharded.make_sharded_avir_executor(plan, mesh)
    y = fn(sharded.local_strip(mesh, src))  # this rank's output rows

    mesh2 = multihost.make_dp_sp_cp_mesh(sp=2, cp=2)  # 2 x 2 tiles
    fn2 = sharded.make_sharded_avir_executor_2d(plan, mesh2)
    y2 = fn2(sharded.local_tile(mesh2, src2))  # src2: pad_rows + pad_cols

Several processes may share one card only under gloo, whose collectives
go through host memory (``parallel/comm.py``):
``initialize(backend="gloo", ...)``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def initialize(
    backend: str = "nccl",
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Start ``torch.distributed``; returns whether this call started it.

    A no-op when it is already initialized, and for a single process
    given no rendezvous: no arguments and no ``RANK`` / ``WORLD_SIZE`` in
    the environment (as ``jax.distributed.initialize`` is there).  Without
    ``init_method`` the rendezvous is ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them).
    Every rendezvous and collective waits at most ``timeout``."""
    if dist.is_initialized():
        return False
    given = (init_method, world_size, rank) != (None, None, None)
    if not given and "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, timeout=timeout,
    )
    return True


@dataclasses.dataclass(frozen=True)
class DpSpMesh:
    """A (dp, sp) mesh of the processes of ``torch.distributed``, the sp
    axis minor: rank r is (dp_index, sp_index) = (r // sp, r % sp).  Each
    rank's groups are its row of the mesh (``sp_group``, the ranks that
    share one image's strips) and its column (``dp_group``)."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    sp_group: object
    dp_group: object
    device: torch.device


def mesh_device(
    backend: str, local_rank: int, local_world: int, device=None
) -> torch.device:
    """The device of a rank: ``device``, or with None the card
    ``cuda:(local_rank % device_count)``, which raises without a card.
    NCCL moves CUDA tensors between distinct cards, so under NCCL the
    device must be a card and the host must have a card for each of its
    ``local_world`` ranks; gloo ranks may share one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (with the "
                "gloo backend) to run the kernels' plain PyTorch versions"
            )
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL moves CUDA tensors; the device is {device}")
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"NCCL refuses two ranks on one card: {local_world} ranks on "
                f"this host, {cards} card(s); use the gloo backend to share one"
            )
    return device


def _initialized() -> tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized (multihost.initialize)")
    return dist.get_world_size(), dist.get_rank()


def _block_device(world: int, rank: int, block: int, what: str, device):
    """The rank's device for a mesh whose image groups hold ``block``
    ranks (``what`` names them in errors), after the host rule."""
    if block < 1 or world % block:
        raise ValueError(f"world size {world} not divisible by {what}")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if block <= local_world and local_world % block:
        raise ValueError(
            f"{what} groups would cross host boundaries ({local_world} "
            "ranks per host): halos would ride the network"
        )
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = str(dist.get_backend()).lower()
    dev = mesh_device(backend, local_rank, local_world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_dp_sp_mesh(sp: int | None = None, device=None) -> DpSpMesh:
    """The (dp, sp) mesh of the started process group, with a row-strip
    axis of ``sp`` ranks (default: all) and data parallelism over the
    rest (``multihost.py:48`` there).  Every rank must call it, in the
    same order as its other group creations.

    As the JAX helper asserts for its sp axis, an sp group that fits in
    one host must lie in one host (ranks are host-contiguous, as
    ``torchrun`` numbers them), so that halos never cross the network."""
    world, rank = _initialized()
    sp = world if sp is None else sp
    dev = _block_device(world, rank, sp, f"sp={sp}", device)
    dp = world // sp
    # new_group is collective: every rank creates every group, in order.
    rows = [dist.new_group(list(range(i * sp, (i + 1) * sp))) for i in range(dp)]
    cols = [dist.new_group(list(range(j, world, sp))) for j in range(sp)]
    return DpSpMesh(
        dp=dp, sp=sp, dp_index=rank // sp, sp_index=rank % sp,
        sp_group=rows[rank // sp], dp_group=cols[rank % sp], device=dev,
    )


@dataclasses.dataclass(frozen=True)
class DpSpCpMesh:
    """A (dp, sp, cp) mesh of the processes of ``torch.distributed`` for
    the 2-D (rows x cols) executors, cp minor: rank = (dp_index * sp +
    sp_index) * cp + cp_index, the layout of ``jax.make_mesh((dp, sp,
    cp), ("dp", "sp", "cp"))``.  Rank (d, i, j) holds tile (i, j) of an
    image of frame group d.  Its groups: ``cp_group``, the ranks of its
    row band (same d and i: the column halos), ``sp_group``, those of its
    column band (same d and j: the row halos), and ``dp_group``, those of
    its tile in the other frame groups (same i and j)."""

    dp: int
    sp: int
    cp: int
    dp_index: int
    sp_index: int
    cp_index: int
    sp_group: object
    cp_group: object
    dp_group: object
    device: torch.device


def make_dp_sp_cp_mesh(sp: int, cp: int, device=None) -> DpSpCpMesh:
    """The (dp, sp, cp) mesh of the started process group: tiles of
    ``sp`` row bands x ``cp`` column bands an image, data parallelism over
    the rest.  Every rank must call it, in the same order as its other
    group creations.  An sp x cp block that fits in one host must lie in
    one host, as ``make_dp_sp_mesh``'s sp group must."""
    world, rank = _initialized()
    dev = _block_device(world, rank, sp * cp, f"sp x cp = {sp} x {cp}", device)
    dp = world // (sp * cp)

    def rank_of(d, i, j):
        return (d * sp + i) * cp + j

    # new_group is collective: every rank creates every group, in order.
    groups = {}
    for d in range(dp):
        for i in range(sp):
            groups["cp", d, i] = dist.new_group([rank_of(d, i, j) for j in range(cp)])
    for d in range(dp):
        for j in range(cp):
            groups["sp", d, j] = dist.new_group([rank_of(d, i, j) for i in range(sp)])
    for i in range(sp):
        for j in range(cp):
            groups["dp", i, j] = dist.new_group([rank_of(d, i, j) for d in range(dp)])
    d, rest = divmod(rank, sp * cp)
    i, j = divmod(rest, cp)
    return DpSpCpMesh(
        dp=dp, sp=sp, cp=cp, dp_index=d, sp_index=i, cp_index=j,
        sp_group=groups["sp", d, j], cp_group=groups["cp", d, i],
        dp_group=groups["dp", i, j], device=dev,
    )
