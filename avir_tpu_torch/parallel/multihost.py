"""Multi-process setup of the row-strip mesh.

Counterpart of the JAX package's ``parallel/multihost.py``: start
``torch.distributed`` and build the (dp, sp) mesh that
``parallel/sharded.py``'s executors run on, with the row strips (sp) on
the cards of one host and batch data-parallelism (dp) across hosts.

Typical use, the same program on every process, started by ``torchrun``
(which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``):

    from avir_tpu_torch.parallel import multihost, sharded
    multihost.initialize()                  # NCCL, one process per card
    mesh = multihost.make_dp_sp_mesh(sp=4)  # rows over 4 cards
    fn = sharded.make_sharded_avir_executor(plan, mesh)
    y = fn(sharded.local_strip(mesh, src))  # this rank's output rows

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


def make_dp_sp_mesh(sp: int | None = None, device=None) -> DpSpMesh:
    """The (dp, sp) mesh of the started process group, with a row-strip
    axis of ``sp`` ranks (default: all) and data parallelism over the
    rest (``multihost.py:48`` there).  Every rank must call it, in the
    same order as its other group creations.

    As the JAX helper asserts for its sp axis, an sp group that fits in
    one host must lie in one host (ranks are host-contiguous, as
    ``torchrun`` numbers them), so that halos never cross the network."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized (multihost.initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    sp = world if sp is None else sp
    if sp < 1 or world % sp:
        raise ValueError(f"world size {world} not divisible by sp={sp}")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if sp <= local_world and local_world % sp:
        raise ValueError(
            f"sp={sp} groups would cross host boundaries ({local_world} "
            "ranks per host): halos would ride the network"
        )
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = str(dist.get_backend()).lower()
    dev = mesh_device(backend, local_rank, local_world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dp = world // sp
    # new_group is collective: every rank creates every group, in order.
    rows = [dist.new_group(list(range(i * sp, (i + 1) * sp))) for i in range(dp)]
    cols = [dist.new_group(list(range(j, world, sp))) for j in range(sp)]
    return DpSpMesh(
        dp=dp, sp=sp, dp_index=rank // sp, sp_index=rank % sp,
        sp_group=rows[rank // sp], dp_group=cols[rank % sp], device=dev,
    )
