"""The collectives of the sharded meshes on ``torch.distributed``.

Counterpart of what the JAX package's ``parallel/sharded.py`` issues
inside its ``shard_map``: ``jax.lax.ppermute`` of the halo rows
(``_halo_permutes``) or, on the 2-D mesh, of the halo lanes, and
``jax.lax.all_gather`` of row strips or of column tiles.  Rows are axis
-2 and lanes axis -1 of every tensor here ([rows, lanes] or [frames,
rows, lanes]).  A lane slice is not contiguous: it is copied into one
before it goes.

Every transfer moves the bytes of a contiguous tensor as a uint8 view of
its last axis and views them back: NCCL has no 16-bit integer type, and
gloo's ``all_gather`` refuses int16 and uint16 ("Invalid scalar type"), so
a u16 image crosses either backend only as bytes.  The view changes no
bit.

Backends.  With NCCL the tensors on the card go as they are.  Gloo takes
CPU tensors only, so under gloo every collective here copies its rows to
host memory and the received rows back to the caller's device: a
property of the backend the caller chose (several gloo ranks may share
one card, which NCCL refuses).  Any other backend raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _backend(group) -> str:
    backend = str(dist.get_backend(group)).lower()
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r} for the mesh's collectives "
            f"(known: {', '.join(BACKENDS)})"
        )
    return backend


def _wire(t: torch.Tensor, backend: str) -> torch.Tensor:
    """``t`` as the contiguous uint8 tensor that goes over ``backend``."""
    t = t.contiguous()
    if backend == "gloo":
        t = t.cpu()
    return t.view(torch.uint8)


def _landing(shape, dtype: torch.dtype, device, backend: str) -> torch.Tensor:
    """A uint8 receive buffer for a tensor of ``shape`` and ``dtype``."""
    *lead, lanes = shape
    where = "cpu" if backend == "gloo" else device
    return torch.empty(
        (*lead, lanes * dtype.itemsize), dtype=torch.uint8, device=where
    )


def _unwire(buf: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    return buf.view(dtype).to(device)


def zeros_rows(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros of ``shape`` and ``dtype`` made as bytes (PyTorch's u16 has
    few ops of its own)."""
    *lead, lanes = shape
    return torch.zeros(
        (*lead, lanes * dtype.itemsize), dtype=torch.uint8, device=device
    ).view(dtype)


@dataclasses.dataclass
class PendingHalos:
    """The halo exchange in flight: ``wait()`` returns (h_lo, h_hi)."""

    works: list
    ops: list  # the posted P2POps: they hold the send buffers until wait()
    h_lo: torch.Tensor
    h_hi: torch.Tensor
    recv_lo: torch.Tensor | None
    recv_hi: torch.Tensor | None
    dtype: torch.dtype
    device: torch.device

    def wait(self) -> tuple[torch.Tensor, torch.Tensor]:
        for w in self.works:
            w.wait()
        h_lo, h_hi = self.h_lo, self.h_hi
        if self.recv_lo is not None:
            h_lo = _unwire(self.recv_lo, self.dtype, self.device)
        if self.recv_hi is not None:
            h_hi = _unwire(self.recv_hi, self.dtype, self.device)
        return h_lo, h_hi


def _exchange(x: torch.Tensor, lo: int, hi: int, dim: int, group, async_op: bool):
    """The two halo transfers of ``x`` along ``dim`` (-2 rows, -1 lanes)
    over ``group``: rank i receives the last ``lo`` of rank i-1 and the
    first ``hi`` of rank i+1, zeros where there is no such rank."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)

    def shape(k):
        s = list(x.shape)
        s[dim] = k
        return tuple(s)

    h_lo = zeros_rows(shape(lo), x.dtype, x.device)
    h_hi = zeros_rows(shape(hi), x.dtype, x.device)
    ops, recv_lo, recv_hi = [], None, None
    if (lo or hi) and n > 1:
        backend = _backend(group)

        def peer(r: int) -> int:
            return dist.get_global_rank(group, r) if group is not None else r

        if lo and rank + 1 < n:
            ops.append(dist.P2POp(dist.isend, _wire(x.narrow(dim, x.shape[dim] - lo, lo), backend), peer(rank + 1), group))
        if lo and rank > 0:
            recv_lo = _landing(shape(lo), x.dtype, x.device, backend)
            ops.append(dist.P2POp(dist.irecv, recv_lo, peer(rank - 1), group))
        if hi and rank > 0:
            ops.append(dist.P2POp(dist.isend, _wire(x.narrow(dim, 0, hi), backend), peer(rank - 1), group))
        if hi and rank + 1 < n:
            recv_hi = _landing(shape(hi), x.dtype, x.device, backend)
            ops.append(dist.P2POp(dist.irecv, recv_hi, peer(rank + 1), group))
    works = dist.batch_isend_irecv(ops) if ops else []
    pending = PendingHalos(works, ops, h_lo, h_hi, recv_lo, recv_hi, x.dtype, x.device)
    return pending if async_op else pending.wait()


def exchange_halos(x: torch.Tensor, svop, group=None, async_op: bool = False):
    """The two halo transfers of a row strip ``x`` [..., strip, lanes]
    (``_halo_permutes`` there): rank i of ``group`` receives the last
    ``svop.halo_lo`` rows of rank i-1 and the first ``svop.halo_hi`` rows
    of rank i+1.  Where ``ppermute`` has no source, on the first rank's
    low halo and the last rank's high halo, the halo is zeros of the same
    shape: the ext buffer's layout (and so every window offset) assumes
    ``halo_lo`` rows above every strip.  All four transfers go in one
    ``batch_isend_irecv``, so no order of posting can deadlock.

    Returns (h_lo, h_hi) on ``x``'s device, or with ``async_op`` a
    ``PendingHalos`` whose ``wait()`` returns them."""
    return _exchange(x, svop.halo_lo, svop.halo_hi, -2, group, async_op)


def exchange_col_halos(x: torch.Tensor, slb, group=None, async_op: bool = False):
    """The column halos of a tile ``x`` [..., rows, lanes] on the 2-D mesh
    (the cols-axis ``ppermute`` of ``_pallas_strip_fn_2d`` there): rank j
    of ``group`` (its row band) receives the last ``slb.halo_lo`` lanes of
    rank j-1 and the first ``slb.halo_hi`` lanes of rank j+1, zeros on the
    edges, as ``exchange_halos`` does for rows; the lane slices go as
    contiguous copies, in one ``batch_isend_irecv``.  Returns (c_lo, c_hi)
    [..., rows, halo] or a ``PendingHalos``."""
    return _exchange(x, slb.halo_lo, slb.halo_hi, -1, group, async_op)


def _all_gather(y: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return y
    backend = _backend(group)
    send = _wire(y, backend)
    bufs = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(bufs, send, group=group)
    # Along the lanes the uint8 views hold whole elements of each rank.
    return _unwire(torch.cat(bufs, dim=dim), y.dtype, y.device)


def all_gather_rows(y: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``y`` [..., rows, lanes] (one shape on every rank) of
    ``group``, concatenated along the rows in rank order, on ``y``'s
    device (``jax.lax.all_gather(..., tiled=True)`` there)."""
    return _all_gather(y, group, -2)


def all_gather_tiles(y: torch.Tensor, cp_group=None, sp_group=None) -> torch.Tensor:
    """The whole (padded) image from every rank's tile ``y`` [..., rows,
    lanes] of a 2-D mesh: the tiles of the row band (``cp_group``)
    concatenated along the lanes, then the row bands (``sp_group``) along
    the rows (``sharded.py:2514-2515`` there)."""
    return _all_gather(_all_gather(y, cp_group, -1), sp_group, -2)
