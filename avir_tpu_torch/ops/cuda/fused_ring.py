"""K6: the shift-ring int8 sRGB-gamma resize, its wrapper and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/pallas/fused_ring_kernel.py``
(``apply_fused_ring_pallas``).  It computes exactly the function of K1's
int8 gamma route in order "vh" (ops/cuda/fused_kernel.py): u8 sRGB image
-> 13-bit linear light in two s8 limbs -> the V pass's exact s32 limb
sums -> the 15-bit intermediate -> the H pass's limb sums -> sRGB -> u8.
What differs is where the linearization happens.  K1 linearizes every
input element each time a thread block stages it (2.98 times per input
byte at 7680x4320 -> 1920x1080); the ring kernel linearizes each input row
of a 128-lane segment once per sweep of a thread block down a column of
output rows and keeps the limb rows in a ring in shared memory.

The operator is the uniform blocking of the V pass (``block_banded(...,
uniform=True)``): constant window stride ``delta``, with ``pad_top`` rows
of zeros above the image.  The kernel reads those rows, and rows past the
image, as zeros without a padded copy of the image.

``prepare_fused_ring`` builds K1 int8's gamma operands on the ring
operator (``prepare_fused_int8``, so the taps, the shifts and the
epilogue are K1's) and the kernel's schedule (csrc/fused_ring.cu), the
cluster plan:

  - a thread block cluster per 128-lane output chunk, of ``cluster``
    blocks: the most 128-lane input segments that hold a chunk's nonzero
    lane taps (its window's nonzero 128-lane groups, ``_pairs``).  Block
    r of a chunk's cluster owns its r-th such segment (``seg_of``, with
    its first window lane ``off_of``), or none (-1) where the chunk has
    fewer; it linearizes that segment, runs the V pass over it and its
    share of the H pass, and the cluster sums the shares in distributed
    shared memory.  More than 16 blocks (the H100's largest cluster), or
    more shared memory than a block can have, is refused (ValueError), and
    the executor then takes K1's in-kernel route;
  - the 32-row output slices that hold output rows, in order, cut into
    ``parts`` runs; a cluster sweeps one run, each block linearizing the
    first active slice's whole tap-row range (its preload) and then only
    each next slice's new rows.

``apply_fused_ring`` launches the kernel on a CUDA tensor and runs
``apply_fused_ring_reference`` on a CPU tensor: K1 int8's plain gamma
version on the ring operands, over the image moved down by ``pad_top``
zero rows.  Both compute the same exact integer sums, so they agree bit
for bit, and with K1's in-kernel route on the same image.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ...utils import trace
from ..banded import BlockedBandedOp
from ..lanes import LaneBlockedOp
from .fused_kernel import (
    _LANES,
    FusedInt8Operands,
    apply_fused_int8_reference,
    prepare_fused_int8,
)
from .launch import F, I, P, Entry, on_cpu

# Launches of the ring kernel, counted by the wrapper.
launches = {"fused_ring_vh_gamma": 0}

# Thread blocks the row parts aim for: four waves of two blocks on each of
# the H100's 132 SMs.  chip_smoke.py's parts sweep (PERF.md) finds the time
# flat from three parts to sixteen at 8K -> 1080p; one part leaves a second
# wave of a few clusters, and more parts add preloads.
_TARGET_BLOCKS = 1056
# The H100's largest thread block cluster (non-portable above 8) and the
# most dynamic shared memory a block can have.
MAX_CLUSTER = 16
MAX_SMEM = 232_448
# csrc/fused_ring.cu's shared memory beside the ring and the V taps: the
# q13 table and its packed limbs, the intermediate's limbs (2 x 32 x 144
# bytes) and the lane taps (2 x 32 x 136 words), which the shares overlay.
_SMEM_FIXED = 2 * 256 * (4 + 2) + 2 * 32 * 144 + 2 * 32 * 136 * 4


def smem_bytes(ring_rows: int) -> int:
    """Dynamic shared memory of one ring block (``smem_bytes`` in
    csrc/fused_ring.cu): the ring's two limb planes (ring_rows / 4 words
    of 4 rows x 136, 128 lanes padded), a slice's V taps (2 limbs x 32
    rows x ring_rows + 16 bytes) and the rest."""
    return 2 * (ring_rows // 4) * 136 * 4 + 2 * 32 * (ring_rows + 16) + _SMEM_FIXED


def uniform_delta(offs: np.ndarray) -> int:
    """The constant window stride, or 0 if offsets are not uniform."""
    if len(offs) < 2:
        return 0
    d = np.diff(np.asarray(offs))
    return int(d[0]) if (d == d[0]).all() and d[0] > 0 else 0


def n_preload(win_v: int, delta: int) -> int:
    """Preload cells of the TPU kernel's column sweep."""
    return -(-(win_v - delta) // delta)


def ring_viable(
    vop: BlockedBandedOp, lop: LaneBlockedOp, gamma: bool, order: str
) -> bool:
    """The JAX package's applicability check (``ring_viable`` there):
    gamma, order "vh", a uniform 32-aligned stride below a 32-aligned
    window, and at most 8 preload cells."""
    if not gamma or order != "vh":
        return False
    wv = vop.taps_hi.shape[2]
    delta = uniform_delta(vop.offs)
    return (
        delta > 0
        and delta % 32 == 0
        and wv % 32 == 0
        and delta < wv
        and n_preload(wv, delta) <= 8
    )


@dataclasses.dataclass(frozen=True)
class FusedRingOperands:
    """Device-resident operands and schedule of one ring resize."""

    k1: FusedInt8Operands   # K1 int8 gamma operands on the ring operator
    delta: int              # uniform window stride (rows)
    n_pre: int              # the TPU kernel's preload cells
    pad_top: int            # zero rows above the image
    ring_rows: int          # ring capacity (rows, a multiple of 32)
    cluster: int            # thread blocks a cluster
    smem_bytes: int         # dynamic shared memory a block
    chunk_of: torch.Tensor  # int32 [n_clusters] lane chunk hb * n_ch + j
    seg_of: torch.Tensor    # int32 [n_clusters * cluster] 128-lane input
                            # segment of each block, -1: none
    off_of: torch.Tensor    # int32 [n_clusters * cluster] its first window lane
    slices: torch.Tensor    # int32 [n_sl, 4] slices with output rows, in
                            # order: vb * n_slices + sl, its nonzero V-tap
                            # rows [k_lo, k_hi), its window's first row
    part_ptr: torch.Tensor  # int32 [parts + 1] into slices

    @property
    def device(self) -> torch.device:
        return self.k1.device

    @property
    def launch_key(self) -> str:
        return "fused_ring_vh_gamma"

    @property
    def epi(self):
        """K1's epilogue, which the ring kernel shares."""
        return self.k1.epi

    @functools.cached_property
    def packed(self) -> tuple:
        """The kernel's arguments fixed for these operands (LAUNCH.pack)."""
        k1 = self.k1
        _, tv, wv = k1.v1.shape
        _, n_ch, win_c, _ = k1.h1.shape
        parts = self.part_ptr.shape[0] - 1
        if parts > 65535:
            raise ValueError("too many row parts for one launch")
        return LAUNCH.pack(
            self, k1, k1.epi, tv=tv, wv=wv, n_ch=n_ch, win_c=win_c,
            n_slices=k1.k_range.shape[1], n_clusters=self.chunk_of.shape[0], parts=parts,
            rec=2.0 ** k1.out_exp,
        )


def _slice_rows(k1: FusedInt8Operands) -> tuple[np.ndarray, np.ndarray]:
    """Per slice vb * n_slices + sl: the absolute padded rows [lo, hi) of
    its nonzero V taps (hi == lo when it has none)."""
    kr = k1.k_range.cpu().numpy().astype(np.int64)
    offs = np.asarray(k1.offs_v_host, dtype=np.int64)[:, None]
    return (offs + kr[..., 0]).ravel(), (offs + kr[..., 1]).ravel()


def _pairs(k1: FusedInt8Operands) -> dict[int, list[tuple[int, int]]]:
    """{128-lane input segment: [(chunk, window offset), ...]} for every
    128-row group of a chunk's window that holds a nonzero H tap."""
    nz = ((k1.h1 != 0) | (k1.h0 != 0)).any(dim=3).cpu().numpy()
    bh, n_ch, win_c = nz.shape
    nz = nz.reshape(bh, n_ch, win_c // _LANES, _LANES).any(axis=3)
    offs_l = k1.offs_l.cpu().numpy()
    rel = k1.rel.cpu().numpy()
    out: dict[int, list[tuple[int, int]]] = {}
    for hb, j, g in zip(*np.nonzero(nz)):
        start = int(offs_l[hb]) + int(rel[j]) + int(g) * _LANES
        out.setdefault(start // _LANES, []).append(
            (int(hb) * n_ch + int(j), int(g) * _LANES)
        )
    return out


def cluster_plan(k1: FusedInt8Operands):
    """(cluster, chunk_of, seg_of, off_of): a cluster for every lane chunk
    with output lanes; its blocks own the chunk's input segments with
    nonzero lane taps (``_pairs``) in order, then none (-1)."""
    by_chunk: dict[int, list[tuple[int, int]]] = {}
    for seg, pairs in sorted(_pairs(k1).items()):
        for chunk, off in pairs:
            by_chunk.setdefault(chunk, []).append((seg, off))
    bh, n_ch = k1.h1.shape[:2]
    chunks = [
        hb * n_ch + j for hb in range(bh) for j in range(n_ch)
        if hb * k1.tc + j * _LANES < k1.lanes_out
    ]
    cluster = max([1] + [len(by_chunk.get(c, ())) for c in chunks])
    seg_of = np.full((len(chunks), cluster), -1, dtype=np.int64)
    off_of = np.zeros((len(chunks), cluster), dtype=np.int64)
    for i, c in enumerate(chunks):
        for r, (seg, off) in enumerate(by_chunk.get(c, ())):
            seg_of[i, r], off_of[i, r] = seg, off
    return cluster, np.asarray(chunks), seg_of.ravel(), off_of.ravel()


def resident_clusters(cluster: int, ring_rows: int, device: torch.device) -> int:
    """Clusters of ``cluster`` ring blocks the card can hold at once (0:
    it cannot launch one)."""
    count = ctypes.c_int(0)
    MAX_CLUSTERS(device, cluster, ring_rows, ctypes.byref(count))
    return count.value


def prepare_fused_ring(
    vop: BlockedBandedOp,
    lop: LaneBlockedOp,
    device: torch.device | str,
    alpha_index: int = -1,
    in_gamma_mult: float = 1.0,
    out_gamma_mult: float = 1.0,
    parts: int | None = None,
) -> FusedRingOperands:
    """Operands of the ring resize by the uniformly blocked ``vop``
    (``block_banded(..., uniform=True)``) and ``lop``, with sRGB gamma, on
    ``device``.  ``parts``: runs each column of output slices is cut into
    (by default enough for ~1,056 thread blocks).  Raises ValueError where
    a chunk's window needs more than MAX_CLUSTER blocks, a block more than
    MAX_SMEM bytes, or (on a card) the card holds no such cluster."""
    if not ring_viable(vop, lop, True, "vh"):
        raise ValueError("ring kernel needs uniform 32-aligned delta")
    if vop.taps_q1 is None or lop.taps_q1 is None:
        raise ValueError("operator lacks int8 limb taps")
    k1 = prepare_fused_int8(
        vop, lop, "vh", device, gamma=True, alpha_index=alpha_index,
        in_gamma_mult=in_gamma_mult, out_gamma_mult=out_gamma_mult,
    )
    lo, hi = _slice_rows(k1)
    active = np.nonzero(hi > lo)[0]
    if (np.diff(lo[active]) < 0).any() or (np.diff(hi[active]) < 0).any():
        raise ValueError("slice tap rows are not monotone")
    if (lo[active] % 32).any():
        raise ValueError("slice tap rows are not 32-aligned")
    ring_rows = int((hi[active] - lo[active]).max())
    cluster, chunk_of, seg_of, off_of = cluster_plan(k1)
    if cluster > MAX_CLUSTER:
        raise ValueError(
            f"a chunk's window spans {cluster} segments: more than the "
            f"{MAX_CLUSTER} blocks of a cluster"
        )
    smem = smem_bytes(ring_rows)
    if smem > MAX_SMEM:
        raise ValueError(f"ring of {ring_rows} rows needs {smem} bytes a block")
    device = torch.device(device)
    if device.type == "cuda" and resident_clusters(cluster, ring_rows, device) < 1:
        raise ValueError(f"the card holds no cluster of {cluster} ring blocks")
    # Every slice with output rows: its outputs are written even where it
    # has no nonzero V tap.
    _, tv, _ = k1.v1.shape
    n_sl = k1.k_range.shape[1]
    g = np.arange(lo.size)
    g = g[(g // n_sl) * tv + (g % n_sl) * 32 < k1.rows_out]
    kr = k1.k_range.cpu().numpy().reshape(-1, 2)
    offs = np.asarray(k1.offs_v_host)
    slices = np.stack([g, kr[g, 0], kr[g, 1], offs[g // n_sl]], axis=1)
    if parts is None:
        parts = -(-_TARGET_BLOCKS // (len(chunk_of) * cluster))
    parts = max(1, min(int(parts), len(slices)))
    part_ptr = np.linspace(0, len(slices), parts + 1).round().astype(np.int64)
    delta = uniform_delta(vop.offs)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32)).to(device)

    return FusedRingOperands(
        k1=k1,
        delta=delta,
        n_pre=n_preload(vop.taps_hi.shape[2], delta),
        pad_top=vop.pad_top,
        ring_rows=ring_rows,
        cluster=cluster,
        smem_bytes=smem,
        chunk_of=dev(chunk_of),
        seg_of=dev(seg_of),
        off_of=dev(off_of),
        slices=dev(slices),
        part_ptr=dev(part_ptr),
    )


def linearizations_per_input(ops: FusedRingOperands) -> float:
    """Image elements the kernel linearizes per image element: each
    thread block that owns a segment linearizes its lanes over its run's
    first active slice's tap rows and every next slice's new rows
    (padding excluded)."""
    k1 = ops.k1
    lo, hi = _slice_rows(k1)
    top, bottom = ops.pad_top, ops.pad_top + k1.rows_in
    rows = 0
    p, slices = ops.part_ptr.tolist(), ops.slices[:, 0].tolist()
    for a, b in zip(p[:-1], p[1:]):
        done = None
        for g in slices[a:b]:
            if hi[g] <= lo[g]:
                continue
            start = lo[g] if done is None else max(done, lo[g])
            rows += max(0, min(hi[g], bottom) - max(start, top))
            done = hi[g]
    lanes = sum(
        max(0, min(_LANES * s + _LANES, k1.lanes_in) - _LANES * s)
        for s in ops.seg_of.tolist() if s >= 0
    )
    return rows * lanes / (k1.rows_in * k1.lanes_in)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def apply_fused_ring_reference(
    ops: FusedRingOperands, x: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch ring resize: u8 [rows_in, lanes_in] -> u8 [rows_out,
    lanes_out], on the device of ``x``: K1 int8's plain gamma version on
    the ring operands over the image moved down by ``pad_top`` zero rows."""
    k1 = ops.k1
    xp = torch.zeros(
        (ops.pad_top + k1.rows_in, k1.lanes_in), dtype=torch.uint8, device=x.device
    )
    xp[ops.pad_top :] = x
    return apply_fused_int8_reference(
        dataclasses.replace(k1, rows_in=ops.pad_top + k1.rows_in), xp
    )


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# csrc/fused_ring.cu's launch and occupancy query.
LAUNCH = Entry("fused_ring", "avir_fused_ring", span="k6.launch", params=(
    ("x", P), ("out", P), ("stream", P),
    ("rows_in", I), ("lanes_in", I), ("pad_top", I), ("rows_out", I), ("lanes_out", I),
    ("tc", I), ("v1", P), ("v0", P), ("offs_v", P), ("tv", I), ("wv", I),
    ("h1p", P), ("h0p", P), ("n_ch", I), ("win_c", I), ("k_range", P), ("n_slices", I),
    ("cluster", I), ("n_clusters", I), ("chunk_of", P), ("seg_of", P), ("off_of", P),
    ("slices", P), ("part_ptr", P), ("parts", I), ("ring_rows", I),
    ("sh", I), ("rec", F), ("alpha_lane", I), ("in_gamma_mult", F), ("out_gamma_mult", F),
))
MAX_CLUSTERS = Entry("fused_ring", "avir_fused_ring_max_clusters", params=(
    ("cluster", I), ("ring_rows", I), ("count", ctypes.POINTER(ctypes.c_int)),
))


def apply_fused_ring(ops: FusedRingOperands, x: torch.Tensor) -> torch.Tensor:
    """Ring resize of the u8 image ``x`` [rows_in, lanes_in] -> u8
    [rows_out, lanes_out].  A CUDA tensor launches the kernel (one launch);
    a CPU tensor runs the plain version.  While the tracer
    (utils/trace.py) is on, a call is a ``k6.call`` span and its ``ctypes``
    call a ``k6.launch`` span inside it."""
    if trace.on:
        return trace.call("k6.call", _apply_fused_ring, ops, x)
    return _apply_fused_ring(ops, x)


def _apply_fused_ring(ops: FusedRingOperands, x: torch.Tensor) -> torch.Tensor:
    k1 = ops.k1
    if on_cpu(x, ops.device):
        return apply_fused_ring_reference(ops, x)
    if x.dtype != torch.uint8 or x.shape != (k1.rows_in, k1.lanes_in):
        raise ValueError(
            f"expected u8 [{k1.rows_in}, {k1.lanes_in}], got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("image must be contiguous")
    out = torch.empty((k1.rows_out, k1.lanes_out), dtype=torch.uint8, device=x.device)
    LAUNCH.launch(x, launches, ops.launch_key, x.data_ptr(), out.data_ptr(), packed=ops.packed)
    return out
