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
once per sweep of a thread block down a column of output rows and keeps
the limb rows in a ring in shared memory.

The operator is the uniform blocking of the V pass (``block_banded(...,
uniform=True)``): constant window stride ``delta``, with ``pad_top`` rows
of zeros above the image.  The kernel reads those rows, and rows past the
image, as zeros without a padded copy of the image.

``prepare_fused_ring`` builds K1 int8's gamma operands on the ring
operator (``prepare_fused_int8``, so the taps, the shifts and the
epilogue are K1's) and the kernel's schedule (csrc/fused_ring.cu):

  - 128-lane input segments, each with the list of (lane chunk, window
    offset) pairs whose nonzero H taps cover it; a thread block owns one
    segment, so each input lane is linearized by one block only;
  - the active 32-row output slices in order, cut into ``parts`` runs; a
    thread block sweeps one run, linearizing the first slice's whole
    tap-row range (its preload) and then only each next slice's new rows.

``apply_fused_ring`` launches the kernel on a CUDA tensor and runs
``apply_fused_ring_reference`` on a CPU tensor: K1 int8's plain gamma
version on the ring operands, over the image moved down by ``pad_top``
zero rows.  Both compute the same exact integer sums, so they agree bit
for bit, and with K1's in-kernel route on the same image.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..banded import BlockedBandedOp
from ..gamma import f32
from ..lanes import LaneBlockedOp
from .fused_kernel import (
    _LANES,
    FusedInt8Operands,
    apply_fused_int8_reference,
    prepare_fused_int8,
)

# Launches of the ring kernel, counted by the wrapper.
launches = {"fused_ring_vh_gamma": 0}

# Thread blocks the row parts aim for: eight waves of two blocks on each
# of the H100's 132 SMs.  Measured at 8K (chip_smoke.py's parts sweep),
# more blocks in flight gain more than their extra preloads cost: 2.08 ms
# at 180 blocks, 1.66 at 540, 1.42 at 2,160.
_TARGET_BLOCKS = 2112


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
    segs: torch.Tensor      # int32 [n_seg] 128-lane input segments swept
    seg_ptr: torch.Tensor   # int32 [n_seg + 1] into pair_chunk / pair_off
    pair_chunk: torch.Tensor  # int32 [n_pairs] lane chunk hb * n_ch + j
    pair_off: torch.Tensor    # int32 [n_pairs] segment's row in its window
    slices: torch.Tensor    # int32 [n_active] active slices vb * n_slices + sl
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
    (by default enough for ~2,112 thread blocks)."""
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
    ring_rows = int((hi[active] - lo[active]).max())
    pairs = _pairs(k1)
    segs = sorted(pairs)
    if parts is None:
        parts = -(-_TARGET_BLOCKS // max(len(segs), 1))
    parts = max(1, min(int(parts), len(active)))
    part_ptr = np.linspace(0, len(active), parts + 1).round().astype(np.int64)
    seg_ptr = np.cumsum([0] + [len(pairs[s]) for s in segs])
    flat = [p for s in segs for p in pairs[s]]
    delta = uniform_delta(vop.offs)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32)).to(device)

    return FusedRingOperands(
        k1=k1,
        delta=delta,
        n_pre=n_preload(vop.taps_hi.shape[2], delta),
        pad_top=vop.pad_top,
        ring_rows=ring_rows,
        segs=dev(segs),
        seg_ptr=dev(seg_ptr),
        pair_chunk=dev([c for c, _ in flat]),
        pair_off=dev([o for _, o in flat]),
        slices=dev(active),
        part_ptr=dev(part_ptr),
    )


def linearizations_per_input(ops: FusedRingOperands) -> float:
    """Image elements the kernel linearizes per image element: each
    thread block linearizes its segment's lanes over its run's first
    slice's tap rows and every next slice's new rows (padding excluded)."""
    k1 = ops.k1
    lo, hi = _slice_rows(k1)
    top, bottom = ops.pad_top, ops.pad_top + k1.rows_in
    rows = 0
    p, slices = ops.part_ptr.tolist(), ops.slices.tolist()
    for a, b in zip(p[:-1], p[1:]):
        done = None
        for g in slices[a:b]:
            start = lo[g] if done is None else max(done, lo[g])
            rows += max(0, min(hi[g], bottom) - max(start, top))
            done = hi[g]
    lanes = sum(
        max(0, min(_LANES * s + _LANES, k1.lanes_in) - _LANES * s)
        for s in ops.segs.tolist()
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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [
    _P, _I, _I, _I,        # x, rows_in, lanes_in, pad_top
    _P, _P, _I, _I, _I,    # out, acc (pa/pb), rows_out, lanes_out, tc
    _P, _P, _P,            # v1, v0, offs_v
    _I, _I,                # tv, wv
    _P, _P,                # h1p, h0p
    _I, _I,                # n_ch, win_c
    _P, _I,                # k_range, n_slices
    _P, _I, _P, _P, _P,    # segs, n_seg, seg_ptr, pair_chunk, pair_off
    _P, _P, _I,            # slices, part_ptr, parts
    _I,                    # ring_rows
    _I, _F,                # sh, rec
    _I, _F, _F,            # alpha_lane, in/out gamma mults
    _P,                    # stream
]


def _library():
    from .build import load_library

    lib = load_library("fused_ring")
    fn = lib.avir_fused_ring
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def apply_fused_ring(ops: FusedRingOperands, x: torch.Tensor) -> torch.Tensor:
    """Ring resize of the u8 image ``x`` [rows_in, lanes_in] -> u8
    [rows_out, lanes_out].  A CUDA tensor launches the kernel; a CPU
    tensor runs the plain version."""
    k1 = ops.k1
    if x.device.type == "cpu" and ops.device.type == "cpu":
        return apply_fused_ring_reference(ops, x)
    if x.device.type != "cuda" or x.device != ops.device:
        raise ValueError(
            f"image on {x.device}, operands on {ops.device}: both must be "
            "on one CUDA device (or both on the CPU)"
        )
    if x.dtype != torch.uint8 or x.shape != (k1.rows_in, k1.lanes_in):
        raise ValueError(
            f"expected u8 [{k1.rows_in}, {k1.lanes_in}], got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("image must be contiguous")
    _, tv, wv = k1.v1.shape
    _, n_ch, win_c, _ = k1.h1.shape
    n_seg, parts = ops.segs.shape[0], ops.part_ptr.shape[0] - 1
    if parts > 65535:
        raise ValueError("too many row parts for one launch")
    # The H pass adds each segment's share of the two s32 limb sums into
    # acc; the finishing step turns them into the output.
    acc = torch.zeros((2, k1.rows_out, k1.lanes_out), dtype=torch.int32, device=x.device)
    out = torch.empty((k1.rows_out, k1.lanes_out), dtype=torch.uint8, device=x.device)
    epi = k1.epi
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), k1.rows_in, k1.lanes_in, ops.pad_top,
            out.data_ptr(), acc.data_ptr(), k1.rows_out, k1.lanes_out, k1.tc,
            k1.v1.data_ptr(), k1.v0.data_ptr(), k1.offs_v.data_ptr(),
            tv, wv,
            k1.h1p.data_ptr(), k1.h0p.data_ptr(),
            n_ch, win_c,
            k1.k_range.data_ptr(), k1.k_range.shape[1],
            ops.segs.data_ptr(), n_seg, ops.seg_ptr.data_ptr(),
            ops.pair_chunk.data_ptr(), ops.pair_off.data_ptr(),
            ops.slices.data_ptr(), ops.part_ptr.data_ptr(), parts,
            ops.ring_rows,
            k1.sh, 2.0 ** k1.out_exp,
            epi.alpha_lane, f32(epi.in_gamma_mult), f32(epi.out_gamma_mult),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ring launch failed: CUDA error {err}")
    launches[ops.launch_key] += 1
    return out
