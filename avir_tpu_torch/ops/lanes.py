"""Lane-side blocked form of a banded operator.

The horizontal pass of a resize consumes an image [rows, W*C] and must
contract over W.  Rather than transposing, this module builds, per
output block, a dense RIGHT-multiplication matrix over the interleaved
lane axis:

    out[:, b*T*C : (b+1)*T*C] = x[:, offs_l[b] : offs_l[b] + win_l] @ B[b]

with B[b][q*C + ch - offs_l[b], t*C + ch] = taps[b*T + t, q - start].
The input is consumed in its natural layout and the output IS the final
interleaved [rows, new_w*C] layout.

Window starts are multiples of 128 LANES (not of pixels): for C=3 a
window may start mid-pixel and the tap matrix absorbs the channel phase.

The chunked form splits each block's T*C output lanes into 128-lane
chunks, each contracting only its own ``win_c``-lane sub-window at the
block-invariant offset ``chunk_rel[j]``; the fused kernel runs one
chunk per thread block.

Geometry and tiles are the JAX package's (ops/lanes.py there), so both
packages build identical operators from one plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..plan.compose import BandedOp
from .banded import _round_up, bf16_split
from .intq import first_pass_overflow_safe, quantize_limbs


@dataclasses.dataclass(frozen=True)
class LaneBlockedOp:
    """Right-multiplication lane form.  ``tile`` is in ROWS of the
    original operator (output pixels per block); window geometry
    (``offs_l``, ``win_l``, ``lanes_pad``) is in LANES."""

    n_in: int      # input length (rows of the banded op)
    n_out: int
    c: int         # interleaved channel count
    tile: int      # output rows per block
    win_l: int     # input-window LANES per block (multiple of 128)
    lanes_pad: int  # required input lanes incl. zero-pad
    offs_l: np.ndarray         # int32 [n_blocks] -- window starts in LANES
    taps_hi: torch.Tensor      # bf16 [n_blocks, win_l, tile*c]
    taps_lo: torch.Tensor      # bf16 [n_blocks, win_l, tile*c]
    # int8 fixed-point limbs (ops/intq.py); None for 2/4-byte inputs.
    taps_q1: np.ndarray | None = None  # s8 [n_blocks, win_l, tile*c]
    taps_q0: np.ndarray | None = None  # s8
    q_shift: int = 0
    # Chunked form: per 128-lane output chunk, the window offset of its
    # win_c-lane sub-window.  None when tile*c == 128 or the band
    # already fills the window.
    chunk_rel: tuple[int, ...] | None = None
    win_c: int = 0
    # Subset form (block_list): original output-column index of each
    # block; None for the full operator.
    out_idx: np.ndarray | None = None
    ctaps_hi: torch.Tensor | None = None  # bf16 [n_blocks, n_ch, win_c, 128]
    ctaps_lo: torch.Tensor | None = None
    ctaps_q1: np.ndarray | None = None    # s8
    ctaps_q0: np.ndarray | None = None
    l1_max: float = 0.0  # max_col sum |taps| -- output magnitude bound
    # Max per-output abs limb sums along the contraction.
    q_abs1: int = 0
    q_abs0: int = 0

    @property
    def n_blocks(self) -> int:
        return self.offs_l.shape[0]


def lane_chunk_geometry(
    op: BandedOp, c: int, tile: int
) -> tuple[int, int, int]:
    """(win_l, win_c, n_ch) of the lane form at ``tile``, computed from
    starts/width alone (no dense tap materialization)."""
    n_out, width = op.n_out, op.width
    n_blocks = -(-n_out // tile)
    starts = op.starts.astype(np.int64)
    offs_l = np.empty(n_blocks, dtype=np.int64)
    spans = np.empty(n_blocks, dtype=np.int64)
    for b in range(n_blocks):
        lo = b * tile
        hi = min(lo + tile, n_out)
        offs_l[b] = (starts[lo] * c // 128) * 128
        spans[b] = (starts[hi - 1] + width) * c - offs_l[b]
    win_l = _round_up(int(spans.max()), 128)
    n_ch = (tile * c) // 128
    if n_ch <= 1 or (tile * c) % 128:
        return win_l, 0, n_ch
    rel = np.full(n_ch, np.iinfo(np.int64).max)
    ends = np.zeros(n_ch, dtype=np.int64)
    for b in range(n_blocks):
        lo = b * tile
        for j in range(n_ch):
            p0 = min((lo * c + j * 128) // c, n_out - 1)
            p1 = min((lo * c + j * 128 + 127) // c, n_out - 1)
            s = starts[p0] * c - offs_l[b]
            e = (starts[p1] + width) * c - offs_l[b]
            rel[j] = min(rel[j], (s // 128) * 128)
            ends[j] = max(ends[j], e)
    win_c = _round_up(int((ends - rel).max()), 128)
    return win_l, min(win_c, win_l), n_ch


def pick_lane_tile(
    op: BandedOp, c: int, wide: bool = True, in_bytes: int = 1
) -> int:
    """Output pixels per block of the lane form, as the JAX package picks
    it: a multiple of 128/gcd(c, 128) pixels, widened for its fused kernel
    on upsizes to ~2304 output lanes (1-byte input) or to the candidate
    with the least modeled chunked-window work (2/4-byte input).
    ``wide=False`` returns the base tile: the unfused lane pass's dense
    [win_l, tile*c] tap blocks (``narrow_lop``)."""
    step = 128 // int(np.gcd(c, 128))
    base = step * max(1, -(-64 // step))
    n_out = op.n_out
    if not wide or n_out < 2:
        return base
    k = (op.starts[-1] - op.starts[0]) / (n_out - 1)
    if k >= 1.0 or n_out * c < 4096:
        return base
    if in_bytes <= 1:
        return step * max(1, -(-2304 // (step * c)))
    lo_px = max(base, step * -(-2304 // (step * c * in_bytes)))
    # Descending: near-ties resolve to the LARGER tile.
    cands = sorted(
        {step * -(-px // step) for px in (lo_px, 384, 512, 768, 1024)},
        reverse=True,
    )
    best, best_cost = None, None
    for t in cands:
        if t < lo_px or t * c % 128:
            continue
        win_l, win_c, n_ch = lane_chunk_geometry(op, c, t)
        if win_c == 0:
            win_c = win_l
        tap_bytes = n_ch * win_c * 128 * 2 * 2  # bf16 hi/lo
        if tap_bytes > 8 * 1024 * 1024:
            continue
        blocks = -(-n_out // t)
        cost = blocks * (
            n_ch * win_c * 128 * 3 // 2 + win_l * in_bytes * 120
        )
        if best_cost is None or cost < best_cost * 0.98:
            best, best_cost = t, cost
    if best is not None:
        return best
    fitting = [t for t in cands if t >= lo_px]
    return min(fitting) if fitting else base


def lane_block_banded(
    op: BandedOp, c: int, tile: int | None = None,
    block_list: list[int] | None = None,
    in_bytes: int = 1,
) -> LaneBlockedOp:
    """Build the lane-side blocked form.

    ``block_list`` restricts the result to a SUBSET of output blocks
    (identical offsets/taps, but the chunk sub-window ``win_c`` is
    recomputed from the subset alone); ``out_idx`` records each subset
    block's original column."""
    if tile is None:
        tile = pick_lane_tile(op, c, in_bytes=in_bytes)
    n_out, width = op.n_out, op.width
    n_blocks = -(-n_out // tile)
    starts = op.starts.astype(np.int64)

    offs_l = np.empty(n_blocks, dtype=np.int64)
    spans_l = np.empty(n_blocks, dtype=np.int64)
    for b in range(n_blocks):
        lo = b * tile
        hi = min(lo + tile, n_out)
        offs_l[b] = (starts[lo] * c // 128) * 128
        spans_l[b] = (starts[hi - 1] + width) * c - offs_l[b]
    win_l = _round_up(int(spans_l.max()), 128)
    # Pull overrunning tail windows left (128-lane aligned) to avoid
    # padding the input lanes.
    max_off = (op.n_in * c - win_l) // 128 * 128
    if max_off >= 0 and int(
        (spans_l + np.maximum(offs_l - max_off, 0)).max()
    ) <= win_l:
        offs_l -= np.maximum(offs_l - max_off, 0)
    lanes_pad = int(offs_l.max()) + win_l

    dense = np.zeros((n_blocks, win_l, tile * c), dtype=np.float32)
    for b in range(n_blocks):
        lo = b * tile
        hi = min(lo + tile, n_out)
        for i in range(lo, hi):
            s_l = int(starts[i]) * c - int(offs_l[b])
            t = i - lo
            for ch in range(c):
                dense[
                    b,
                    (s_l + ch) : (s_l + width * c + ch) : c,
                    t * c + ch,
                ] = op.taps[i]

    # Fixed-point scales, norms and overflow bounds come from the FULL
    # operator so block subsets stay bit-identical to the full form.
    q1 = q0 = None
    q_shift = 0
    if in_bytes <= 1:
        q1, q0, q_shift = quantize_limbs(dense)
        if not first_pass_overflow_safe(q1, q0, contract_axis=1):
            q1 = q0 = None  # pragma: no cover - pathological taps
    l1_max = float(np.abs(dense).sum(axis=1).max())
    q_abs1 = 0 if q1 is None else int(
        np.abs(q1.astype(np.int64)).sum(axis=1).max()
    )
    q_abs0 = 0 if q0 is None else int(
        np.abs(q0.astype(np.int64)).sum(axis=1).max()
    )

    out_idx = None
    if block_list is not None:
        out_idx = np.asarray(block_list, dtype=np.int64)
        dense = dense[out_idx]
        offs_l = offs_l[out_idx]
        if q1 is not None:
            q1, q0 = q1[out_idx], q0[out_idx]

    taps_hi, taps_lo = bf16_split(dense)

    # Chunked banded form: per 128-lane output chunk, the sub-window of
    # contraction lanes actually touched (offsets 128-aligned).  bf16
    # rounding and limb splitting are elementwise, so slicing the split
    # tensors keeps the chunked and full forms numerically identical.
    chunk_rel = None
    win_c = 0
    c_hi = c_lo = c_q1 = c_q0 = None
    n_ch = (tile * c) // 128
    if n_ch > 1 and (tile * c) % 128 == 0:
        rel = np.empty(n_ch, dtype=np.int64)
        ends = np.empty(n_ch, dtype=np.int64)
        for j in range(n_ch):
            used = np.nonzero(
                np.any(dense[:, :, j * 128 : (j + 1) * 128], axis=(0, 2))
            )[0]
            lo_u, hi_u = (
                (int(used[0]), int(used[-1]) + 1) if used.size else (0, 1)
            )
            rel[j] = (lo_u // 128) * 128
            ends[j] = hi_u
        win_c = _round_up(int((ends - rel).max()), 128)
        if win_c < win_l:
            rel = np.minimum(rel, win_l - win_c)
            chunk_rel = tuple(int(r) for r in rel)
            sl = [
                (slice(None), slice(r, r + win_c),
                 slice(j * 128, (j + 1) * 128))
                for j, r in enumerate(chunk_rel)
            ]
            c_hi = torch.stack([taps_hi[s] for s in sl], dim=1)
            c_lo = torch.stack([taps_lo[s] for s in sl], dim=1)
            if q1 is not None:
                c_q1 = np.stack([q1[s] for s in sl], axis=1)
                c_q0 = np.stack([q0[s] for s in sl], axis=1)
    return LaneBlockedOp(
        n_in=op.n_in,
        n_out=n_out,
        c=c,
        tile=tile,
        win_l=win_l,
        lanes_pad=lanes_pad,
        offs_l=offs_l.astype(np.int32),
        taps_hi=taps_hi,
        taps_lo=taps_lo,
        taps_q1=q1,
        taps_q0=q0,
        q_shift=q_shift,
        chunk_rel=chunk_rel,
        win_c=win_c,
        ctaps_hi=c_hi,
        ctaps_lo=c_lo,
        ctaps_q1=c_q1,
        ctaps_q0=c_q0,
        l1_max=l1_max,
        q_abs1=q_abs1,
        q_abs0=q_abs0,
        out_idx=out_idx,
    )


def narrow_lop(
    op: BandedOp, lop: LaneBlockedOp, c: int, in_bytes: int = 1
) -> LaneBlockedOp:
    """The lane form of ``op`` at the base tile, for the unfused route
    (the JAX package's ``models/runtime.py:_narrow_lop``): ``lop`` itself
    when it already has that tile."""
    base = pick_lane_tile(op, c, wide=False)
    if lop.tile == base:
        return lop
    return lane_block_banded(op, c, tile=base, in_bytes=in_bytes)
