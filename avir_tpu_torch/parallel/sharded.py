"""Multi-card sharded execution: row strips, or tiles of rows x columns,
over a mesh of processes.

Counterpart of the JAX package's ``parallel/sharded.py``, on
``torch.distributed``.  In the 1-D half the image rows are split over the
sp ranks of a ``multihost.DpSpMesh``:

  - the horizontal pass needs whole scanlines, which every rank has;
  - the vertical pass contracts over the split row axis, so each rank
    computes its output rows from its input strip plus HALO rows that
    its neighbours send (``comm.exchange_halos``, the ``ppermute``
    there).  The halo is the banded operator's overhang past the strip
    (the reference's per-step InPrefix/InSuffix, avir.h:5899-5900);
  - when the vertical band is wider than a strip (an extreme downsize on
    many ranks) the strips are all-gathered instead
    (``svop.use_all_gather``);
  - the dp axis of the mesh carries independent frames.

Each rank runs one of two routes, as the JAX package does:

  - the kernel route, the counterpart of ``_pallas_strip_fn``: the rank's
    raw strip and halos make one ext buffer, and the same hand-written
    K1 as the single-card path (``ops/cuda/fused_kernel.py`` int8,
    ``ops/cuda/fused_split.py`` split-bf16, always ``order="vh"``) runs on
    it with the rank's own V operator (``shard_v_blocked``); the int8
    limbs share one global shift over all ranks' taps, so every rank's
    kernel has the same fixed-point scales;
  - the library route, the counterpart of ``shard_fn``: the horizontal
    pass, then the halo exchange on the float32 intermediate, then the
    vertical pass, both as batched products (``ops/banded.py:
    apply_blocked``, ``torch.bmm``).  It serves ``precision="exact"`` and
    the all-gather fallback, large plain products that the JAX package
    also leaves outside its kernels, and LANCIR's float output.

The JAX package's interior/boundary LANE split of the fused kernel
(``_split_lane_ops``) is the TPU's lane layout and is not carried, as on
one card.

Row padding: an image whose height does not divide by sp is zero-padded
(``pad_rows``).  The composed vertical taps only reference rows < src_h
(edge clamping is folded into the taps), so the pad rows are never read.

The 2-D half (``make_sharded_{avir,lancir}_executor_2d`` on a
``multihost.DpSpCpMesh``) also splits the columns, over cp
(``pad_cols``): rank (i, j) holds tile (i, j).  On the kernel route its
column halos come on the raw tile along cp (``comm.exchange_col_halos``),
then its row halos on the column-extended tile along sp, and the single
card's K1 (``order="vh"``) runs on the doubly extended tile with the
rank's V operator (``shard_v_blocked``) and lane operator
(``shard_lane_blocked``, the limbs of every rank's lane taps under one
shift); the pure ``Tile.compute`` takes the three tiles.  The library
route runs the H pass on the float32 transposed tile after its column
halos, then the V pass after the row halos of the H-resized tile.
"""

from __future__ import annotations

import dataclasses
import logging
import types
from typing import Callable

import numpy as np
import torch

from ..models.avir import DITHERS, ERRDIFF, check_engine, errdiff_impl
from ..models.runtime import in_exact_bf16, out_dtype_of, resolve_modes
from ..ops.banded import (
    BlockedBandedOp,
    _round_up,
    apply_blocked,
    bf16_split,
    block_banded,
    pick_tile,
)
from ..ops.cuda.fused_kernel import (
    FusedInt8Operands,
    apply_fused_int8,
    int8_feasible,
    prepare_fused_int8,
)
from ..ops.cuda.fused_split import apply_fused_split, prepare_fused_split, to_float32
from ..ops.cuda.wavefront import errdiff_wavefront
from ..ops.dither import default_dither
from ..ops.gamma import f32, linear_to_srgb_2d, srgb_to_linear_2d
from ..ops.intq import first_pass_overflow_safe, quantize_limbs
from ..ops.lanes import LaneBlockedOp, lane_block_banded, pick_lane_tile
from ..plan.compose import BandedOp
from .comm import (
    all_gather_rows,
    all_gather_tiles,
    exchange_col_halos,
    exchange_halos,
    zeros_rows,
)

logger = logging.getLogger("avir_tpu_torch.parallel")


# ---------------------------------------------------------------------------
# Host half: the per-rank operators (NumPy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedVOp:
    """Per-rank blocked form of the vertical banded operator.

    Rank d owns output rows [d*m, (d+1)*m) (m = padded n_out / n_dev) and
    reads input rows [d*strip - halo_lo, (d+1)*strip + halo_hi) in global
    coordinates (or all rows in the all-gather fallback)."""

    n_in: int            # global input rows (unpadded image height)
    n_out: int           # global output rows (unpadded)
    strip: int           # input rows per rank (of the padded height)
    m: int               # output rows per rank
    halo_lo: int
    halo_hi: int
    win: int
    tile: int
    offs: np.ndarray     # int32 [n_dev, blocks]: local window starts
    taps: np.ndarray     # f32 [n_dev, blocks, tile, win]
    use_all_gather: bool
    # The INTERIOR block range [b_int0, b_int1): blocks whose windows lie
    # inside the local strip on every rank (no halo rows), so that they
    # can run before the halos arrive.  The border blocks are the prefix
    # [0, b_int0) and the suffix [b_int1, blocks).
    b_int0: int = 0
    b_int1: int = 0


def _interior_split(
    offs: np.ndarray,
    valid: np.ndarray,
    halo_lo: int,
    strip: int,
    win: int,
) -> tuple[int, int]:
    """Classify blocks as interior (window inside the local strip on
    every rank that uses them) or border, and repair the unused entries.

    Mutates ``offs``: entries where ``valid`` is False (blocks with no real
    output rows on that rank; their taps are all zero) borrow a valid
    rank's offset, so that interior-rebased windows stay in range.
    Returns the contiguous interior range [b0, b1), or (0, 0) when the
    interior is empty or not contiguous (then every block is border, which
    is correct but overlaps nothing; logged at DEBUG)."""
    n_dev, blocks = offs.shape
    inter = np.zeros(blocks, dtype=bool)
    for b in range(blocks):
        vd = np.nonzero(valid[:, b])[0]
        assert vd.size > 0  # rank 0 always owns all its blocks
        o = offs[vd, b]
        inter[b] = bool(
            (o >= halo_lo).all() and (o + win <= halo_lo + strip).all()
        )
        for d in range(n_dev):
            if not valid[d, b]:
                offs[d, b] = o[0]
    if not inter.any():
        logger.debug(
            "interior/halo overlap disabled: no interior blocks "
            "(strip=%d, win=%d, halo_lo=%d, blocks=%d)",
            strip, win, halo_lo, blocks,
        )
        return 0, 0
    b0 = int(np.argmax(inter))
    b1 = blocks - int(np.argmax(inter[::-1]))
    if not inter[b0:b1].all():
        logger.debug(
            "interior/halo overlap disabled: interior blocks "
            "non-contiguous (strip=%d, win=%d, halo_lo=%d, mask=%s)",
            strip, win, halo_lo, inter.tolist(),
        )
        return 0, 0
    return b0, b1


def shard_v_op(
    op: BandedOp, n_dev: int, padded_h: int, tile: int = 64
) -> ShardedVOp:
    """Split a vertical BandedOp into per-rank blocked operators of one
    shape, and compute the halo requirement."""
    if padded_h % n_dev or padded_h < op.n_in:
        raise ValueError(f"padded height {padded_h} must divide by {n_dev} and cover {op.n_in}")
    n_out, width = op.n_out, op.width
    m = -(-n_out // n_dev)
    strip = padded_h // n_dev
    blocks = -(-m // tile)
    starts = op.starts.astype(np.int64)

    # Global input range needed by each rank's output rows.
    need_lo = np.empty(n_dev, dtype=np.int64)
    need_hi = np.empty(n_dev, dtype=np.int64)
    for d in range(n_dev):
        lo, hi = d * m, min((d + 1) * m, n_out)
        if lo >= n_out:  # the rank owns only padding rows
            need_lo[d] = min(d * strip, op.n_in)
            need_hi[d] = need_lo[d]
        else:
            need_lo[d] = starts[lo]
            need_hi[d] = starts[hi - 1] + width

    halo_lo = int(max(0, np.max(np.arange(n_dev) * strip - need_lo)))
    halo_hi = int(
        max(0, np.max(need_hi - (np.arange(n_dev) + 1) * strip))
    )
    use_all_gather = halo_lo > strip or halo_hi > strip
    if use_all_gather:
        halo_lo = 0
        halo_hi = 0

    # Window size: the largest span of any tile-block of output rows.
    win = 0
    for b0 in range(0, n_out, tile):
        b1 = min(b0 + tile, n_out)
        win = max(win, int(starts[b1 - 1]) + width - int(starts[b0]))
    win = _round_up(win, 128)

    offs = np.zeros((n_dev, blocks), dtype=np.int64)
    taps = np.zeros((n_dev, blocks, tile, win), dtype=np.float32)
    valid = np.zeros((n_dev, blocks), dtype=bool)
    for d in range(n_dev):
        base = 0 if use_all_gather else d * strip - halo_lo
        for b in range(blocks):
            lo = d * m + b * tile
            # Clamp to this rank's own rows: block rows past m are
            # discarded by the executor's [:m].
            hi = min(lo + tile, (d + 1) * m, n_out)
            if lo >= min((d + 1) * m, n_out):
                continue
            off = int(starts[lo]) - base
            assert off >= 0
            offs[d, b] = off
            valid[d, b] = True
            for i in range(lo, hi):
                c0 = int(starts[i]) - base - off
                taps[d, b, i - lo, c0 : c0 + width] = op.taps[i]

    b0 = b1 = 0
    if not use_all_gather:
        b0, b1 = _interior_split(offs, valid, halo_lo, strip, win)
    return ShardedVOp(
        n_in=op.n_in,
        n_out=n_out,
        strip=strip,
        m=m,
        halo_lo=halo_lo,
        halo_hi=halo_hi,
        win=win,
        tile=tile,
        offs=offs.astype(np.int32),
        taps=taps,
        use_all_gather=use_all_gather,
        b_int0=b0,
        b_int1=b1,
    )


def shard_v_blocked(
    op: BandedOp, n_dev: int, padded_h: int, tile: int | None = None,
    in_bytes: int = 1,
) -> ShardedVOp:
    """Like ``shard_v_op`` but with 32-row-aligned local window starts and
    the K1 tiles (``pick_tile``), so that each rank's taps feed K1 as its
    vertical operator, with the raw strip and its halos as K1's input."""
    if tile is None:
        tile = pick_tile(op, in_bytes=in_bytes)
    base_sv = shard_v_op(op, n_dev, padded_h, tile=tile)
    if base_sv.use_all_gather:
        return base_sv
    n_out, width = op.n_out, op.width
    m, strip = base_sv.m, base_sv.strip
    halo_lo, halo_hi = base_sv.halo_lo, base_sv.halo_hi
    # 32-align the low halo so that interior window starts stay 32-aligned
    # after rebasing to strip coordinates (offs - halo_lo): the extra
    # exchanged rows carry zero taps.
    if halo_lo > 0 and _round_up(halo_lo, 32) <= strip:
        halo_lo = _round_up(halo_lo, 32)
    blocks = -(-m // tile)
    starts = op.starts.astype(np.int64)

    # 32-aligning the window starts can move them up to 31 rows lower;
    # widen the window to keep every block's span covered.
    win = 0
    for b0 in range(0, n_out, tile):
        b1 = min(b0 + tile, n_out)
        win = max(win, int(starts[b1 - 1]) + width - int(starts[b0]))
    win = _round_up(win + 31, 32)

    # 32-align the extended strip itself (by taking a few more halo rows
    # from the next rank; their taps are zero), then pull windows left so
    # that offs + win fits inside it.
    ext_len = halo_lo + strip + halo_hi
    ext_pad = _round_up(ext_len, 32)
    if ext_pad >= win and ext_pad - ext_len + halo_hi <= strip:
        halo_hi += ext_pad - ext_len
        max_off = ext_pad - win
    else:
        max_off = None  # tiny strip: the ext buffer is zero-padded

    offs = np.zeros((n_dev, blocks), dtype=np.int64)
    taps = np.zeros((n_dev, blocks, tile, win), dtype=np.float32)
    valid = np.zeros((n_dev, blocks), dtype=bool)
    for d in range(n_dev):
        base = d * strip - halo_lo
        for b in range(blocks):
            lo = d * m + b * tile
            # Clamp to this rank's own rows (see shard_v_op): giving rows
            # past m the next rank's taps would widen the window.
            hi = min(lo + tile, (d + 1) * m, n_out)
            if lo >= min((d + 1) * m, n_out):
                continue
            off = ((int(starts[lo]) - base) // 32) * 32
            if max_off is not None:
                off = min(off, max_off)
            assert off >= 0, (d, b, off)
            offs[d, b] = off
            valid[d, b] = True
            for i in range(lo, hi):
                c0 = int(starts[i]) - base - off
                taps[d, b, i - lo, c0 : c0 + width] = op.taps[i]

    b0, b1 = _interior_split(offs, valid, halo_lo, strip, win)
    # Interior rebasing (offs - halo_lo) must keep the 32-row alignment;
    # otherwise every block is border.
    if halo_lo % 32:
        logger.debug(
            "interior/halo overlap disabled: halo_lo=%d not 32-aligned",
            halo_lo,
        )
        b0 = b1 = 0
    return ShardedVOp(
        n_in=op.n_in,
        n_out=n_out,
        strip=strip,
        m=m,
        halo_lo=halo_lo,
        halo_hi=halo_hi,
        win=win,
        tile=tile,
        offs=offs.astype(np.int32),
        taps=taps,
        use_all_gather=False,
        b_int0=b0,
        b_int1=b1,
    )


def pad_rows(src: np.ndarray, n_dev: int) -> np.ndarray:
    """Zero-pad image rows (axis -2 of [..., H, W*C]) to a multiple of the
    row-mesh size."""
    h = src.shape[-2]
    pad = (-h) % n_dev
    if pad == 0:
        return src
    widths = [(0, 0)] * src.ndim
    widths[-2] = (0, pad)
    return np.pad(src, widths)


def local_strip(mesh, src):
    """This rank's part of the padded input ``src`` ([H_pad, W*C], or
    [B, H_pad, W*C] with frames split over dp): its strip of rows, and
    with frames its dp share of them (what ``shard_map``'s in_specs cut
    there)."""
    strip = src.shape[-2] // mesh.sp
    rows = slice(mesh.sp_index * strip, (mesh.sp_index + 1) * strip)
    if src.ndim == 2:
        return src[rows]
    per = src.shape[0] // mesh.dp
    return src[mesh.dp_index * per : (mesh.dp_index + 1) * per, rows]


def halo_rows(src: torch.Tensor, svop: ShardedVOp, d: int):
    """(h_lo, h_hi) of rank ``d`` of ``svop``'s mesh cut from the whole
    padded input ``src`` [..., H_pad, W*C] in one process: what
    ``comm.exchange_halos`` delivers to that rank, zeros on the edges."""
    strip, lo, hi = svop.strip, svop.halo_lo, svop.halo_hi
    n_dev = src.shape[-2] // strip
    lead, lanes = src.shape[:-2], src.shape[-1]
    h_lo = zeros_rows((*lead, lo, lanes), src.dtype, src.device)
    h_hi = zeros_rows((*lead, hi, lanes), src.dtype, src.device)
    if d > 0:
        h_lo = src[..., d * strip - lo : d * strip, :].contiguous()
    if d + 1 < n_dev:
        h_hi = src[..., (d + 1) * strip : (d + 1) * strip + hi, :].contiguous()
    return h_lo, h_hi


@dataclasses.dataclass(frozen=True)
class ShardedLaneOp:
    """Per-rank lane-blocked form of the horizontal banded operator for
    the 2-D (rows x cols) mesh: rank column j owns output pixels [j*m,
    (j+1)*m) and reads input lanes [j*strip_lanes - halo_lo, (j+1)*
    strip_lanes + halo_hi) of the interleaved [rows, W*C] image.  Window
    starts are 128-lane aligned in local coordinates (each rank's tap
    matrices absorb its own phase), so a rank's taps feed K1 as its lane
    operator: the 2-D counterpart of ``shard_v_blocked``."""

    n_out: int           # global output pixels
    c: int
    m: int               # output pixels per rank
    tile: int            # output pixels per block
    strip_lanes: int     # input lanes per rank
    halo_lo: int         # lanes (a multiple of c; of 128 where it fits)
    halo_hi: int         # lanes
    win_l: int           # window lanes per block (a multiple of 128)
    lanes_pad: int       # extended lanes the windows reach, zero-padded
    offs_l: np.ndarray   # int32 [n_dev, blocks]: local window starts
    taps_hi: torch.Tensor | None  # bf16 [n_dev, blocks, win_l, tile*c]
    taps_lo: torch.Tensor | None
    taps_q1: np.ndarray | None  # s8 limbs (1-byte input)
    taps_q0: np.ndarray | None
    q_shift: int
    chunk_rel: tuple[int, ...] | None  # shared by every rank and block
    win_c: int
    ctaps_hi: torch.Tensor | None  # bf16 [n_dev, blocks, n_ch, win_c, 128]
    ctaps_lo: torch.Tensor | None
    ctaps_q1: np.ndarray | None
    ctaps_q0: np.ndarray | None
    l1_max: float
    q_abs1: int
    q_abs0: int
    use_all_gather: bool
    b_int0: int = 0
    b_int1: int = 0

    @property
    def n_blocks(self) -> int:
        return self.offs_l.shape[1]


def shard_lane_blocked(
    op: BandedOp, n_dev: int, padded_w: int, c: int,
    tile: int | None = None, in_bytes: int = 1,
) -> ShardedLaneOp:
    """Split the horizontal BandedOp into per-rank lane-blocked operators
    of one shape, with the column-halo requirement in lanes
    (``shard_lane_blocked`` there, array for array).

    The limbs, norms and chunk sub-windows come from every rank's taps
    under one shift, so every rank's K1 has the fixed-point scales and
    the chunk offsets of the others.  ``halo_lo`` rounds up to 128 lanes
    where that fits the strip (local window starts stay 128-aligned after
    interior rebasing), else to a multiple of C: the C = 4 alpha bypass
    reads ``lane % c`` of pixel-aligned tiles."""
    if tile is None:
        tile = pick_lane_tile(op, c, in_bytes=in_bytes)
    if padded_w % n_dev or padded_w < op.n_in:
        raise ValueError(f"padded width {padded_w} must divide by {n_dev} and cover {op.n_in}")
    n_out, width = op.n_out, op.width
    m = -(-n_out // n_dev)
    strip_lanes = (padded_w // n_dev) * c
    blocks = -(-m // tile)
    starts = op.starts.astype(np.int64)

    # Global lane range needed by each rank's output pixels.
    need_lo = np.empty(n_dev, dtype=np.int64)
    need_hi = np.empty(n_dev, dtype=np.int64)
    for d in range(n_dev):
        lo, hi = d * m, min((d + 1) * m, n_out)
        if lo >= n_out:  # the rank owns only padding columns
            need_lo[d] = min(d * strip_lanes, op.n_in * c)
            need_hi[d] = need_lo[d]
        else:
            need_lo[d] = starts[lo] * c
            need_hi[d] = (starts[hi - 1] + width) * c

    halo_lo = int(max(0, np.max(np.arange(n_dev) * strip_lanes - need_lo)))
    halo_hi = int(max(0, np.max(need_hi - (np.arange(n_dev) + 1) * strip_lanes)))
    if halo_lo > strip_lanes or halo_hi > strip_lanes:
        return ShardedLaneOp(
            n_out=n_out, c=c, m=m, tile=tile, strip_lanes=strip_lanes,
            halo_lo=0, halo_hi=0, win_l=0, lanes_pad=0,
            offs_l=np.zeros((n_dev, blocks), np.int32),
            taps_hi=None, taps_lo=None, taps_q1=None, taps_q0=None,
            q_shift=0, chunk_rel=None, win_c=0,
            ctaps_hi=None, ctaps_lo=None, ctaps_q1=None, ctaps_q0=None,
            l1_max=0.0, q_abs1=0, q_abs0=0, use_all_gather=True,
        )
    if halo_lo > 0:
        if _round_up(halo_lo, 128) <= strip_lanes:
            halo_lo = _round_up(halo_lo, 128)
        else:
            halo_lo = _round_up(halo_lo, c)

    # One window size: the largest span of any (rank, block), plus up to
    # 127 lanes of the starts' floor alignment.
    offs = np.zeros((n_dev, blocks), dtype=np.int64)
    spans = np.zeros((n_dev, blocks), dtype=np.int64)
    valid = np.zeros((n_dev, blocks), dtype=bool)
    for d in range(n_dev):
        base = d * strip_lanes - halo_lo
        for b in range(blocks):
            lo = d * m + b * tile
            hi = min(lo + tile, (d + 1) * m, n_out)
            if lo >= min((d + 1) * m, n_out):
                continue
            off = ((starts[lo] * c - base) // 128) * 128
            assert off >= 0, (d, b, off)
            offs[d, b] = off
            spans[d, b] = (starts[hi - 1] + width) * c - base - off
            valid[d, b] = True
    win_l = _round_up(int(spans.max()), 128)

    # Overrunning tail windows are pulled left to end at the tile's end
    # (their extra left lanes carry zero taps).  The pulled starts stay
    # 128-aligned: first the high halo grows by < 128 lanes to make
    # ext_len - win_l a multiple of 128; where that does not fit the
    # strip, the halo grows by the whole overrun, else the tile is
    # zero-padded to lanes_pad.
    ext_len = halo_lo + strip_lanes + halo_hi
    if int(offs.max()) + win_l > ext_len:
        delta = (-(ext_len - win_l)) % 128
        if delta and halo_hi + delta <= strip_lanes:
            halo_hi += delta
            ext_len += delta
        max_off = ext_len - win_l
        pull = np.maximum(offs - max(max_off, 0), 0)
        if max_off >= 0 and max_off % 128 == 0 and int((spans + pull).max()) <= win_l:
            offs -= pull
        else:
            extra = int(offs.max()) + win_l - ext_len
            if extra > 0 and halo_hi + extra <= strip_lanes:
                halo_hi += extra
                ext_len += extra
    lanes_pad = max(int(offs.max()) + win_l, ext_len)

    dense = np.zeros((n_dev, blocks, win_l, tile * c), dtype=np.float32)
    for d in range(n_dev):
        base = d * strip_lanes - halo_lo
        for b in range(blocks):
            if not valid[d, b]:
                continue
            lo = d * m + b * tile
            hi = min(lo + tile, (d + 1) * m, n_out)
            for i in range(lo, hi):
                s_l = int(starts[i]) * c - base - int(offs[d, b])
                t = i - lo
                for ch in range(c):
                    dense[d, b, (s_l + ch) : (s_l + width * c + ch) : c, t * c + ch] = op.taps[i]

    # Scales and norms over every rank (the single card's lane operator
    # derives them from the same taps: ops/lanes.py).
    q1 = q0 = None
    q_shift = 0
    if in_bytes <= 1:
        q1, q0, q_shift = quantize_limbs(dense)
        if not first_pass_overflow_safe(q1, q0, contract_axis=2):
            q1 = q0 = None  # pragma: no cover - pathological taps
    l1_max = float(np.abs(dense).sum(axis=2).max())
    q_abs1 = 0 if q1 is None else int(np.abs(q1.astype(np.int64)).sum(axis=2).max())
    q_abs0 = 0 if q0 is None else int(np.abs(q0.astype(np.int64)).sum(axis=2).max())
    hi_t, lo_t = bf16_split(dense)

    # Chunked form: per 128-lane output chunk, the contraction lanes used
    # by any rank and block (K1 reads one chunk offset for all of them).
    chunk_rel = None
    win_c = 0
    c_hi = c_lo = c_q1 = c_q0 = None
    n_ch = (tile * c) // 128
    if n_ch > 1 and (tile * c) % 128 == 0:
        rel = np.empty(n_ch, dtype=np.int64)
        ends = np.empty(n_ch, dtype=np.int64)
        for k in range(n_ch):
            used = np.nonzero(np.any(dense[:, :, :, k * 128 : (k + 1) * 128], axis=(0, 1, 3)))[0]
            lo_u, hi_u = (int(used[0]), int(used[-1]) + 1) if used.size else (0, 1)
            rel[k] = (lo_u // 128) * 128
            ends[k] = hi_u
        win_c = _round_up(int((ends - rel).max()), 128)
        if win_c < win_l:
            rel = np.minimum(rel, win_l - win_c)
            chunk_rel = tuple(int(r) for r in rel)
            sl = [
                (slice(None), slice(None), slice(r, r + win_c), slice(k * 128, (k + 1) * 128))
                for k, r in enumerate(chunk_rel)
            ]
            c_hi = torch.stack([hi_t[x] for x in sl], dim=2)
            c_lo = torch.stack([lo_t[x] for x in sl], dim=2)
            if q1 is not None:
                c_q1 = np.stack([q1[x] for x in sl], axis=2)
                c_q0 = np.stack([q0[x] for x in sl], axis=2)

    b0, b1 = _interior_split(offs, valid, halo_lo, strip_lanes, win_l)
    if halo_lo % 128:
        # Interior rebasing (offs - halo_lo) must keep 128-lane starts.
        logger.debug("2-D interior/halo overlap disabled on cols: halo_lo=%d not 128-aligned", halo_lo)
        b0 = b1 = 0
    return ShardedLaneOp(
        n_out=n_out, c=c, m=m, tile=tile, strip_lanes=strip_lanes,
        halo_lo=halo_lo, halo_hi=halo_hi, win_l=win_l, lanes_pad=lanes_pad,
        offs_l=offs.astype(np.int32),
        taps_hi=hi_t, taps_lo=lo_t, taps_q1=q1, taps_q0=q0,
        q_shift=q_shift, chunk_rel=chunk_rel, win_c=win_c,
        ctaps_hi=c_hi, ctaps_lo=c_lo, ctaps_q1=c_q1, ctaps_q0=c_q0,
        l1_max=l1_max, q_abs1=q_abs1, q_abs0=q_abs0,
        use_all_gather=False, b_int0=b0, b_int1=b1,
    )


def _h_tap_arrays(slb: ShardedLaneOp, use_int8: bool):
    """(ta, tb, chunked): the two per-rank lane tap tensors K1 reads in
    this mode, [n_dev, blocks, ...]: the limbs or the bf16 pair, chunked
    where the operator has a chunked form."""
    if use_int8:
        if slb.ctaps_q1 is not None:
            return slb.ctaps_q1, slb.ctaps_q0, True
        return slb.taps_q1, slb.taps_q0, False
    if slb.ctaps_hi is not None:
        return slb.ctaps_hi, slb.ctaps_lo, True
    return slb.taps_hi, slb.taps_lo, False


def pad_cols(src: np.ndarray, n_dev: int, c: int) -> np.ndarray:
    """Zero-pad image columns (axis -1 holds W*C interleaved lanes) to a
    multiple of the column-mesh size.  Sound as ``pad_rows`` is: the
    composed horizontal taps never reference columns >= src_w."""
    w = src.shape[-1] // c
    pad = (-w) % n_dev
    if pad == 0:
        return src
    widths = [(0, 0)] * src.ndim
    widths[-1] = (0, pad * c)
    return np.pad(src, widths)


def _halo_fits(op: BandedOp, n_dev: int, padded_len: int, c: int = 1) -> bool:
    """The ``use_all_gather`` rule of ``shard_v_op`` and
    ``shard_lane_blocked`` (every rank's window overhang fits the
    neighbouring strip) without building any taps, for ``suggest_grid``.
    ``c`` > 1 tests the lane (column) axis."""
    if n_dev == 1:
        return True
    n_out, width = op.n_out, op.width
    m = -(-n_out // n_dev)
    strip = (padded_len // n_dev) * c
    starts = op.starts.astype(np.int64)
    d = np.arange(n_dev)
    lo = np.minimum(d * m, n_out - 1)
    hi = np.minimum((d + 1) * m, n_out) - 1
    need_lo = np.where(d * m >= n_out, np.minimum(d * strip, op.n_in * c), starts[lo] * c)
    need_hi = np.where(d * m >= n_out, need_lo, (starts[np.maximum(hi, 0)] + width) * c)
    halo_lo = int(max(0, np.max(d * strip - need_lo)))
    halo_hi = int(max(0, np.max(need_hi - (d + 1) * strip)))
    return halo_lo <= strip and halo_hi <= strip


def suggest_grid(plan, n_devices: int) -> tuple[int, int]:
    """An (rows, cols) grid for ``n_devices`` ranks on one image of a
    ResizePlan, by the JAX package's rule (its measured tables are a
    TPU's, not this port's): the factorization with the fewest rows whose
    axes both stay on the halo route (halo <= strip; the all-gather
    forfeits the scaling), else the first with strips of 8 or more, else
    (1, n)."""
    c = plan.el_count
    h, w = plan.src_h, plan.src_w
    best = None
    for r in [d for d in range(1, n_devices + 1) if n_devices % d == 0]:
        s = n_devices // r
        padded_h = h + ((-h) % r)
        padded_w = w + ((-w) % s)
        if padded_h // r < 8 or padded_w // s < 8:
            continue
        if _halo_fits(plan.v.op, r, padded_h) and _halo_fits(plan.h.op, s, padded_w, c):
            return (r, s)
        if best is None:
            best = (r, s)
    return best if best is not None else (1, n_devices)


def local_tile(mesh, src):
    """This rank's tile of the padded input ``src`` ([H_pad, W_pad*C], or
    [B, H_pad, W_pad*C] with frames split over dp) on a 2-D mesh: row band
    ``sp_index`` of ``sp``, column band ``cp_index`` of ``cp`` (what
    ``shard_map``'s in_specs cut there)."""
    strip = src.shape[-2] // mesh.sp
    lanes = src.shape[-1] // mesh.cp
    i, j = mesh.sp_index, mesh.cp_index
    tile = src[..., i * strip : (i + 1) * strip, j * lanes : (j + 1) * lanes]
    if src.ndim == 2:
        return tile
    per = src.shape[0] // mesh.dp
    return tile[mesh.dp_index * per : (mesh.dp_index + 1) * per]


def halo_tiles(src: np.ndarray, svop: ShardedVOp, slop: ShardedLaneOp, i: int, j: int):
    """(x, xc, ext) of tile (i, j) cut from the whole padded input ``src``
    [..., H_pad, W_pad*C] in one process: the raw tile, the tile with its
    column halos and the tile with both, zeros past the image's edges:
    what the 2-D executor's two exchanges deliver to that rank
    (``tools/probe_strip2d_tpu.py``'s emulation there)."""
    hlr, hhr, sr = svop.halo_lo, svop.halo_hi, svop.strip
    hll, hhl, sl = slop.halo_lo, slop.halo_hi, slop.strip_lanes
    pad = [(0, 0)] * (src.ndim - 2) + [(hlr, hhr), (hll, hhl)]
    z = np.pad(src, pad)
    ext = np.ascontiguousarray(z[..., i * sr : i * sr + hlr + sr + hhr, j * sl : j * sl + hll + sl + hhl])
    xc = np.ascontiguousarray(ext[..., hlr : hlr + sr, :])
    x = np.ascontiguousarray(src[..., i * sr : (i + 1) * sr, j * sl : (j + 1) * sl])
    return x, xc, ext


# ---------------------------------------------------------------------------
# Device half: one rank's strip body
# ---------------------------------------------------------------------------


def _cat_rows(ts: list[torch.Tensor], rows: int = 0) -> torch.Tensor:
    """``ts`` concatenated along axis -2, then zero rows up to ``rows``,
    through uint8 views of the last axis (PyTorch's u16 has few ops)."""
    dtype = ts[0].dtype
    b = [t.contiguous().view(torch.uint8) for t in ts]
    have = sum(t.shape[-2] for t in b)
    if rows > have:
        b.append(torch.zeros(
            (*b[0].shape[:-2], rows - have, b[0].shape[-1]),
            dtype=torch.uint8, device=b[0].device,
        ))
    return (b[0] if len(b) == 1 else torch.cat(b, dim=-2)).view(dtype)


def _stack(ys: list[torch.Tensor]) -> torch.Tensor:
    """``torch.stack(ys)`` through uint8 views (see ``_cat_rows``)."""
    return torch.stack([y.contiguous().view(torch.uint8) for y in ys]).view(ys[0].dtype)


@dataclasses.dataclass(frozen=True)
class Strip:
    """One rank's strip body, a pure function of its strip ``x`` and its
    two halo blocks: ``strip(x, h_lo, h_hi)`` -> the rank's ``m`` output
    rows.  ``parts`` are (operands, reads_ext) in output-row order; each
    is one ``apply(operands, input)`` over the ext buffer (halo_lo rows,
    the strip, halo_hi rows, zero rows up to ``ext_rows``) or, for the
    interior blocks, over the strip alone.  ``local`` runs the interior
    parts, which may start before the halos arrive; ``finish`` the rest."""

    parts: tuple
    apply: Callable
    ext_rows: int
    m: int

    def local(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [self.apply(p, x) for p, on_ext in self.parts if not on_ext]

    def ext(self, x, h_lo, h_hi) -> torch.Tensor:
        return _cat_rows([h_lo, x, h_hi], self.ext_rows)

    def finish(self, x, h_lo, h_hi, local: list[torch.Tensor]) -> torch.Tensor:
        ext = None
        if any(on_ext for _, on_ext in self.parts):
            ext = self.ext(x, h_lo, h_hi)
        mid = iter(local)
        ys = [self.apply(p, ext) if on_ext else next(mid) for p, on_ext in self.parts]
        return _cat_rows(ys)[: self.m]

    def __call__(self, x, h_lo, h_hi) -> torch.Tensor:
        return self.finish(x, h_lo, h_hi, self.local(x))


def _rank_vop(
    sv: ShardedVOp, d: int, blocks: slice, n_in: int, rebase: int = 0,
    limbs: dict | None = None,
) -> BlockedBandedOp:
    """Rank ``d``'s V operator over ``blocks`` for an input of ``n_in``
    rows, window starts moved up by ``rebase`` rows (``mk_vop`` there)."""
    taps = np.ascontiguousarray(sv.taps[d, blocks])
    hi, lo = bf16_split(taps)
    offs = sv.offs[d, blocks] - rebase
    q = {}
    if limbs is not None:
        q = dict(
            taps_q1=np.ascontiguousarray(limbs["q1"][d, blocks]),
            taps_q0=np.ascontiguousarray(limbs["q0"][d, blocks]),
            q_shift=limbs["q_shift"], l1_max=limbs["l1_max"],
            q_abs1=limbs["q_abs1"], q_abs0=limbs["q_abs0"],
        )
    return BlockedBandedOp(
        n_in=n_in, n_out=taps.shape[0] * sv.tile,
        n_in_pad=max(n_in, int(offs.max()) + sv.win),
        tile=sv.tile, win=sv.win, offs=offs.astype(np.int32), taps=taps,
        taps_hi=hi, taps_lo=lo, **q,
    )


def _parts(sv: ShardedVOp, d: int, ext_rows: int, make: Callable) -> tuple:
    """(operands, reads_ext) of rank ``d``: one part over the ext buffer,
    or with an interior range the border blocks over ext and the interior
    ones over the strip (``_overlapped_v`` / ``pallas_fn`` there)."""
    blocks = sv.taps.shape[1]
    b0, b1 = sv.b_int0, sv.b_int1
    if b1 <= b0:
        return ((make(slice(None), ext_rows, 0), True),)
    parts = []
    if b0 > 0:
        parts.append((make(slice(0, b0), ext_rows, 0), True))
    parts.append((make(slice(b0, b1), sv.strip, sv.halo_lo), False))
    if b1 < blocks:
        parts.append((make(slice(b1, None), ext_rows, 0), True))
    return tuple(parts)


def _k1(ops, x: torch.Tensor) -> torch.Tensor:
    if isinstance(ops, FusedInt8Operands):
        return apply_fused_int8(ops, x)
    return apply_fused_split(ops, x)


def _global_limbs(svb: ShardedVOp) -> dict | None:
    """The int8 limbs of every rank's taps under ONE shift, with the
    magnitudes K1's inter-pass scale reads (``:1644-1689`` there), or None
    when the first pass could overflow s32."""
    q1, q0, shift = quantize_limbs(svb.taps)
    if not first_pass_overflow_safe(q1, q0, contract_axis=3):
        return None
    return dict(
        q1=q1, q0=q0, q_shift=shift,
        l1_max=float(np.abs(svb.taps).sum(axis=3).max()),
        q_abs1=int(np.abs(q1.astype(np.int64)).sum(axis=3).max()),
        q_abs0=int(np.abs(q0.astype(np.int64)).sum(axis=3).max()),
    )


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What the AVIR and LANCIR makers give the shared builder."""

    v_op: BandedOp
    h_op: BandedOp
    c: int
    new_w: int
    new_h: int
    in_bytes: int
    precision: str
    in_exact_bf16: bool
    int8_eligible: bool       # before the limbs' feasibility
    gamma: bool               # int8 feasibility with the gamma first pass
    kernel_route: bool        # the kernel route unless exact / all-gather
    int8_kw: dict             # prepare_fused_int8's epilogue
    split_kw: dict            # prepare_fused_split's epilogue and output
    pre: Callable             # library route: raw strip -> float32
    post: Callable            # library route: float32 rows -> output
    errdiff: bool
    trunc_bits: int
    out_max: float
    out_dtype: torch.dtype
    scan_order: bool


def _dev_taps(op: BlockedBandedOp, mode: str, device):
    """apply_blocked's taps on the device: float32, or the bf16 pair."""
    if mode == "exact":
        return torch.from_numpy(op.taps).to(device)
    return op.taps_hi.to(device), op.taps_lo.to(device)


def _library_pass(sv: ShardedVOp, d: int, group, mode: str, device) -> Callable:
    """Rank ``d``'s banded pass of ``sv`` on ``torch.bmm``
    (``apply_blocked``): [B, strip, R] float32 -> [B, m, R].  The halos
    come over ``group`` while the interior blocks run (``_overlapped_v``
    there), or the strips are all-gathered where a halo exceeds a strip."""

    def make(blocks, n_in, rebase):
        vop = _rank_vop(sv, d, blocks, n_in, rebase)
        return vop, _dev_taps(vop, mode, device)

    def apply(part, x):
        vop, taps = part
        return apply_blocked(vop, x, mode, taps=taps)

    if sv.use_all_gather:
        # Window offsets in the gathered image's coordinates.
        whole = make(slice(None), sv.offs.shape[0] * sv.strip, 0)

        def run(xb: torch.Tensor) -> torch.Tensor:
            return torch.stack([apply(whole, e)[: sv.m] for e in all_gather_rows(xb, group)])

        return run
    ext_rows = max(int(sv.offs.max()) + sv.win, sv.halo_lo + sv.strip + sv.halo_hi)
    strip = Strip(_parts(sv, d, ext_rows, make), apply, ext_rows, sv.m)

    def run(xb: torch.Tensor) -> torch.Tensor:
        pending = exchange_halos(xb, sv, group, async_op=True)
        local = [strip.local(f) for f in xb]
        h_lo, h_hi = pending.wait()
        return torch.stack([strip.finish(f, h_lo[k], h_hi[k], local[k]) for k, f in enumerate(xb)])

    return run


def _int8_limbs_for(spec: _Spec, svb: ShardedVOp, lop) -> dict | None:
    """The V limbs of every rank under one shift where the int8 route
    serves ``spec`` with the lane operator ``lop`` (anything carrying the
    lane limbs' fields), else None."""
    if not spec.int8_eligible or lop.taps_q1 is None:
        return None
    limbs = _global_limbs(svb)
    if limbs is None:
        return None
    # int8_feasible reads only these fields of the V operator.
    probe = types.SimpleNamespace(
        taps_q1=limbs["q1"],
        **{k: limbs[k] for k in ("q_shift", "l1_max", "q_abs1", "q_abs0")},
    )
    return limbs if int8_feasible(probe, lop, "vh", spec.gamma) else None


def _errdiff_tiles(spec: _Spec, z: torch.Tensor, gather: Callable, rows: int,
                   lanes: int, mine: tuple) -> torch.Tensor:
    """Error diffusion of the mesh's pre-dither float32 tiles ``z`` [B,
    m, lanes_m]: ``gather`` them into the padded image [B, rows, lanes],
    run K4 once on the whole image on every rank, and keep this rank's
    (row slice, lane slice) ``mine``, zeros past the image, as there."""
    c, new_w, new_h = spec.c, spec.new_w, spec.new_h
    frames = []
    for img in gather(z):
        img = img[:new_h, : new_w * c].reshape(new_h, new_w, c).contiguous()
        q = errdiff_wavefront(
            img, spec.trunc_bits, spec.out_max, out_dtype=spec.out_dtype,
            scan_order=spec.scan_order,
        ).reshape(new_h, new_w * c)
        frames.append(_embed(q, rows, lanes)[mine])
    return _stack(frames)


def _build(spec: _Spec, mesh, tile: int, pallas_tile, halo_overlap: bool):
    n_dev, d, device = mesh.sp, mesh.sp_index, torch.device(mesh.device)
    c, new_w = spec.c, spec.new_w
    mode_first, mode_second = resolve_modes(spec.precision, spec.in_exact_bf16)
    padded_h = spec.v_op.n_in + ((-spec.v_op.n_in) % n_dev)
    svop = shard_v_op(spec.v_op, n_dev, padded_h, tile=tile)
    kernel = spec.kernel_route and spec.precision != "exact" and not svop.use_all_gather

    if kernel:
        svb = shard_v_blocked(spec.v_op, n_dev, padded_h, tile=pallas_tile, in_bytes=spec.in_bytes)
        lop = lane_block_banded(spec.h_op, c, in_bytes=spec.in_bytes)
        if spec.in_bytes >= 2 or not halo_overlap:
            # One launch over the ext buffer is the default, as there;
            # 2- and 4-byte strips never split.
            svb = dataclasses.replace(svb, b_int0=0, b_int1=0)
        ext_rows = _round_up(
            max(int(svb.offs.max()) + svb.win, svb.halo_lo + svb.strip + svb.halo_hi),
            32,
        )
        limbs = _int8_limbs_for(spec, svb, lop)
        if limbs is not None:
            route = "int8"

            def make(blocks, n_in, rebase):
                vop = _rank_vop(svb, d, blocks, n_in, rebase, limbs)
                return prepare_fused_int8(vop, lop, "vh", device, **spec.int8_kw)
        else:
            route = "split"

            def make(blocks, n_in, rebase):
                vop = _rank_vop(svb, d, blocks, n_in, rebase)
                return prepare_fused_split(
                    vop, lop, "vh", mode_first, mode_second, device, **spec.split_kw
                )

        sv = svb
        strip = Strip(_parts(svb, d, ext_rows, make), _k1, ext_rows, svb.m)

        def rows_of(xb: torch.Tensor) -> torch.Tensor:
            pending = exchange_halos(xb, svb, mesh.sp_group, async_op=True)
            local = [strip.local(f) for f in xb]
            h_lo, h_hi = pending.wait()
            return _stack([
                strip.finish(f, h_lo[i], h_hi[i], local[i]) for i, f in enumerate(xb)
            ])
    else:
        route, sv, strip = "library", svop, None
        hop = block_banded(spec.h_op, in_bytes=spec.in_bytes)
        h_taps = _dev_taps(hop, mode_first, device)
        w = spec.h_op.n_in
        v_pass = _library_pass(svop, d, mesh.sp_group, mode_second, device)

        def h_pass(x: torch.Tensor) -> torch.Tensor:
            rows = x.shape[0]
            x = spec.pre(x).reshape(rows, w, c).transpose(0, 1).reshape(w, rows * c)
            x = apply_blocked(hop, x, mode_first, taps=h_taps)  # [new_w, rows*c]
            return x.reshape(new_w, rows, c).transpose(0, 1).reshape(rows, new_w * c)

        def rows_of(xb: torch.Tensor) -> torch.Tensor:
            return _stack([spec.post(y) for y in v_pass(torch.stack([h_pass(f) for f in xb]))])

    body = rows_of
    m = sv.m
    if spec.errdiff:
        # The pre-dither float32 strips -> one all-gather of the
        # (post-resize) image -> K4 on the whole image, replicated on
        # every sp rank -> each rank keeps its own rows.
        def body(xb: torch.Tensor) -> torch.Tensor:
            return _errdiff_tiles(
                spec, rows_of(xb), lambda z: all_gather_rows(z, mesh.sp_group),
                n_dev * m, new_w * c, (slice(d * m, (d + 1) * m), slice(None)),
            )

    run = _runner(body, (sv.strip, spec.h_op.n_in * c), device, "strip")
    run.route = route
    run.svop = sv
    run.strip = strip
    return run


def _runner(body: Callable, shape: tuple, device, what: str) -> Callable:
    """The executor's entry: this rank's [rows, lanes] or [B, rows,
    lanes] input of ``shape`` on ``device`` through ``body`` (batched)."""

    def run(x: torch.Tensor) -> torch.Tensor:
        if x.dim() not in (2, 3) or tuple(x.shape[-2:]) != shape:
            raise ValueError(f"expected this rank's {what} [..., {shape[0]}, {shape[1]}], got {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{what} on {x.device}, mesh device {device}")
        x = x.contiguous()
        y = body(x if x.dim() == 3 else x[None])
        return y if x.dim() == 3 else y[0]

    return run


def _check(engine: str, dither: str = "default") -> None:
    if engine not in ("auto", "pallas"):
        check_engine(engine)  # "xla": the library route is precision="exact"
        raise ValueError(f"unknown engine {engine!r} for the mesh")
    if dither not in DITHERS:
        raise ValueError(f"unknown dither {dither!r}")


def _avir_spec(plan, precision: str, dither: str) -> _Spec:
    """The AVIR makers' ``_Spec`` of a ResizePlan."""
    errdiff = dither in ERRDIFF and not plan.is_out_float
    in_b = 4 if plan.is_in_float else (1 if plan.in_type_max == 255.0 else 2)
    out_dt = out_dtype_of(plan)
    out_bits = 8 if plan.out_type_max == 255.0 else 16
    trunc_bits = 0 if plan.is_out_float else out_bits - plan.res_bit_depth
    gamma_kw = dict(
        gamma=plan.use_srgb_gamma, alpha_index=plan.alpha_index,
        in_gamma_mult=plan.in_gamma_mult, out_gamma_mult=plan.out_gamma_mult,
    )
    c = plan.el_count

    def pre(x):
        x = to_float32(x)
        if plan.use_srgb_gamma:
            x = srgb_to_linear_2d(x * f32(plan.in_gamma_mult), c, plan.alpha_index)
        return x

    def post(y):
        if plan.use_srgb_gamma:
            y = linear_to_srgb_2d(y, c, plan.alpha_index)
            if plan.out_gamma_mult != 0.0:
                y = y * f32(plan.out_gamma_mult)
        if plan.is_out_float or errdiff:
            return y  # errdiff: the pre-dither image, dithered after the gather
        return default_dither(y, trunc_bits, plan.out_type_max).to(torch.int32).to(out_dt)

    kernel_out = torch.float32 if plan.is_out_float or errdiff else out_dt
    return _Spec(
        v_op=plan.v.op, h_op=plan.h.op, c=c, new_w=plan.new_w, new_h=plan.new_h,
        in_bytes=in_b, precision=precision, in_exact_bf16=in_exact_bf16(plan),
        # errdiff feeds its residual back and sub-8-bit outputs quantize in
        # 2^trunc_bits steps: both need the full-precision route.
        int8_eligible=(
            precision == "auto" and in_b == 1 and out_dt == torch.uint8
            and not errdiff and trunc_bits == 0
        ),
        gamma=plan.use_srgb_gamma,
        kernel_route=True,
        int8_kw=gamma_kw,
        split_kw=dict(
            out_dtype=kernel_out, out_max=plan.out_type_max,
            trunc_bits=0 if errdiff else trunc_bits, **gamma_kw,
        ),
        pre=pre, post=post, errdiff=errdiff, trunc_bits=trunc_bits,
        out_max=plan.out_type_max, out_dtype=out_dt,
        scan_order=errdiff_impl(dither) == "scan",
    )


def _lancir_spec(plan, precision: str) -> _Spec:
    """The LANCIR makers' ``_Spec`` of a LancirPlan."""
    out_dt = (
        torch.float32 if plan.is_out_float
        else torch.uint8 if plan.clamp == 255.0 else torch.uint16
    )
    epi = dict(scale=plan.out_mul, round_mode="even")

    def post(y):
        if plan.out_mul != 1.0:
            y = y * f32(plan.out_mul)
        if plan.is_out_float:
            return y
        return torch.clamp(torch.round(y), 0.0, plan.clamp).to(torch.int32).to(out_dt)

    return _Spec(
        v_op=plan.v, h_op=plan.h, c=plan.el_count, new_w=plan.new_w,
        new_h=plan.new_h, in_bytes=plan.in_itemsize, precision=precision,
        in_exact_bf16=plan.in_exact_bf16,
        int8_eligible=precision == "auto" and plan.in_exact_bf16 and plan.clamp == 255.0,
        gamma=False,
        kernel_route=not plan.is_out_float,
        int8_kw=epi,
        split_kw=dict(out_dtype=out_dt, out_max=plan.clamp, **epi),
        pre=to_float32, post=post, errdiff=False, trunc_bits=0,
        out_max=plan.clamp, out_dtype=out_dt, scan_order=False,
    )


def make_sharded_avir_executor(
    plan,
    mesh,
    precision: str = "auto",
    tile: int = 64,
    engine: str = "auto",
    pallas_tile: int | None = None,
    dither: str = "default",
    halo_overlap: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's executor of a ResizePlan on ``mesh`` (a
    ``multihost.DpSpMesh``; ``make_sharded_avir_executor`` there, whose
    ``Mesh`` and axis names it replaces).

    Call it on every rank of the mesh at once, with the rank's strip of the
    row-padded image (``pad_rows``, ``local_strip``): [strip, W*C], or
    [B_local, strip, W*C] with frames on the dp axis, on ``mesh.device``.
    It returns the rank's output rows [m, new_w*C] (or [B_local, m,
    new_w*C]) on that device; ``assemble`` gathers the image.

    ``engine``: "auto" or "pallas" run the kernel route (the hand-written
    K1 per strip, one launch per frame); "xla" raises ``ValueError`` (the
    library route is ``precision="exact"``).  ``halo_overlap=True`` runs
    a 1-byte strip's interior blocks before the halos arrive and its
    border blocks after (three launches; the same bits).  ``dither``:
    "default" rounds per strip; "errdiff" / "errdiff-wavefront" /
    "errdiff-device" gather the pre-dither float32 strips with one
    all-gather and run K4 on the whole image on every sp rank
    ("errdiff-device" in the sequential scan's sum order), each rank
    keeping its rows.  Float output ignores the dither.  sRGB gamma runs
    in K1 (int8 or split), with the alpha bypass.

    The function carries ``run.route`` ("int8", "split" or "library"),
    ``run.svop`` (the ``ShardedVOp`` it runs) and ``run.strip`` (the pure
    ``Strip`` of the kernel route, else None)."""
    _check(engine, dither)
    return _build(_avir_spec(plan, precision, dither), mesh, tile, pallas_tile, halo_overlap)


def make_sharded_lancir_executor(
    plan,
    mesh,
    precision: str = "auto",
    tile: int = 64,
    engine: str = "auto",
    pallas_tile: int | None = None,
    halo_overlap: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's executor of a LancirPlan on ``mesh`` (the row-strip
    scheme and call contract of ``make_sharded_avir_executor``), with
    LANCIR's round-half-even output stage: integer output runs K1 (int8
    for u8 in and out at ``precision="auto"``, else split) with ``scale``
    = the plan's ``out_mul``; float output and ``precision="exact"`` take
    the library route."""
    _check(engine)
    return _build(_lancir_spec(plan, precision), mesh, tile, pallas_tile, halo_overlap)


def assemble(mesh, y: torch.Tensor, new_h: int) -> torch.Tensor:
    """The whole output from every rank's rows ``y`` (``run``'s result;
    collective: every rank calls it): [new_h, new_w*C], or with frames
    [B, new_h, new_w*C] in dp order (``_slice_padded_out`` there)."""
    return _frames(mesh, all_gather_rows(y, mesh.sp_group)[..., :new_h, :])


def _frames(mesh, full: torch.Tensor) -> torch.Tensor:
    """``full`` [B_local, h, lanes] of every dp index, in dp order."""
    if full.dim() == 3 and mesh.dp > 1:
        b, h, lanes = full.shape
        frames = all_gather_rows(full.reshape(b * h, lanes).contiguous(), mesh.dp_group)
        full = frames.reshape(mesh.dp * b, h, lanes)
    return full


# ---------------------------------------------------------------------------
# Device half of the 2-D (rows x cols) mesh: one rank's tile body
# ---------------------------------------------------------------------------


def _cat_lanes(ts: list[torch.Tensor]) -> torch.Tensor:
    """``ts`` concatenated along the lanes through uint8 views (each
    piece's bytes hold whole elements)."""
    dtype = ts[0].dtype
    return torch.cat([t.contiguous().view(torch.uint8) for t in ts], dim=-1).view(dtype)


def _embed(q: torch.Tensor, rows: int, lanes: int) -> torch.Tensor:
    """``q`` [r, l] at the top left of zeros [rows, lanes], through bytes."""
    out = zeros_rows((rows, lanes), q.dtype, q.device)
    n = q.element_size()
    out.view(torch.uint8)[: q.shape[0], : q.shape[1] * n] = q.contiguous().view(torch.uint8)
    return out


def _take(a, d: int, idx: np.ndarray):
    """Rank ``d``'s blocks ``idx`` of a per-rank tap array (NumPy or torch)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[d][torch.from_numpy(idx)].contiguous()
    return np.ascontiguousarray(a[d, idx])


def _rank_lop(
    slb: ShardedLaneOp, d: int, idx: np.ndarray, lanes_pad: int, use_int8: bool,
    rebase: int = 0,
) -> LaneBlockedOp:
    """Rank ``d``'s lane operator over the blocks ``idx`` (``mk_lop``
    there): the mode's lane taps with every rank's shift, norms and chunk
    offsets, window starts moved left by ``rebase`` lanes."""
    ta, tb, chunked = _h_tap_arrays(slb, use_int8)
    a, b = _take(ta, d, idx), _take(tb, d, idx)
    if use_int8:
        # The dense limbs also tell int8_feasible that the limbs exist.
        kw = dict(taps_hi=None, taps_lo=None, taps_q1=_take(slb.taps_q1, d, idx),
                  taps_q0=_take(slb.taps_q0, d, idx))
        if chunked:
            kw.update(ctaps_q1=a, ctaps_q0=b)
    elif chunked:
        kw = dict(taps_hi=None, taps_lo=None, ctaps_hi=a, ctaps_lo=b)
    else:
        kw = dict(taps_hi=a, taps_lo=b)
    return LaneBlockedOp(
        n_in=slb.strip_lanes // slb.c, n_out=len(idx) * slb.tile, c=slb.c,
        tile=slb.tile, win_l=slb.win_l, lanes_pad=lanes_pad,
        offs_l=(slb.offs_l[d, idx] - rebase).astype(np.int32),
        q_shift=slb.q_shift, chunk_rel=slb.chunk_rel if chunked else None,
        win_c=slb.win_c if chunked else 0, l1_max=slb.l1_max,
        q_abs1=slb.q_abs1, q_abs0=slb.q_abs0, **kw,
    )


@dataclasses.dataclass(frozen=True)
class Tile:
    """One rank's tile body on the 2-D mesh, a pure function of its raw
    tile ``x``, its column-extended tile ``xc`` (``x`` with its column
    halos) and its fully extended tile ``ext`` (``xc`` with its row halos):
    ``compute(x, xc, ext)`` -> the rank's [m_h, m_w*C] output (``compute``
    there).  Each part is one K1 launch's operands: ``a``, the V-interior x
    H-interior blocks over ``x``; ``b``, the V-interior x H-border (or
    all-H) blocks over ``xc``; ``c``, the V-border x all-H blocks over
    ``ext``, or with one launch (the default) every block.  ``local`` runs
    ``a``, which needs no halo; ``middle`` runs ``b``, which needs the
    column halos; ``finish`` the rest."""

    a: object
    b: object
    c: object
    b0v: int       # the V-interior blocks' first (output rows b0v * tile_v)
    tile_v: int
    b0h: int       # the H-interior blocks' first (output lanes b0h * tc)
    tc: int
    m_h: int
    out_lanes: int

    @property
    def parts(self) -> tuple:
        """(operands, input) in launch order, the input "x", "xc" or "ext"."""
        return tuple(
            (p, on) for p, on in ((self.a, "x"), (self.b, "xc"), (self.c, "ext"))
            if p is not None
        )

    def local(self, x: torch.Tensor):
        return None if self.a is None else _k1(self.a, x)

    def middle(self, xc: torch.Tensor, local):
        if self.b is None:
            return local
        out = _k1(self.b, xc)
        if local is None:
            return out
        k = self.b0h * self.tc
        return _cat_lanes([out[:, :k], local, out[:, k:]])

    def finish(self, ext: torch.Tensor, mid) -> torch.Tensor:
        out = mid
        if self.c is not None:
            out = _k1(self.c, ext)
            if mid is not None:
                k = self.b0v * self.tile_v
                out = _cat_rows([out[:k], mid, out[k:]])
        return out[: self.m_h, : self.out_lanes]

    def compute(self, x, xc, ext) -> torch.Tensor:
        return self.finish(ext, self.middle(xc, self.local(x)))


def _build_2d(spec: _Spec, mesh, tile: int, pallas_tile, halo_overlap: bool):
    r, s = mesh.sp, mesh.cp
    i, j, device = mesh.sp_index, mesh.cp_index, torch.device(mesh.device)
    c = spec.c
    mode_first, mode_second = resolve_modes(spec.precision, spec.in_exact_bf16)
    h, w = spec.v_op.n_in, spec.h_op.n_in
    padded_h, padded_w = h + ((-h) % r), w + ((-w) % s)
    svv = shard_v_op(spec.v_op, r, padded_h, tile=tile)
    svh = shard_v_op(spec.h_op, s, padded_w, tile=tile)
    m_h, m_w = svv.m, svh.m
    kernel = spec.kernel_route and spec.precision != "exact"
    if kernel:
        svb = shard_v_blocked(spec.v_op, r, padded_h, tile=pallas_tile, in_bytes=spec.in_bytes)
        slb = shard_lane_blocked(spec.h_op, s, padded_w, c, in_bytes=spec.in_bytes)
        kernel = not (svb.use_all_gather or slb.use_all_gather)

    if kernel:
        if spec.in_bytes >= 2 or not halo_overlap:
            # One launch over the fully extended tile is the default, as
            # there; 2- and 4-byte tiles never split.
            svb = dataclasses.replace(svb, b_int0=0, b_int1=0)
            slb = dataclasses.replace(slb, b_int0=0, b_int1=0)
        limbs = _int8_limbs_for(spec, svb, slb)
        route = "int8" if limbs is not None else "split"
        ext_r = svb.halo_lo + svb.strip + svb.halo_hi
        ext_l = slb.halo_lo + slb.strip_lanes + slb.halo_hi

        def make(vidx, rows, vrebase, hidx, lanes, hrebase, lanes_pad):
            # K1 reads a tile of the given rows and lanes; its windows
            # reach lanes_pad lanes, zeros past the tile.
            vop = _rank_vop(svb, i, vidx, rows, vrebase, limbs)
            lop = _rank_lop(slb, j, hidx, lanes_pad, route == "int8", hrebase)
            if route == "int8":
                ops = prepare_fused_int8(vop, lop, "vh", device, **spec.int8_kw)
            else:
                ops = prepare_fused_split(
                    vop, lop, "vh", mode_first, mode_second, device, **spec.split_kw
                )
            return dataclasses.replace(ops, lanes_in=lanes)

        nbv, nbh = svb.taps.shape[1], slb.n_blocks
        b0v, b1v, b0h, b1h = svb.b_int0, svb.b_int1, slb.b_int0, slb.b_int1
        split = spec.in_bytes == 1 and b1v > b0v and not (b0v == 0 and b1v == nbv)
        # Without H-interior blocks the first two parts are one, on xc:
        # the column halos go exposed, the row halos still overlap.
        split_h = split and b1h > b0h and not (b0h == 0 and b1h == nbh)
        if not split:
            b0v = b1v = 0
        if not split_h:
            b0h = b1h = 0
        v_int, h_int = np.arange(b0v, b1v), np.arange(b0h, b1h)
        v_bnd, h_bnd = np.r_[0:b0v, b1v:nbv], np.r_[0:b0h, b1h:nbh]
        h_all = np.arange(nbh)
        a = b = None
        if split_h:
            a = make(v_int, svb.strip, svb.halo_lo, h_int, slb.strip_lanes, slb.halo_lo,
                     slb.strip_lanes)
            b = make(v_int, svb.strip, svb.halo_lo, h_bnd, ext_l, 0, slb.lanes_pad)
        elif split:
            b = make(v_int, svb.strip, svb.halo_lo, h_all, ext_l, 0, slb.lanes_pad)
        cpart = make(v_bnd, ext_r, 0, h_all, ext_l, 0, slb.lanes_pad) if len(v_bnd) else None
        tile_body = Tile(a, b, cpart, b0v, svb.tile, b0h, slb.tile * c, m_h, m_w * c)
        sv, sl = svb, slb

        def tiles_of(xb: torch.Tensor) -> torch.Tensor:
            # Column halos on the raw tile along cp, then row halos on the
            # column-extended tile along sp; the interior launch goes
            # before either wait.
            pend_c = exchange_col_halos(xb, slb, mesh.cp_group, async_op=True)
            local = [tile_body.local(f) for f in xb]
            c_lo, c_hi = pend_c.wait()
            xc = _cat_lanes([c_lo, xb, c_hi])
            pend_r = exchange_halos(xc, svb, mesh.sp_group, async_op=True)
            mid = [tile_body.middle(f, local[k]) for k, f in enumerate(xc)]
            r_lo, r_hi = pend_r.wait()
            ext = _cat_rows([r_lo, xc, r_hi])
            return _stack([tile_body.finish(e, mid[k]) for k, e in enumerate(ext)])
    else:
        # The library body: pack and gamma on the local tile, the H pass
        # on the float32 transposed tile after its column halos, the row
        # halos on the H-resized tile, the V pass, gamma-out, the dither.
        route, tile_body, sv, sl = "library", None, svv, svh
        h_pass = _library_pass(svh, j, mesh.cp_group, mode_first, device)
        v_pass = _library_pass(svv, i, mesh.sp_group, mode_second, device)
        hs, ws = padded_h // r, padded_w // s

        def tiles_of(xb: torch.Tensor) -> torch.Tensor:
            nb = xb.shape[0]
            xf = spec.pre(xb.reshape(nb * hs, ws * c))
            xt = xf.reshape(nb, hs, ws, c).transpose(1, 2).reshape(nb, ws, hs * c)
            y = h_pass(xt)  # [B, m_w, hs*c]
            y = y.reshape(nb, m_w, hs, c).transpose(1, 2).reshape(nb, hs, m_w * c)
            return _stack([spec.post(z) for z in v_pass(y)])

    body = tiles_of
    if spec.errdiff:
        # The pre-dither float32 tiles, gathered over cp then sp -> K4 on
        # the whole image on every rank -> each rank keeps its tile.
        def body(xb: torch.Tensor) -> torch.Tensor:
            return _errdiff_tiles(
                spec, tiles_of(xb),
                lambda z: all_gather_tiles(z, mesh.cp_group, mesh.sp_group),
                r * m_h, s * m_w * c,
                (slice(i * m_h, (i + 1) * m_h), slice(j * m_w * c, (j + 1) * m_w * c)),
            )

    run = _runner(body, (padded_h // r, (padded_w // s) * c), device, "tile")
    run.route = route
    run.svop = sv
    run.slb = sl
    run.tile = tile_body
    return run


def make_sharded_avir_executor_2d(
    plan,
    mesh,
    precision: str = "auto",
    tile: int = 64,
    dither: str = "default",
    engine: str = "auto",
    pallas_tile: int | None = None,
    halo_overlap: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's executor of a ResizePlan on a 2-D (rows x cols) mesh
    (a ``multihost.DpSpCpMesh``; ``make_sharded_avir_executor_2d`` there,
    whose ``Mesh`` and axis names it replaces).  Row strips alone leave
    every block touching a halo once strips shrink to the V window
    ("interior extinction"); tiles keep both extents fat at the same
    rank count.

    Call it on every rank at once with the rank's tile of the padded image
    (``pad_rows`` over sp, ``pad_cols`` over cp, ``local_tile``): [hs,
    ws*C], or [B_local, hs, ws*C] with frames on dp, on ``mesh.device``.
    It returns the rank's tile of the output [m_h, m_w*C] (or [B_local,
    m_h, m_w*C]); ``assemble_2d`` gathers the image.

    The kernel route (``engine`` "auto" or "pallas", the rule of the 1-D
    maker): column halos go on the raw tile along cp, row halos on the
    column-extended raw tile along sp, and the single card's K1
    (``order="vh"``) runs on the doubly extended tile with the rank's own
    V and lane operators (``shard_v_blocked``, ``shard_lane_blocked``):
    one launch a frame, or with ``halo_overlap`` on a 1-byte tile three,
    the V-interior x H-interior launch enqueued before either exchange is
    waited for.  The library route (``precision="exact"``, an axis whose
    halo exceeds its strip, LANCIR float output) exchanges the column
    halos on the float32 transposed tile, runs the H pass, exchanges the
    row halos on the H-resized tile and runs the V pass (``torch.bmm``),
    all-gathering an axis whose halos do not fit.  ``dither``: as the 1-D
    maker, the pre-dither tiles gathered over cp then sp.

    The function carries ``run.route`` ("int8", "split" or "library"),
    ``run.svop`` (the rows' ``ShardedVOp``), ``run.slb`` (the columns'
    ``ShardedLaneOp`` on the kernel route, the transposed H pass's
    ``ShardedVOp`` on the library route) and ``run.tile`` (the pure
    ``Tile`` of the kernel route, else None)."""
    _check(engine, dither)
    return _build_2d(_avir_spec(plan, precision, dither), mesh, tile, pallas_tile, halo_overlap)


def make_sharded_lancir_executor_2d(
    plan,
    mesh,
    precision: str = "auto",
    tile: int = 64,
    engine: str = "auto",
    pallas_tile: int | None = None,
    halo_overlap: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's executor of a LancirPlan on a 2-D mesh (the scheme and
    call contract of ``make_sharded_avir_executor_2d``) with LANCIR's
    ``out_mul`` and round-half-even output stage; float output and
    ``precision="exact"`` take the library route."""
    _check(engine)
    return _build_2d(_lancir_spec(plan, precision), mesh, tile, pallas_tile, halo_overlap)


def assemble_2d(mesh, y: torch.Tensor, new_h: int, new_wc: int) -> torch.Tensor:
    """The whole output from every rank's tile ``y`` on a 2-D mesh
    (collective: every rank calls it): [new_h, new_w*C], or with frames
    [B, new_h, new_w*C] in dp order (``_slice_padded_out`` with
    ``cols_axis`` there)."""
    full = all_gather_tiles(y, mesh.cp_group, mesh.sp_group)[..., :new_h, :new_wc]
    return _frames(mesh, full.contiguous())
