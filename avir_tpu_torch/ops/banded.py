"""Blocked form of banded scanline operators.

The planner (plan/compose.py) collapses each axis's filtering chain into a
single banded operator ``out[i] = sum_j taps[i, j] * src[starts[i] + j]``.
This module lowers that operator to blocks: the output axis is tiled into
blocks of ``tile`` rows; each block reads one contiguous input window of
``win`` rows (window starts are plan-time constants), so the pass is one
batched dense product

    out[b] = A[b] @ x[offs[b] : offs[b] + win]      # [tile,win] @ [win,R]

The blocked operator carries the tap block in three forms:

  - float32 ``taps``;
  - the error-free bf16 split ``taps_hi + taps_lo`` (torch.bfloat16,
    bit-identical to the JAX package's host ml_dtypes split);
  - the radix-128 two-limb s8 fixed point ``taps_q1``/``taps_q0``
    (ops/intq.py), which the fused int8 kernel (ops/cuda/fused_kernel.py)
    consumes.

The tiles (``pick_tile``) are the JAX package's, so both packages build
identical operators from one plan; the CUDA kernels re-tile each block
for the card on their own.

``apply_blocked`` runs the pass as batched products: in "exact" mode
the float32 taps in full float32 (the ``precision="exact"`` route, which
has no kernel of its own), in the split modes the bf16 hi/lo taps (the
plain version of the row-pass kernel K2, ops/cuda/banded_kernel.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..plan.compose import BandedOp
from .intq import first_pass_overflow_safe, quantize_limbs


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_tile(op: BandedOp, in_bytes: int = 1) -> int:
    """Output tile size of the blocked form, as the JAX package picks it
    (ops/banded.py:pick_tile there).

    Cost model per input column: tap MACs = n_blocks * tile * win (win
    ~= tile * k + width) plus the window-fetch bytes weighted at 120
    MACs per byte.  Upsizes take a wide tile (256 rows for 1-byte input,
    128 for 2/4-byte input).
    """
    n_out = op.n_out
    if n_out <= 64:
        return _round_up(max(n_out, 8), 8)
    k = (op.starts[-1] - op.starts[0]) / max(n_out - 1, 1)
    if k < 1.0 and n_out >= 512:
        return 256 if in_bytes <= 1 else 128
    best, best_cost = 64, None
    for tile in (64, 128, 256, 512):
        win = _round_up(int(math.ceil(tile * k)) + op.width + 8, 128)
        blocks = -(-n_out // tile)
        cost = blocks * win * (tile + 120 * 2)
        if best_cost is None or cost < best_cost * 0.98:
            best, best_cost = tile, cost
    return best


@dataclasses.dataclass(frozen=True)
class BlockedBandedOp:
    """Plan-time constant blocked form of a BandedOp (host arrays)."""

    n_in: int
    n_out: int
    n_in_pad: int  # input rows after zero-pad (>= offs.max() + win)
    tile: int
    win: int
    offs: np.ndarray           # int32 [n_blocks] -- input window starts
    taps: np.ndarray           # f32 [n_blocks, tile, win]
    taps_hi: torch.Tensor      # bf16 -- round(taps)
    taps_lo: torch.Tensor      # bf16 -- round(taps - taps_hi)
    # int8 fixed-point limbs (ops/intq.py); None for 2/4-byte inputs.
    taps_q1: np.ndarray | None = None  # s8 [n_blocks, tile, win]
    taps_q0: np.ndarray | None = None  # s8
    q_shift: int = 0
    l1_max: float = 0.0  # max_i sum_j |taps[i, j]| -- output magnitude
    # Max per-output abs limb sums along the contraction.
    q_abs1: int = 0
    q_abs0: int = 0
    # Rows of zero padding above the input (uniform blocking only):
    # offsets and taps are in the padded coordinates, so the input is
    # read pad_top rows lower.
    pad_top: int = 0

    @property
    def n_blocks(self) -> int:
        return self.offs.shape[0]


def bf16_split(dense: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) error-free bf16 split: hi = bf16(x); lo = bf16(x - f32(hi)),
    round-to-nearest-even both ways (the JAX package's _bf16_split_np)."""
    x = torch.from_numpy(np.ascontiguousarray(dense, dtype=np.float32))
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _uniform_offsets(
    starts: np.ndarray, n_out: int, n_in: int, width: int, tile: int
) -> tuple[np.ndarray, int, int, int]:
    """(offs, win, n_in_pad, pad_top) of the uniform blocking: a constant
    window stride delta, a multiple of 32, from a base rounded down to 32;
    a negative base becomes ``pad_top`` rows of zero padding, and offsets
    are in the padded coordinates (``block_banded(uniform=True)`` there)."""
    n_blocks = -(-n_out // tile)
    if n_blocks < 2:
        raise ValueError("uniform blocking needs >= 2 blocks")
    lo_starts = starts[np.arange(n_blocks) * tile]
    # Interior strides of a constant-k plan are exactly tile*k; the first
    # and last may differ (edge clamping in op.starts).
    deltas = np.diff(lo_starts[1:-1])
    if len(deltas) and not (deltas == deltas[0]).all():
        raise ValueError("non-uniform stride")
    delta = int(deltas[0]) if len(deltas) else int(np.diff(lo_starts).max())
    if delta <= 0 or delta % 32:
        raise ValueError("stride not a positive multiple of 32")
    # offs[b] starts at or before each block's first tap row.
    off0 = int((lo_starts - delta * np.arange(n_blocks)).min()) // 32 * 32
    pad_top = max(0, -off0)
    offs = off0 + pad_top + delta * np.arange(n_blocks)
    ends = starts[np.minimum(np.arange(1, n_blocks + 1) * tile, n_out) - 1]
    win = _round_up(int((ends + pad_top + width - offs).max()), 128)
    n_in_pad = max(n_in + pad_top, int(offs.max()) + win)
    return offs, win, n_in_pad, pad_top


def block_banded(
    op: BandedOp, tile: int | None = None, in_bytes: int = 1,
    uniform: bool = False,
) -> BlockedBandedOp:
    """Lower a BandedOp to its blocked dense form (window starts aligned
    to 32 rows, windows rounded up to 128 rows, as in the JAX package).

    ``uniform=True`` forces a constant window stride (the shift-ring
    kernel's operator, ops/cuda/fused_ring.py): the boundary blocks, whose
    windows the default mode clamps into the input, are covered by
    ``pad_top`` rows of zero padding at the top (and more at the bottom
    through ``n_in_pad``).  Raises ValueError for under 2 blocks or a
    stride that is not constant or not a positive multiple of 32."""
    if tile is None:
        tile = pick_tile(op, in_bytes=in_bytes)
    n_out, width = op.n_out, op.width
    n_blocks = -(-n_out // tile)
    starts = op.starts.astype(np.int64)

    pad_top = 0
    if uniform:
        offs, win, n_in_pad, pad_top = _uniform_offsets(
            starts, n_out, op.n_in, width, tile
        )
        starts = starts + pad_top
    else:
        offs = np.empty(n_blocks, dtype=np.int64)
        spans = np.empty(n_blocks, dtype=np.int64)
        for b in range(n_blocks):
            lo = b * tile
            hi = min(lo + tile, n_out)
            offs[b] = (starts[lo] // 32) * 32
            spans[b] = starts[hi - 1] + width - offs[b]
        win = _round_up(int(spans.max()), 128)

        # Pull overrunning tail windows left (32-aligned) so offs+win fits
        # inside the input, when the widened spans still fit in win.
        max_off = (op.n_in - win) // 32 * 32
        if max_off >= 0 and int(
            (spans + np.maximum(offs - max_off, 0)).max()
        ) <= win:
            offs -= np.maximum(offs - max_off, 0)
            n_in_pad = op.n_in
        else:
            n_in_pad = max(op.n_in, int(offs.max()) + win)

    dense = np.zeros((n_blocks, tile, win), dtype=np.float32)
    rows = np.arange(n_out)
    b_of = rows // tile
    r_of = rows % tile
    col0 = starts - offs[b_of]
    for j in range(width):
        dense[b_of, r_of, col0 + j] = op.taps[:, j]

    taps_hi, taps_lo = bf16_split(dense)

    # int8 limb taps exist for u8 pipelines only.
    q1 = q0 = None
    q_shift = 0
    if in_bytes <= 1:
        q1, q0, q_shift = quantize_limbs(dense)
        if not first_pass_overflow_safe(q1, q0, contract_axis=2):
            q1 = q0 = None  # pragma: no cover - pathological taps
    return BlockedBandedOp(
        n_in=op.n_in,
        n_out=n_out,
        n_in_pad=n_in_pad,
        tile=tile,
        win=win,
        offs=offs.astype(np.int32),
        taps=dense,
        taps_hi=taps_hi,
        taps_lo=taps_lo,
        taps_q1=q1,
        taps_q0=q0,
        q_shift=q_shift,
        l1_max=float(np.abs(dense).sum(axis=2).max()),
        q_abs1=0 if q1 is None else int(
            np.abs(q1.astype(np.int64)).sum(axis=2).max()
        ),
        q_abs0=0 if q0 is None else int(
            np.abs(q0.astype(np.int64)).sum(axis=2).max()
        ),
        pad_top=pad_top,
    )


def assert_full_f32() -> None:
    """Raise unless float32 matrix products on the card run in full
    float32 (TF32 keeps about three decimal digits)."""
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "float32 matmul must run in full float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )


BLOCKED_MODES = ("exact", "split2", "split3")


def apply_blocked(
    bop: BlockedBandedOp,
    x: torch.Tensor,
    mode: str = "exact",
    taps=None,
) -> torch.Tensor:
    """Apply the operator along axis 0 of ``x`` ([n_in, R] -> float32
    [n_out, R]; u8/u16 input goes through int32 to float32): the JAX
    package's ``apply_blocked``, as batched products of the tap blocks
    with the gathered input windows.

    ``mode``: "exact" (the float32 taps, full float32: Precision.HIGHEST
    there), "split2" (bf16 hi/lo taps against bf16(x): for inputs exact
    in bf16) or "split3" (adds taps_hi against the input residual
    bf16(x - f32(bf16(x))), rounded to nearest even).  Each split product
    is bf16 x bf16, exact in float32, summed in float32.  ``taps``: the
    operator's taps already on ``x``'s device (the float32 ``bop.taps``
    for "exact", the pair (taps_hi, taps_lo) otherwise); moved per call
    when None."""
    if mode not in BLOCKED_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if x.device.type == "cuda":
        assert_full_f32()
    if x.dtype in (torch.uint8, torch.uint16):
        x = x.to(torch.int32)
    x = x.float()
    if bop.pad_top or bop.n_in_pad > x.shape[0]:
        x = torch.nn.functional.pad(
            x, (0, 0, bop.pad_top, bop.n_in_pad - bop.pad_top - x.shape[0])
        )
    idx = torch.from_numpy(
        bop.offs.astype(np.int64)[:, None] + np.arange(bop.win)[None, :]
    ).to(x.device)
    xw = x[idx]  # [n_blocks, win, R]
    if mode == "exact":
        if taps is None:
            taps = torch.from_numpy(bop.taps).to(x.device)
        y = torch.bmm(taps, xw)  # [n_blocks, tile, R]
    else:
        hi, lo = (
            (bop.taps_hi.to(x.device), bop.taps_lo.to(x.device))
            if taps is None else taps
        )
        hi, lo = hi.float(), lo.float()
        xh = xw.to(torch.bfloat16).float()
        y = torch.bmm(hi, xh) + torch.bmm(lo, xh)
        if mode == "split3":
            y = y + torch.bmm(hi, (xw - xh).to(torch.bfloat16).float())
    return y.reshape(bop.n_blocks * bop.tile, -1)[: bop.n_out]
