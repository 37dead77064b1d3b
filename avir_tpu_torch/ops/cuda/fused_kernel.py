"""K1 in int8 mode: the fused two-pass resize, its wrapper and its plain
PyTorch version; and K1's epilogue options, shared with the split modes.

Counterpart of the JAX package's ``ops/pallas/fused_kernel.py``
(``apply_fused_pallas`` -> ``_kernel`` -> ``_int8_passes`` -> ``_finish``,
int8 mode).  The kernel (``csrc/fused_int8.cu``) does the whole separable
resize of a u8 image in one launch from the radix-128 two-limb s8 taps of
a blocked V operator (ops/banded.py) and a lane operator (ops/lanes.py),
keeping the 15-bit intermediate on chip.  ``Epilogue`` selects its output
stage: the biased or round-half-even rounding, LANCIR's ``scale``, and
sRGB gamma, which linearizes the u8 input to 13-bit linear light as two
s8 limbs (three limb products in the first pass instead of two, and no
-128 shift) and converts the result back to sRGB before rounding.  The
kernel linearizes the image itself, from a shared table of every u8
value; with ``gamma_pre`` (``x_lo`` there) it reads those limbs from the
two s8 planes that the prologue kernel K5 wrote
(ops/cuda/gamma_prologue.py) in place of the u8 image.  Every input runs
on the s8 tensor cores, in one kernel per pass order.

``prepare_fused_int8`` turns the two operators into device tensors once
per executor: the chunked lane taps (the unchunked form becomes
``ceil(TC/128)`` chunks at offset 0 over the whole window), the same taps
packed four-along-the-contraction for the vh kernel (and K6) or
transposed for the hv kernel, the row/column sums that undo the input's
-128 shift (unused with gamma), each 32-row slice's range of nonzero V
taps (read by the hv kernel's second pass and by K6), the slice height
``slice_rows`` picks, its slices' ranges and each chunk's range of
nonzero lane taps.

``apply_fused_int8`` launches the kernel on a CUDA tensor and runs
``apply_fused_int8_reference`` on a CPU tensor.  The reference does the
same integer arithmetic with float64 products of the limb tensors
(exact: every sum stays below 2^31), then the same float32
recombination, so kernel and reference agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ...utils import trace
from ..banded import BlockedBandedOp
from ..gamma import (
    GAMMA_IN_BITS,
    _int8_limbs,
    _linear_to_srgb,
    f32,
    fma32,
    gamma_q13_table,
)
from ..lanes import LaneBlockedOp
from .launch import F, I, P, Entry, on_cpu

ROUND_MODES = ("biased", "even")


def _variants(prefix: str) -> dict[str, int]:
    return {
        f"{prefix}_{order}{g}{e}": 0
        for order in ("vh", "hv") for g in ("", "_gamma") for e in ("", "_even")
    }


# Launches of each kernel variant of this module, counted by the wrapper:
# fused_int8_{vh,hv}[_gamma][_even] (see Epilogue.suffix), and the
# limb-plane input variants fused_int8_{vh,hv}_gamma[_even]_pre.
launches = {
    **_variants("fused_int8"),
    **{
        f"fused_int8_{order}_gamma{e}_pre": 0
        for order in ("vh", "hv") for e in ("", "_even")
    },
}
# hv launches by pipeline form (FusedInt8Operands.hv_form): "runs" where
# some thread block walks more than one tile, "one_tile" where each block
# takes one.
hv_forms = {"runs": 0, "one_tile": 0}

_ROWS = 32    # output rows per thread block (csrc: kRows)
_LANES = 128  # output lanes per thread block (csrc: kLanes)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """K1's output stage (``_kernel``'s gamma stages and ``_finish``
    there; ``k1::Epilogue`` in csrc/k1_common.cuh).

    ``scale`` multiplies integer outputs before rounding (LANCIR's
    ``out_mul``; float32 output is written unscaled, as there);
    ``round_mode`` is "biased" (floor(v + 0.5), the AVIR ditherer) or
    "even" (round half to even, LANCIR).  ``gamma`` linearizes the input
    (``x * in_gamma_mult`` first) and converts the result back to sRGB
    (then ``* out_gamma_mult`` when that is not 0); with C = 4 and
    ``alpha_index`` 0 or 3 that lane is only scaled."""

    scale: float = 1.0
    round_mode: str = "biased"
    gamma: bool = False
    c: int = 1
    alpha_index: int = -1
    in_gamma_mult: float = 1.0
    out_gamma_mult: float = 1.0

    def __post_init__(self):
        if self.round_mode not in ROUND_MODES:
            raise ValueError(f"unknown round_mode {self.round_mode!r}")

    @property
    def alpha_lane(self) -> int:
        """The kernels' alpha lane (lane % 4), or -1 for none."""
        if self.gamma and self.c == 4 and self.alpha_index in (0, 3):
            return self.alpha_index
        return -1

    @property
    def suffix(self) -> str:
        """Launch-count key suffix of the kernel variant."""
        return ("_gamma" if self.gamma else "") + (
            "_even" if self.even else ""
        )

    @property
    def even(self) -> bool:
        """Round half to even (LANCIR) in place of the biased rounding."""
        return self.round_mode == "even"


# The epilogue's parameters in the kernels' C entry points, packed from
# Epilogue's attributes of those names (launch.Entry.pack).
EPILOGUE_PARAMS = (
    ("gamma", I), ("alpha_lane", I), ("in_gamma_mult", F), ("out_gamma_mult", F),
    ("scale", F), ("even", I),
)


def finish_reference(
    acc: torch.Tensor,
    epi: Epilogue,
    out_dtype: torch.dtype = torch.uint8,
    out_max: float = 255.0,
    trunc_bits: int = 0,
    tm: float = 1.0,
    curve: bool = True,
) -> torch.Tensor:
    """K1's epilogue on the float32 image [rows_out, lanes_out] (plain
    version of ``k1::finish_float`` / ``k1::finish_int``): gamma-out,
    then for integer output the scale, the rounding and the clamp.  The
    last multiply before a biased rounding fuses with its + 0.5, as the
    reference's compiled kernel does (ops/gamma.py).  ``curve=False``:
    the image is an alpha plane, which skips the sRGB curve but not
    ``out_gamma_mult`` (the planar kernels' bypass)."""
    mul = None
    if epi.gamma:
        if curve:
            acc = _linear_to_srgb(acc, epi.c, epi.alpha_index)
        if epi.out_gamma_mult != 0.0:
            mul = f32(epi.out_gamma_mult)
    if out_dtype == torch.float32:
        return acc if mul is None else acc * mul
    if epi.scale != 1.0:
        if mul is not None:
            acc = acc * mul
        mul = f32(epi.scale)
    if trunc_bits > 0:
        if mul is not None:
            acc = acc * mul
        tmt = torch.tensor(tm, dtype=torch.float32, device=acc.device)
        acc = torch.floor(acc / tmt + 0.5) * tmt
    elif epi.round_mode == "even":
        acc = torch.round(acc if mul is None else acc * mul)
    else:
        acc = torch.floor(acc + 0.5 if mul is None else fma32(acc, mul, 0.5))
    acc = torch.clamp(acc, 0.0, out_max)
    return acc.to(torch.int32).to(out_dtype)


def _int8_x_shift(
    first_l1_max: float, first_bits: int, in_max: float = 255.0
) -> int:
    """Inter-pass 15-bit quantization scale: the high limb (x15+64)>>7
    must fit s8 for |y| <= in_max * l1_max of the first pass (in_max is
    the input's value range: 255 raw, 1.0 linear light), and the
    re-quantizing right shift (first_bits - x_shift) must be positive.
    first_bits is the first pass's total fixed-point scale (q_shift, plus
    GAMMA_IN_BITS when the input is quantized linear light)."""
    if first_l1_max <= 0.0:
        return 0
    x_shift = int(math.floor(math.log2(16319.0 / (in_max * first_l1_max))))
    return min(x_shift, first_bits - 1)


def int8_feasible(
    vop: BlockedBandedOp,
    lop: LaneBlockedOp,
    order: str = "vh",
    gamma: bool = False,
) -> bool:
    """Limb taps exist, the 15-bit intermediate scale is positive and,
    with gamma, the first pass's limb sums fit s32."""
    if vop.taps_q1 is None or lop.taps_q1 is None:
        return False
    if vop.q_shift <= 0 or lop.q_shift <= 0:
        return False
    first, first_shift = (
        (vop, vop.q_shift) if order == "vh" else (lop, lop.q_shift)
    )
    if gamma:
        # The gamma first pass recombines limb products with << 14:
        # |xq limbs| <= 64, so the s32 bound is exact from the taps'
        # per-output abs limb sums.
        bound = (
            (64 * first.q_abs1 << 14)
            + (64 * (first.q_abs1 + first.q_abs0) << 7)
            + (1 << 26)
        )
        if bound >= 2**31:
            return False
    first_bits = first_shift + (GAMMA_IN_BITS if gamma else 0)
    in_max = 1.0 if gamma else 255.0
    return _int8_x_shift(first.l1_max, first_bits, in_max=in_max) >= 1


@dataclasses.dataclass(frozen=True)
class FusedInt8Operands:
    """Device-resident operands of one fused int8 resize."""

    order: str            # "vh" (V pass first) or "hv"
    rows_in: int          # input image [rows_in, lanes_in] u8
    lanes_in: int
    rows_out: int         # output image [rows_out, lanes_out] u8
    lanes_out: int
    rows_pad: int         # zero-padded extent the windows reach
    lanes_pad: int
    tc: int               # output lanes per lane block
    sh: int               # first-pass requantizing shift
    out_exp: int          # recombination scale 2^out_exp
    epi: Epilogue
    offs_v_host: tuple[int, ...]
    offs_v: torch.Tensor   # int32 [Bv]
    v1: torch.Tensor       # int8 [Bv, Tv, Wv]
    v0: torch.Tensor
    v_comp: torch.Tensor   # int32 [Bv, Tv]: 128 * (128*rowsum(v1) + rowsum(v0))
                           # (no gamma)
    offs_l: torch.Tensor   # int32 [Bh]
    rel: torch.Tensor      # int32 [n_ch]
    h1: torch.Tensor       # int8 [Bh, n_ch, win_c, 128]
    h0: torch.Tensor
    h1p: torch.Tensor | None  # int32 [Bh, n_ch, win_c/4, 128], 4 taps per word
    h0p: torch.Tensor | None  # (vh)
    h_comp: torch.Tensor   # int32 [Bh, n_ch, 128]: 128*128*colsum(h1) + 128*colsum(h0)
                           # (no gamma)
    k_range: torch.Tensor  # int32 [Bv, n_slices, 2] nonzero V-tap rows, 32-row slices
    # The tiling: output rows per thread block (slice_rows), that slice's
    # nonzero V-tap rows, each chunk's nonzero lane-tap rows, the hv
    # kernel's intermediate's rows, and the largest power of two (up to 16)
    # dividing every chunk's first window lane.
    rows: int
    slice_range: torch.Tensor  # int32 [Bv, n_slices_r, 2]; k_range itself at 32 rows
    h_range: torch.Tensor      # int32 [Bh, n_ch, 2]
    kwin: int
    lane_align: int
    # The input is K5's two s8 limb planes of the linearized image
    # (ops/cuda/gamma_prologue.py), not the u8 image (gamma only).
    gamma_pre: bool = False
    # The hv kernel's lane taps as [Bh, n_ch, 128, win_c].
    h1t: torch.Tensor | None = None
    h0t: torch.Tensor | None = None
    # The hv kernel's runs (hv_runs): thread block b walks tiles runs[b]
    # .. runs[b + 1] - 1 of the chunk-major order (vh: None).
    runs: torch.Tensor | None = None  # int32 [blocks + 1]

    @property
    def device(self) -> torch.device:
        return self.v1.device

    @property
    def launch_key(self) -> str:
        pre = "_pre" if self.gamma_pre else ""
        return f"fused_int8_{self.order}{self.epi.suffix}{pre}"

    @property
    def n_tiles(self) -> int:
        """The kernel's tiles: lane chunks x slices."""
        return self.h_range.shape[0] * self.h_range.shape[1] * self.slice_range.shape[0] \
            * self.slice_range.shape[1]

    @property
    def blocks(self) -> int:
        """The hv launch's thread blocks (vh: 0)."""
        return 0 if self.runs is None else self.runs.numel() - 1

    @property
    def hv_form(self) -> str | None:
        """The hv launch's pipeline form (hv_forms' key): "runs" where a
        block walks more than one tile, "one_tile" where each takes one;
        None for vh."""
        if self.order != "hv":
            return None
        return "runs" if self.blocks < self.n_tiles else "one_tile"

    @functools.cached_property
    def packed(self) -> tuple:
        """The kernel's arguments fixed for these operands (LAUNCH.pack)."""
        bv, tv, wv = self.v1.shape
        bh, n_ch, win_c, _ = self.h1.shape
        n_slices_r = self.slice_range.shape[1]
        if self.order == "vh" and bv * n_slices_r > 65535:
            raise ValueError("too many output row blocks for one launch")
        return LAUNCH.pack(
            self, self.epi, hv=int(self.order == "hv"), bv=bv, tv=tv, wv=wv, bh=bh,
            n_ch=n_ch, win_c=win_c, n_slices=self.k_range.shape[1], n_slices_r=n_slices_r,
            rec=2.0 ** self.out_exp,
        )


def _chunked_lane_taps(lop: LaneBlockedOp):
    """(h1, h0, rel, win_c): the lane limbs as [Bh, n_ch, win_c, 128]."""
    if lop.ctaps_q1 is not None:
        return lop.ctaps_q1, lop.ctaps_q0, lop.chunk_rel, lop.win_c
    bh, wc, tc = lop.taps_q1.shape
    n_ch = -(-tc // _LANES)
    pad = ((0, 0), (0, 0), (0, n_ch * _LANES - tc))

    def chunk(q):
        q = np.pad(q, pad).reshape(bh, wc, n_ch, _LANES)
        return np.ascontiguousarray(q.transpose(0, 2, 1, 3))

    return chunk(lop.taps_q1), chunk(lop.taps_q0), (0,) * n_ch, wc


def _pack4(q: np.ndarray) -> np.ndarray:
    """[..., K, 128] s8 -> [..., K/4, 128] int32 whose byte i holds
    q[..., 4*k4 + i, :] (little-endian)."""
    *lead, k, n = q.shape
    q = q.reshape(*lead, k // 4, 4, n).swapaxes(-1, -2)
    return np.ascontiguousarray(q).view(np.int32)[..., 0]


def _k_ranges(v1: np.ndarray, v0: np.ndarray, rows: int = _ROWS) -> np.ndarray:
    """[Bv, n_slices, 2]: per ``rows``-row slice of each V block, the
    window rows [lo, hi) holding its nonzero taps, rounded out to 32."""
    bv, tv, wv = v1.shape
    n_sl = -(-tv // rows)
    nz = np.zeros((bv, n_sl * rows, wv), dtype=bool)
    nz[:, :tv] = (v1 != 0) | (v0 != 0)
    nz = nz.reshape(bv, n_sl, rows, wv).any(axis=2)
    any_nz = nz.any(axis=2)
    first = np.argmax(nz, axis=2)
    last = wv - 1 - np.argmax(nz[:, :, ::-1], axis=2)
    lo = first // 32 * 32
    hi = np.minimum(-(-(last + 1) // 32) * 32, wv)
    out = np.stack([lo, hi], axis=2)
    out[~any_nz] = 0
    return out.astype(np.int32)


def h_ranges(h1: np.ndarray, h0: np.ndarray) -> np.ndarray:
    """[Bh, n_ch, 2]: per chunk of lane taps [Bh, n_ch, win_c, 128], the
    window rows [lo, hi) holding its nonzero taps, rounded out to 32."""
    nz = ((h1 != 0) | (h0 != 0)).any(axis=3)  # [Bh, n_ch, win_c]
    win_c = nz.shape[2]
    first = np.argmax(nz, axis=2)
    last = win_c - 1 - np.argmax(nz[:, :, ::-1], axis=2)
    out = np.stack(
        [first // 32 * 32, np.minimum(-(-(last + 1) // 32) * 32, win_c)], axis=2
    )
    out[~nz.any(axis=2)] = 0
    return out.astype(np.int32)


# The hv kernel's intermediate holds at most this many window rows; a
# taller slice range runs in windows of it, at 32-row slices.
KWIN_MAX = 256
# Shared memory of one H100 SM (228 KB; a card's own comes from
# _sm_smem) and what the runtime keeps of it for each resident block.
H100_SM_SMEM = 233_472
BLOCK_SMEM_RESERVED = 1_024


def two_blocks_smem(sm_smem: int) -> int:
    """The most shared memory a block may take for two blocks to share an
    SM of ``sm_smem`` bytes."""
    return sm_smem // 2 - BLOCK_SMEM_RESERVED


# Bytes of K1 int8's linearization table (csrc: kTableBytes, q13[2][256]
# int32) in the in-kernel gamma kernels' shared memory.
GAMMA_TABLE_BYTES = 2 * 256 * 4
# The vh kernel's ring of stages (csrc: VhMma<IN>::kStages), the same for
# every input mode.
VH_STAGES = 4


def vh_smem_bytes(planes: int = 1, table: bool = False) -> int:
    """Dynamic shared memory of the vh kernel for the input mode that
    ``planes`` and ``table`` name (1: the u8 image; 2: K5's limb planes;
    2 with ``table``: the in-kernel gamma).  VH_STAGES stages, each the
    larger of a first-pass step's V taps (2 x 32 x 80 bytes) and image
    tiles (64 x 128 bytes a plane read: two with the limb planes) and a
    second-pass step's lane-tap words (2 x 16 x 136 words); the computed
    step's B words (16 x 136 words a plane: two with gamma); the
    intermediate's limbs (2 x 32 x 144 bytes); with ``table`` the
    linearization table.  The layout is csrc/fused_int8.cu's VhMma; a
    change there changes this (the card test
    test_hv_smem_bytes_match_the_kernel holds the two equal)."""
    read = 1 if table else planes
    stage = max(2 * _ROWS * 80 + read * 64 * _LANES, 2 * 16 * 136 * 4)
    return (VH_STAGES * stage + planes * 16 * 136 * 4 + 2 * _ROWS * 144
            + (GAMMA_TABLE_BYTES if table else 0))


def hv_smem_bytes(kwin: int, planes: int = 1, table: bool = False) -> int:
    """Dynamic shared memory of the hv tensor-core kernel: lane taps 2 x
    128 x 144 bytes, ``planes`` planes of double-buffered image tiles of 32
    x 144 bytes (1: the u8 image; 2: K5's limb planes, or the in-kernel
    gamma's raw u8 tiles and its limb planes), the intermediate and the V
    taps 6 x 64 x (kwin + 16), and with ``table`` the in-kernel gamma's
    linearization table.  The layout is csrc/fused_int8.cu's
    hv_mma_smem_bytes; a change there changes this (the card test
    test_hv_smem_bytes_match_the_kernel holds the two equal)."""
    return (2 * _LANES * 144 + planes * 2 * 32 * 144 + 6 * 64 * (kwin + 16)
            + (GAMMA_TABLE_BYTES if table else 0))


def hv_blocks(n_tiles: int, kwin: int, sms: int, planes: int = 1, table: bool = False,
              sm_smem: int = H100_SM_SMEM) -> int:
    """Thread blocks of the hv kernel's launch over ``n_tiles`` tiles (lane
    chunks x R-row slices) on a card with ``sms`` SMs of ``sm_smem`` bytes
    of shared memory: one a tile where the tiles fit the card's resident
    blocks at once (two an SM where hv_smem_bytes at ``kwin`` lets two
    share one, else one), or on the CPU (``sms`` 0); else as many as stay
    resident, each walking a run of consecutive tiles (hv_runs), so that a
    window's first copies fly during the window before it."""
    per_sm = 2 if hv_smem_bytes(kwin, planes, table) <= two_blocks_smem(sm_smem) else 1
    resident = per_sm * sms
    return n_tiles if sms == 0 or n_tiles <= resident else resident


# Cycles of the hv kernel's parts (k1_phases.py --order hv at 1920x1080 ->
# 3840x2160 on an H100 80GB HBM3), hv_runs' estimate of a tile's cost: a
# window's start, a first-pass step, a second-pass sub-tile, and a
# sub-tile of a tile with no nonzero taps (its stores only).
HV_WINDOW_CYCLES, HV_STEP_CYCLES, HV_SUB_CYCLES, HV_EMPTY_SUB_CYCLES = 1500, 2600, 5200, 3400


def hv_runs(slice_range: np.ndarray, h_range: np.ndarray, kwin: int, rows: int,
            blocks: int) -> np.ndarray:
    """[blocks + 1] int32: thread block b of the hv kernel walks tiles
    runs[b] .. runs[b + 1] - 1 of the chunk-major order of (chunk, slice)
    pairs, cut where the tiles' estimated cycles reach equal shares of the
    whole (per window of kwin rows of a slice's nonzero V-tap range: its
    start, a step per 32 rows and 128-lane piece of the chunk's nonzero
    lane range, a sub-tile per 32 output rows), so that the blocks end
    together; one tile a block where ``blocks`` is the tiles."""
    kw = (slice_range[..., 1] - slice_range[..., 0]).astype(np.int64).reshape(1, -1)
    hw = (h_range[..., 1] - h_range[..., 0]).astype(np.int64).reshape(-1, 1)
    n_tiles = kw.size * hw.size
    if blocks >= n_tiles:
        return np.arange(n_tiles + 1, dtype=np.int32)
    work = (kw > 0) & (hw > 0)
    n_win = np.where(work, -(-kw // kwin), 1)
    steps = np.where(work, kw // 32 * -(-hw // 128), 0)
    sub = rows // 32 * np.where(work, HV_SUB_CYCLES, HV_EMPTY_SUB_CYCLES)
    cost = (np.where(work, n_win * HV_WINDOW_CYCLES, 0) + steps * HV_STEP_CYCLES
            + n_win * sub).reshape(-1)
    before = np.concatenate([[0], np.cumsum(cost)])  # cycles before each tile
    cuts = np.abs(before[None, :] - before[-1] * np.arange(1, blocks)[:, None] / blocks).argmin(1)
    return np.concatenate([[0], np.maximum.accumulate(cuts), [n_tiles]]).astype(np.int32)


def issued_macs(order: str, rows: int, slice_range: np.ndarray,
                k_range: np.ndarray, h_range: np.ndarray, first: int = 2) -> int:
    """s8 MACs the tensor-core kernel issues at slice height ``rows``:
    every block (an R-row slice with nonzero V taps x a chunk with nonzero
    lane taps) multiplies dense tap blocks over those ranges, ``first`` limb
    products in the first pass (2; 3 from K5's limb planes) and three in
    the second.  vh: the first pass R x slice rows x chunk lanes, the
    second R x chunk lanes x 128; hv: the first pass slice rows x 128 x
    chunk lanes, the second per 32-row sub-tile over its own 32-row range
    (``k_range``).  ``first`` is 3 with gamma (the limb planes, from K5 or
    linearized in the kernel).  A count for chip_smoke.py's report:
    slice_rows does not read it."""
    kw = (slice_range[..., 1] - slice_range[..., 0]).astype(np.int64)  # [Bv, S]
    hw = (h_range[..., 1] - h_range[..., 0]).astype(np.int64).ravel()
    active = kw > 0
    sum_hw, n_ch = int(hw.sum()), int((hw > 0).sum())
    if order == "vh":
        return first * rows * int(kw.sum()) * sum_hw + 3 * rows * int(active.sum()) * 128 * sum_hw
    k32 = (k_range[..., 1] - k_range[..., 0]).astype(np.int64)  # [Bv, S32]
    sub = rows // 32
    bv, s32 = k32.shape
    pad = -(-s32 // sub) * sub - s32
    k32 = np.pad(k32, ((0, 0), (0, pad))).reshape(bv, -1, sub)
    second = int((k32.sum(axis=2) * active).sum())
    return first * 128 * int(kw.sum()) * sum_hw + 3 * 32 * 128 * second * n_ch


def slice_rows(order: str, v1: np.ndarray, v0: np.ndarray, n_chunks: int,
               sms: int, planes: int = 1, sm_smem: int = H100_SM_SMEM,
               table: bool = False) -> int:
    """The tensor-core kernel's output rows per thread block.  vh: 32.  hv:
    the tallest of 128 and 64 rows (up to the V block's rows) whose grid of
    ``n_chunks`` lane chunks x slices keeps at least two thread blocks per
    SM of a card with ``sms`` SMs and whose slices' nonzero V-tap ranges fit
    the intermediate (KWIN_MAX rows), else 32.  A taller slice recomputes
    fewer window rows in the first pass; too few blocks leave SMs idle.
    With gamma (``planes`` 2: K5's two limb planes, or with ``table`` the
    in-kernel linearization's tiles and table) the height must also let two
    blocks share an SM's ``sm_smem`` bytes of shared memory (hv_smem_bytes
    within two_blocks_smem); without gamma the grid and the ranges decide,
    as measured at the main-path cells (PERF.md)."""
    if order == "vh":
        return _ROWS
    bv, tv, _ = v1.shape
    for rows in (128, 64):
        if rows <= -(-tv // 32) * 32 and n_chunks * bv * -(-tv // rows) >= 2 * sms:
            sr = _k_ranges(v1, v0, rows)
            span = int((sr[..., 1] - sr[..., 0]).max())
            if span <= KWIN_MAX and (
                planes == 1
                or hv_smem_bytes(max(32, span), planes, table) <= two_blocks_smem(sm_smem)
            ):
                return rows
    return _ROWS


def _sm_count(device: torch.device | str) -> int:
    """SMs of the card the operands live on; 0 on the CPU, whose plain
    version reads no tiling (so no block count limits the height)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sm_smem(device: torch.device | str) -> int:
    """Shared memory of one SM of the card the operands live on; an H100's
    on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SM_SMEM
    return torch.cuda.get_device_properties(device).shared_memory_per_multiprocessor


def _slice_fields(v1: np.ndarray, v0: np.ndarray, rows: int) -> tuple[np.ndarray, int]:
    """(slice_range, kwin) at ``rows``-row slices: the hv kernel's
    intermediate holds the tallest slice range, up to KWIN_MAX rows."""
    sr = _k_ranges(v1, v0, rows)
    return sr, max(32, min(KWIN_MAX, int((sr[..., 1] - sr[..., 0]).max())))


def _hv_runs(order: str, sr: np.ndarray, hr: np.ndarray, kwin: int, rows: int, device,
             gamma: bool, gamma_pre: bool) -> torch.Tensor | None:
    """hv_runs over hv_blocks' blocks, on ``device`` (vh: None)."""
    if order != "hv":
        return None
    blocks = hv_blocks(sr[..., 0].size * hr[..., 0].size, kwin, _sm_count(device),
                       planes=2 if gamma else 1, table=gamma and not gamma_pre,
                       sm_smem=_sm_smem(device))
    return torch.from_numpy(hv_runs(sr, hr, kwin, rows, blocks)).to(device)


def at_rows(ops: FusedInt8Operands, rows: int) -> FusedInt8Operands:
    """``ops`` of the hv tensor-core kernel with its slices set to ``rows``
    rows (32, 64 or 128) in place of slice_rows' choice: the same function,
    another tiling (for the card tests and chip_smoke.py, which hold every
    height to the plain version), with its launch's runs chosen anew.
    The vh kernel runs 32 rows only."""
    if rows not in ((_ROWS,) if ops.order == "vh" else (32, 64, 128)):
        raise ValueError(f"no {rows}-row slices in the {ops.launch_key} kernel")
    v1, v0 = ops.v1.cpu().numpy(), ops.v0.cpu().numpy()
    sr, kwin = _slice_fields(v1, v0, rows)
    if rows > 32 and (sr[..., 1] - sr[..., 0]).max() > KWIN_MAX:
        raise ValueError(f"{rows}-row slice ranges exceed {KWIN_MAX} rows")
    runs = _hv_runs(ops.order, sr, ops.h_range.cpu().numpy(), kwin, rows, ops.device,
                    ops.epi.gamma, ops.gamma_pre)
    slice_range = ops.k_range if rows == _ROWS else torch.from_numpy(sr).to(ops.device)
    return dataclasses.replace(ops, rows=rows, slice_range=slice_range, kwin=kwin, runs=runs)


def _lane_align(lop: LaneBlockedOp, rel) -> int:
    """The largest power of two up to 16 dividing every chunk's first
    window lane (offs_l + rel)."""
    starts = np.asarray(lop.offs_l, dtype=np.int64)[:, None] + np.asarray(rel, dtype=np.int64)
    align = 16
    while align > 1 and (starts % align).any():
        align //= 2
    return align


def prepare_fused_int8(
    vop: BlockedBandedOp,
    lop: LaneBlockedOp,
    order: str,
    device: torch.device | str,
    scale: float = 1.0,
    round_mode: str = "biased",
    gamma: bool = False,
    alpha_index: int = -1,
    in_gamma_mult: float = 1.0,
    out_gamma_mult: float = 1.0,
    gamma_pre: bool = False,
) -> FusedInt8Operands:
    """Operands of the fused int8 resize by ``vop`` (rows) and ``lop``
    (interleaved lanes) in pass order ``order``, on ``device``, with the
    epilogue options of ``Epilogue``.  ``gamma_pre``: the resize reads
    K5's limb planes (``apply_fused_int8(ops, hi, x_lo=lo)``)."""
    if order not in ("vh", "hv"):
        raise ValueError(f"unknown order {order!r}")
    if gamma_pre and not gamma:
        raise ValueError("limb-plane input is the int8 gamma route")
    if not int8_feasible(vop, lop, order, gamma):
        raise ValueError("int8 mode infeasible for these taps")
    if lop.out_idx is not None:
        raise ValueError("lane-subset operators are not supported")
    epi = Epilogue(
        scale=float(scale), round_mode=round_mode, gamma=bool(gamma),
        c=lop.c, alpha_index=int(alpha_index),
        in_gamma_mult=float(in_gamma_mult),
        out_gamma_mult=float(out_gamma_mult),
    )
    qv, qh = vop.q_shift, lop.q_shift
    first_shift, second_shift = (qv, qh) if order == "vh" else (qh, qv)
    first = vop if order == "vh" else lop
    first_bits = first_shift + (GAMMA_IN_BITS if gamma else 0)
    x_shift = _int8_x_shift(
        first.l1_max, first_bits, in_max=1.0 if gamma else 255.0
    )

    v1, v0 = vop.taps_q1, vop.taps_q0
    rs = v1.astype(np.int64).sum(axis=2) * 128 + v0.astype(np.int64).sum(axis=2)
    h1, h0, rel, win_c = _chunked_lane_taps(lop)
    cs = (
        h1.astype(np.int64).sum(axis=2) * 128
        + h0.astype(np.int64).sum(axis=2)
    )

    def dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype)

    # The lane taps packed for the vh kernel (and K6), or transposed for
    # the hv kernel.  With gamma the hv kernel stages two planes of image
    # tiles (K5's, or the raw u8 tiles and the limb planes it makes from
    # them beside its linearization table), which slice_rows sizes.
    h1p = h0p = h1t = h0t = None
    if order == "vh":
        h1p, h0p = dev(_pack4(h1)), dev(_pack4(h0))
    else:
        h1t, h0t = dev(np.swapaxes(h1, 2, 3)), dev(np.swapaxes(h0, 2, 3))
    hr = h_ranges(h1, h0)
    rows = slice_rows(order, v1, v0, hr.shape[0] * hr.shape[1], _sm_count(device),
                      planes=2 if gamma else 1, sm_smem=_sm_smem(device),
                      table=gamma and not gamma_pre)
    sr, kwin = _slice_fields(v1, v0, rows)
    runs = _hv_runs(order, sr, hr, kwin, rows, device, gamma, gamma_pre)
    k_range = dev(_k_ranges(v1, v0))

    return FusedInt8Operands(
        order=order,
        rows_in=vop.n_in,
        lanes_in=lop.n_in * lop.c,
        rows_out=vop.n_out,
        lanes_out=lop.n_out * lop.c,
        rows_pad=vop.n_in_pad,
        lanes_pad=lop.lanes_pad,
        tc=lop.tile * lop.c,
        sh=first_bits - x_shift,
        out_exp=-(x_shift + second_shift),
        epi=epi,
        offs_v_host=tuple(int(o) for o in vop.offs),
        offs_v=dev(vop.offs, torch.int32),
        v1=dev(v1),
        v0=dev(v0),
        v_comp=dev(rs * 128, torch.int32),
        offs_l=dev(lop.offs_l, torch.int32),
        rel=dev(np.asarray(rel), torch.int32),
        h1=dev(h1),
        h0=dev(h0),
        h1p=h1p,
        h0p=h0p,
        h_comp=dev(cs * 128, torch.int32),
        k_range=k_range,
        rows=rows,
        slice_range=k_range if rows == _ROWS else dev(sr),
        h_range=dev(hr),
        kwin=kwin,
        lane_align=_lane_align(lop, rel),
        gamma_pre=bool(gamma_pre),
        h1t=h1t,
        h0t=h0t,
        runs=runs,
    )


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _limbs(fq: torch.Tensor, sh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-integer float64 first-pass sums -> (x1, x0) float64 limbs of
    x15 = (fq + 2^(sh-1)) >> sh (arithmetic shifts)."""
    x15 = (fq.to(torch.int64) + (1 << (sh - 1))) >> sh
    x1 = (x15 + 64) >> 7
    return x1.to(torch.float64), (x15 - (x1 << 7)).to(torch.float64)


def _recombine(pa: torch.Tensor, pb: torch.Tensor, out_exp: int) -> torch.Tensor:
    """Float32 recombination of the second pass's limb sums."""
    acc = pa.to(torch.float32) * 16384.0 + pb.to(torch.float32) * 128.0
    return acc * (2.0 ** out_exp)


def apply_fused_int8_reference(
    ops: FusedInt8Operands, x: torch.Tensor, x_lo: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch fused int8 resize: u8 [rows_in, lanes_in] ->
    u8 [rows_out, lanes_out], on the device of ``x``; with
    ``ops.gamma_pre``, ``x`` and ``x_lo`` are K5's s8 limb planes."""
    dev = x.device
    epi = ops.epi
    v1, v0 = ops.v1.to(torch.float64), ops.v0.to(torch.float64)
    h1, h0 = ops.h1.to(torch.float64), ops.h0.to(torch.float64)
    bv, tv, wv = ops.v1.shape
    bh, n_ch, win_c, _ = ops.h1.shape
    lane_idx = (
        ops.offs_l.long()[:, None, None]
        + ops.rel.long()[None, :, None]
        + torch.arange(win_c, device=dev)
    )  # [Bh, n_ch, win_c]
    acc = torch.empty((bv, tv, bh, n_ch * _LANES), dtype=torch.float32, device=dev)

    # The windows may end before the image does (an operator that reads a
    # subset of the lanes or rows): what lies past the pad is never read.
    r, l = min(ops.rows_in, ops.rows_pad), min(ops.lanes_in, ops.lanes_pad)
    if ops.gamma_pre:
        # K5's planes already hold the two limbs, zero past the image.
        _check_planes(ops, x, x_lo)
        xq1, xq0 = (
            q[: ops.rows_pad, : ops.lanes_pad].to(torch.float64) for q in (x, x_lo)
        )
    elif epi.gamma:
        # 13-bit linear light as two limbs, read from the kernel's table of
        # every u8 value (row 1 on the alpha lane); padding reads 0 -> 0.
        xi = torch.zeros((ops.rows_pad, ops.lanes_pad), dtype=torch.long, device=dev)
        xi[:r, :l] = x[:r, :l]
        lane = torch.arange(ops.lanes_pad, device=dev)
        row = ((lane & 3) == epi.alpha_lane).long().expand_as(xi)
        xq = gamma_q13_table(epi.in_gamma_mult).to(dev)[row, xi]
        xq1, xq0 = (q.to(torch.float64) for q in _int8_limbs(xq))
    else:
        xs = torch.zeros((ops.rows_pad, ops.lanes_pad), dtype=torch.float64, device=dev)
        xs[:r, :l] = x[:r, :l]
        xs -= 128.0  # s8(x ^ 0x80) == x - 128; padding reads 0 -> -128

    if ops.order == "vh":
        v_comp = ops.v_comp.to(torch.float64)
        for b, o in enumerate(ops.offs_v_host):
            if epi.gamma:
                w1, w0 = xq1[o : o + wv], xq0[o : o + wv]
                fq = (v1[b] @ w1) * 16384.0 + (v1[b] @ w0 + v0[b] @ w1) * 128.0
            else:
                xw = xs[o : o + wv]
                fq = (v1[b] @ xw) * 128.0 + v0[b] @ xw + v_comp[b][:, None]
            x1, x0 = _limbs(fq, ops.sh)
            g1, g0 = x1[:, lane_idx], x0[:, lane_idx]  # [Tv, Bh, n_ch, win_c]
            pa = torch.einsum("tbjw,bjwc->tbjc", g1, h1)
            pb = torch.einsum("tbjw,bjwc->tbjc", g0, h1) + torch.einsum(
                "tbjw,bjwc->tbjc", g1, h0
            )
            acc[b] = _recombine(pa, pb, ops.out_exp).reshape(tv, bh, -1)
    else:
        h_comp = ops.h_comp.to(torch.float64)
        x1 = torch.empty((ops.rows_pad, bh, n_ch, _LANES), dtype=torch.float64, device=dev)
        x0 = torch.empty_like(x1)

        def rmul(x, h, j):  # chunk j of the lane contraction
            return torch.einsum("rbw,bwc->rbc", x[:, lane_idx[:, j]], h[:, j])

        for j in range(n_ch):
            if epi.gamma:
                fq = rmul(xq1, h1, j) * 16384.0 + (
                    rmul(xq0, h1, j) + rmul(xq1, h0, j)
                ) * 128.0
            else:
                fq = rmul(xs, h1, j) * 128.0 + rmul(xs, h0, j) + h_comp[:, j]
            x1[:, :, j], x0[:, :, j] = _limbs(fq, ops.sh)
        x1 = x1.reshape(ops.rows_pad, -1)
        x0 = x0.reshape(ops.rows_pad, -1)
        for b, o in enumerate(ops.offs_v_host):
            w1, w0 = x1[o : o + wv], x0[o : o + wv]
            pa = v1[b] @ w1
            pb = v1[b] @ w0 + v0[b] @ w1
            acc[b] = _recombine(pa, pb, ops.out_exp).reshape(tv, bh, -1)

    acc = acc[:, :, :, : ops.tc].reshape(bv * tv, bh * ops.tc)
    return finish_reference(acc[: ops.rows_out, : ops.lanes_out], epi).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_planes(
    ops: FusedInt8Operands, x: torch.Tensor, x_lo: torch.Tensor | None
) -> None:
    """The limb planes of a ``gamma_pre`` launch: s8, one shape, covering
    every row and lane the operators' windows reach."""
    if x_lo is None or x.dtype != torch.int8 or x_lo.dtype != torch.int8:
        raise ValueError("gamma_pre operands read two s8 limb planes (x, x_lo)")
    if x.shape != x_lo.shape or x.dim() != 2 or (
        x.shape[0] < ops.rows_pad or x.shape[1] < ops.lanes_pad
    ):
        raise ValueError(
            f"limb planes {tuple(x.shape)} / {tuple(x_lo.shape)} must share a "
            f"shape covering [{ops.rows_pad}, {ops.lanes_pad}]"
        )


# avir_fused_int8 (csrc/fused_int8.cu).
LAUNCH = Entry("fused_int8", "avir_fused_int8", span="k1.launch", params=(
    ("x", P), ("x_lo", P), ("out", P), ("rows_in", I), ("lanes_in", I), ("stream", P),
    ("hv", I), ("rows_out", I), ("lanes_out", I),
    ("v1", P), ("v0", P), ("v_comp", P), ("offs_v", P), ("bv", I), ("tv", I), ("wv", I),
    ("h1p", P), ("h0p", P), ("h_comp", P), ("offs_l", P), ("rel", P),
    ("bh", I), ("n_ch", I), ("win_c", I), ("tc", I),
    ("k_range", P), ("n_slices", I),
    ("rows", I), ("slice_range", P), ("n_slices_r", I), ("h_range", P),
    ("h1t", P), ("h0t", P), ("kwin", I), ("lane_align", I),
    ("blocks", I), ("runs", P),
    ("sh", I), ("rec", F),
    *EPILOGUE_PARAMS,
))


def apply_fused_int8(
    ops: FusedInt8Operands, x: torch.Tensor, x_lo: torch.Tensor | None = None
) -> torch.Tensor:
    """Fused int8 resize of the u8 image ``x`` [rows_in, lanes_in] ->
    u8 [rows_out, lanes_out]; with ``ops.gamma_pre``, of K5's limb planes
    ``x`` (hi) and ``x_lo``.  A CUDA tensor launches the kernel; a CPU
    tensor runs the plain version.  While the tracer (utils/trace.py) is
    on, a call is a ``k1.call`` span and its ``ctypes`` call a
    ``k1.launch`` span inside it."""
    if trace.on:
        return trace.call("k1.call", _apply_fused_int8, ops, x, x_lo)
    return _apply_fused_int8(ops, x, x_lo)


def _apply_fused_int8(ops: FusedInt8Operands, x: torch.Tensor, x_lo) -> torch.Tensor:
    if on_cpu(x, ops.device):
        return apply_fused_int8_reference(ops, x, x_lo)
    if ops.gamma_pre:
        _check_planes(ops, x, x_lo)
        if x_lo.device != x.device or not (x.is_contiguous() and x_lo.is_contiguous()):
            raise ValueError("limb planes must be contiguous, on one device")
    else:
        if x_lo is not None:
            raise ValueError("x_lo is the gamma_pre operands' input")
        if x.dtype != torch.uint8 or x.shape != (ops.rows_in, ops.lanes_in):
            raise ValueError(
                f"expected u8 [{ops.rows_in}, {ops.lanes_in}], got "
                f"{x.dtype} {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError("image must be contiguous")
    out = torch.empty((ops.rows_out, ops.lanes_out), dtype=torch.uint8, device=x.device)
    rows_in, lanes_in = x.shape
    LAUNCH.launch(
        x, launches, ops.launch_key, x.data_ptr(), None if x_lo is None else x_lo.data_ptr(),
        out.data_ptr(), rows_in, lanes_in, packed=ops.packed,
    )
    if ops.order == "hv":
        hv_forms[ops.hv_form] += 1
    return out
