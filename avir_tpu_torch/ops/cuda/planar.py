"""K7: the planar split-bf16 fused resize, its wrapper and its plain
PyTorch version; and the operands, plain passes and launcher it shares
with K8 (ops/cuda/planar2.py).

Counterpart of the JAX package's ``ops/pallas/planar_kernel.py``
(``apply_planar_pallas``, ``plane_stride``, ``planar_viable``,
``deinterleave``, ``reinterleave``).  The channels of an image are
resized as separate planes stacked along the rows, [c*hp, wp] (plane p's
row r at p*hp + r), so the H pass takes DENSE taps [Wh, Th] per block (the
lane form at C = 1, ``lane_block_banded(op, 1)``) instead of K1's
channel-diagonal [Wh*C, Th*C].  The arithmetic is K1's split modes
(ops/cuda/fused_split.py): input and intermediate split into bf16 hi/lo,
split2 or split3 per pass, float32 sums; gamma in the kernel, with a whole
plane (``alpha_plane``) bypassing the curves (scaled only); K1's epilogue.
Output: planar [c*Bv*Tv, Bh*Th], whole blocks; ``reinterleave`` slices
and interleaves it.

The JAX package's routing never selects this kernel (planar2_kernel.py
there, :27-37); it is reached by direct calls, as here.  ``deinterleave``
and ``reinterleave`` are plain PyTorch permutes and pads (XLA's there).
``planar_viable`` is the JAX package's TPU VMEM budget, ported unchanged
so that both packages answer alike; it says nothing about this card.

``apply_planar`` launches the kernel (csrc/planar.cu) on a CUDA tensor
and runs ``apply_planar_reference`` on a CPU tensor.  The kernel is K1
split vh's tensor-core design for one channel: a thread block owns
``ROWS`` (64) output rows of one V block, one 128-pixel
chunk of one H block and one channel, and runs both passes on bf16
``mma.sync`` over the slice's nonzero V-tap rows (``k_range``, built at
that height) and the chunk's nonzero H-tap rows (``h_range``).  The two
sum in other orders, so they agree to float32 rounding (the split gate
of fused_split.py), not bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..banded import BlockedBandedOp, assert_full_f32
from ..gamma import _srgb_to_linear, f32
from ..lanes import LaneBlockedOp
from .fused_kernel import _k_ranges, Epilogue, finish_reference, h_ranges
from .fused_split import (
    _IN_KINDS,
    _OUT_KINDS,
    MODES,
    _chunked_lane_taps,
    to_float32,
    vh_passes,
)
from .launch import F, I, P, Entry, on_cpu

# Launches of the kernel, counted by the wrapper.
launches = {"planar": 0}

# Output rows per thread block (csrc/planar.cu: kRows).
ROWS = 64
# K8's raw span tile, [32 rows][raw_row_bytes], beside the 90,112 bytes of
# the kernel's other shared memory at 64 rows: two blocks an SM.
RAW_TILE_BYTES = 25_600


def plane_stride(vop: BlockedBandedOp) -> int:
    """Row stride between stacked channel planes (32-aligned)."""
    return -(-vop.n_in_pad // 32) * 32


def planar_viable(vop: BlockedBandedOp, pop: LaneBlockedOp) -> bool:
    """The JAX package's VMEM-budget check of its planar kernel's block
    shapes (a TPU limit, kept for parity)."""
    _, tv, wv = vop.taps_hi.shape
    _, wh, th = pop.taps_hi.shape
    vmem = (
        2 * wv * wh            # double-buffered input window (u8-worst)
        + 4 * wv * wh          # f32 conversion temp
        + 2 * 2 * tv * wv * 2  # V taps hi/lo, double-buffered
        + 2 * 2 * wh * th * 2  # H taps hi/lo, double-buffered
        + 4 * tv * wh          # inter-pass f32 intermediate
        + 2 * 4 * tv * th      # output tiles
    )
    return vmem < 14 * 1024 * 1024


def deinterleave(
    src: torch.Tensor, h: int, w: int, c: int, hp: int, wp: int
) -> torch.Tensor:
    """[h, w*c] interleaved -> [c*hp, wp] planar-stacked (one copy of the
    raw dtype, zero-padded)."""
    x = src.reshape(h, w, c).permute(2, 0, 1)
    return torch.nn.functional.pad(x, (0, wp - w, 0, hp - h)).reshape(c * hp, wp)


def reinterleave(
    out_planar: torch.Tensor, c: int, bv_tv: int, new_h: int, new_w: int
) -> torch.Tensor:
    """[c*Bv*Tv, Bh*Th] planar -> [new_h, new_w*c] interleaved."""
    x = out_planar.reshape(c, bv_tv, -1)[:, :new_h, :new_w]
    return x.permute(1, 2, 0).reshape(new_h, new_w * c)


@dataclasses.dataclass(frozen=True)
class PlanarOperands:
    """Device-resident operands of one K7 (planar input) or K8
    (interleaved input) resize."""

    interleaved: bool       # K8's input layout (else K7's planes)
    c: int
    mode_v: str
    mode_h: str
    out_dtype: torch.dtype
    out_max: float
    trunc_bits: int
    tm: float
    epi: Epilogue           # C = 1; the alpha bypass is ``alpha``
    alpha: int              # K7 plane / K8 channel skipping the curves, or -1
    rows_pad: int           # input rows the windows reach
    lanes_pad: int          # input pixels the windows reach
    hp: int                 # K7: row stride between planes
    th: int                 # output pixels per H block
    offs_v_host: tuple[int, ...]
    offs_v: torch.Tensor    # int32 [Bv]
    tvh: torch.Tensor       # bf16 [Bv, Tv, Wv]
    tvl: torch.Tensor
    offs_l: torch.Tensor    # int32 [Bh] window starts, pixels
    rel: torch.Tensor       # int32 [n_ch]
    thh: torch.Tensor       # bf16 [Bh, n_ch, win_c, 128] dense H taps
    thl: torch.Tensor
    k_range: torch.Tensor   # int32 [Bv, n_slices, 2] at ROWS-row slices
    h_range: torch.Tensor   # int32 [Bh, n_ch, 2]

    @property
    def device(self) -> torch.device:
        return self.tvh.device

    @property
    def out_shape(self) -> tuple[int, int]:
        bv, tv, _ = self.tvh.shape
        bh = self.thh.shape[0]
        if self.interleaved:
            return bv * tv, bh * self.c * self.th
        return self.c * bv * tv, bh * self.th

    @property
    def launch_key(self) -> str:
        return "planar2" if self.interleaved else "planar"

    @functools.cached_property
    def packed(self) -> tuple:
        """The kernel's arguments fixed for these operands (LAUNCH.pack)."""
        bv, tv, wv = self.tvh.shape
        bh, n_ch, win_c, _ = self.thh.shape
        n_slices = self.k_range.shape[1]
        if bv * n_slices > 65535:
            raise ValueError("too many output row blocks for one launch")
        # The channel that skips gamma-in: K7's alpha plane; K8's only under
        # the C = 4 interleaved lane mask (alpha 0 or 3), as the reference.
        alpha_in = self.alpha if (
            not self.interleaved or (self.c == 4 and self.alpha in (0, 3))
        ) else -1
        return LAUNCH.pack(
            self, self.epi, split3_v=self.mode_v == "split3", split3_h=self.mode_h == "split3",
            out_kind=_OUT_KINDS[self.out_dtype], out_lanes=self.out_shape[1], bv=bv, tv=tv,
            wv=wv, bh=bh, n_ch=n_ch, win_c=win_c, n_slices=n_slices, alpha_in=alpha_in,
            alpha_out=self.alpha,
        )


def prepare_planar(
    vop: BlockedBandedOp,
    pop: LaneBlockedOp,
    c: int,
    device: torch.device | str,
    mode_v: str = "split2",
    mode_h: str = "split3",
    out_dtype: torch.dtype = torch.float32,
    out_max: float = 255.0,
    trunc_bits: int = 0,
    scale: float = 1.0,
    round_mode: str = "biased",
    gamma: bool = False,
    alpha_plane: int = -1,
    in_gamma_mult: float = 1.0,
    out_gamma_mult: float = 1.0,
    interleaved: bool = False,
) -> PlanarOperands:
    """Operands of K7 (or, with ``interleaved``, K8) for the blocked V
    operator ``vop`` and the dense lane operator ``pop``
    (``lane_block_banded(op, 1)``) over ``c`` channels; the arguments of
    ``apply_planar_pallas`` there.  ``alpha_plane``: the plane (K8: the
    channel) whose values bypass the sRGB curves."""
    if mode_v not in MODES or mode_h not in MODES:
        raise ValueError(f"modes must be split2/split3, got {mode_v}/{mode_h}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    if pop.c != 1 or pop.out_idx is not None:
        raise ValueError("the H operator must be the dense lane form at C = 1")
    epi = Epilogue(
        scale=float(scale), round_mode=round_mode, gamma=bool(gamma),
        in_gamma_mult=float(in_gamma_mult), out_gamma_mult=float(out_gamma_mult),
    )
    tm = 1.0
    if trunc_bits > 0 and out_dtype != torch.float32:
        tm = f32(out_max / (int(out_max) >> trunc_bits))
    hi, lo, rel, _ = _chunked_lane_taps(pop)

    def dev(a, dtype=None):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype).contiguous()

    return PlanarOperands(
        interleaved=bool(interleaved),
        c=int(c),
        mode_v=mode_v,
        mode_h=mode_h,
        out_dtype=out_dtype,
        out_max=float(out_max),
        trunc_bits=int(trunc_bits) if out_dtype != torch.float32 else 0,
        tm=tm,
        epi=epi,
        alpha=int(alpha_plane) if gamma else -1,
        rows_pad=vop.n_in_pad,
        lanes_pad=pop.lanes_pad,
        hp=plane_stride(vop),
        th=pop.tile,
        offs_v_host=tuple(int(o) for o in vop.offs),
        offs_v=dev(vop.offs, torch.int32),
        tvh=dev(vop.taps_hi),
        tvl=dev(vop.taps_lo),
        offs_l=dev(pop.offs_l, torch.int32),
        rel=dev(np.asarray(rel), torch.int32),
        thh=dev(hi),
        thl=dev(lo),
        k_range=dev(_k_ranges((vop.taps_hi != 0).numpy(), (vop.taps_lo != 0).numpy(), ROWS)),
        h_range=dev(h_ranges((hi != 0).numpy(), (lo != 0).numpy())),
    )


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def planes_reference(ops: PlanarOperands, planes: list[torch.Tensor]) -> torch.Tensor:
    """Both passes and the epilogue of each float32 plane [rows_pad,
    lanes_pad] (after the pack stage): [c, Bv*Tv, Bh*Th] of
    ``ops.out_dtype``."""
    dev = planes[0].device
    if dev.type == "cuda":
        assert_full_f32()
    bv, tv, _ = ops.tvh.shape
    bh, _, win_c, _ = ops.thh.shape
    lane_idx = (
        ops.offs_l.long()[:, None, None]
        + ops.rel.long()[None, :, None]
        + torch.arange(win_c, device=dev)
    )  # [Bh, n_ch, win_c]
    taps = (ops.tvh.float(), ops.tvl.float(), ops.thh.float(), ops.thl.float())
    out = []
    for p, xs in enumerate(planes):
        acc = vh_passes(
            xs, *taps, ops.offs_v_host, lane_idx,
            ops.mode_v == "split3", ops.mode_h == "split3",
        )[..., : ops.th].reshape(bv * tv, bh * ops.th)
        out.append(finish_reference(
            acc, ops.epi, ops.out_dtype, ops.out_max, ops.trunc_bits, ops.tm,
            curve=p != ops.alpha,
        ))
    return torch.stack(out)


def apply_planar_reference(ops: PlanarOperands, xp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7: planar [c*hp, wp] (u8, u16 or float32) -> planar
    [c*Bv*Tv, Bh*Th] of ``ops.out_dtype``, on the device of ``xp``."""
    planes = []
    rows, lanes = min(ops.rows_pad, ops.hp), min(ops.lanes_pad, xp.shape[1])
    for p in range(ops.c):
        xs = torch.zeros((ops.rows_pad, ops.lanes_pad), dtype=torch.float32, device=xp.device)
        xs[:rows, :lanes] = to_float32(xp[p * ops.hp : p * ops.hp + rows, :lanes])
        if ops.epi.gamma:
            xs = xs * f32(ops.epi.in_gamma_mult)
            if p != ops.alpha:
                xs = _srgb_to_linear(xs, 1, -1)
        planes.append(xs)
    return planes_reference(ops, planes).reshape(ops.out_shape)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def raw_row_bytes(ops: PlanarOperands, x: torch.Tensor) -> int:
    """The row stride in bytes of K8's raw span tile for the image ``x``: a
    step's 128-pixel span of all C channels, plus the lead to the 16-byte
    boundary before it, which the kernel stages once by 16-byte copies and
    de-interleaves from shared memory.  0 (each block loads its channel at
    a stride of C) for K7, where 32 rows of it exceed RAW_TILE_BYTES, or
    where the rows or the base of ``x`` are not 16-byte aligned."""
    if not ops.interleaved:
        return 0
    es = x.element_size()
    ld = -(-128 * ops.c * es // 16) * 16 + 16
    if 32 * ld > RAW_TILE_BYTES or x.data_ptr() % 16 or (x.shape[1] * es) % 16:
        return 0
    return ld


# avir_planar (csrc/planar.cu), K7's and K8's launch.
LAUNCH = Entry("planar", "avir_planar", params=(
    ("x", P), ("out", P), ("in_kind", I), ("rows_in", I), ("lanes_in", I), ("raw_ld", I),
    ("stream", P),
    ("interleaved", I), ("split3_v", I), ("split3_h", I), ("out_kind", I),
    ("c", I), ("hp", I), ("out_lanes", I),
    ("tvh", P), ("tvl", P), ("offs_v", P), ("bv", I), ("tv", I), ("wv", I),
    ("thh", P), ("thl", P), ("offs_l", P), ("rel", P),
    ("bh", I), ("n_ch", I), ("win_c", I), ("th", I),
    ("k_range", P), ("n_slices", I), ("h_range", P),
    ("out_max", F), ("tm", F), ("trunc_bits", I),
    ("gamma", I), ("alpha_in", I), ("alpha_out", I), ("in_gamma_mult", F),
    ("out_gamma_mult", F), ("scale", F), ("even", I),
))


def launch_planar(ops: PlanarOperands, x: torch.Tensor, counts: dict) -> torch.Tensor:
    """Launch csrc/planar.cu on the CUDA tensor ``x`` in ``ops``' layout;
    ``counts[ops.launch_key]`` counts the launch."""
    if x.dtype not in _IN_KINDS or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous 2-D u8/u16/f32 image, got {x.dtype} {tuple(x.shape)}")
    if not ops.interleaved and x.shape[0] < ops.c * ops.hp:
        raise ValueError(f"planar input needs >= {ops.c * ops.hp} rows, got {x.shape[0]}")
    out = torch.empty(ops.out_shape, dtype=ops.out_dtype, device=x.device)
    LAUNCH.launch(
        x, counts, ops.launch_key, x.data_ptr(), out.data_ptr(), _IN_KINDS[x.dtype], *x.shape,
        raw_row_bytes(ops, x), packed=ops.packed,
    )
    return out


def apply_planar(ops: PlanarOperands, xp: torch.Tensor) -> torch.Tensor:
    """K7: planar [c*hp, wp] (u8, u16 or float32) -> planar [c*Bv*Tv,
    Bh*Th] of ``ops.out_dtype``.  A CUDA tensor launches the kernel; a CPU
    tensor runs the plain version."""
    if ops.interleaved:
        raise ValueError("interleaved operands are K8's (ops/cuda/planar2.py)")
    if on_cpu(xp, ops.device):
        return apply_planar_reference(ops, xp)
    return launch_planar(ops, xp, launches)
