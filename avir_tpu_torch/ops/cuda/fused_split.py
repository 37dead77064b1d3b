"""K1 in its split-bf16 modes: the fused two-pass resize, its wrapper and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/fused_kernel.py``
(``apply_fused_pallas`` -> ``_kernel``'s float branch -> ``_rmul`` ->
``_finish``).  The kernel
(``csrc/fused_split.cu``) does the whole separable resize of a u8, u16 or
float32 image in one launch from the error-free bf16 hi/lo taps of a
blocked V operator (ops/banded.py) and a lane operator (ops/lanes.py):

  - the raw input goes to float32 (with gamma: ``x * in_gamma_mult``
    through the degree-9 linearization, ops/gamma.py:_srgb_to_linear)
    and splits as hi = bf16(x), lo = bf16(x - hi);
  - a pass in "split2" mode sums taps_hi@x_hi + taps_lo@x_hi, in
    "split3" mode also taps_hi@x_lo; every product is bf16 x bf16,
    exact in float32, and sums are float32;
  - the float32 intermediate is split the same way between the passes;
  - the epilogue (``fused_kernel.py:Epilogue``, ``finish_reference``)
    converts back to sRGB with gamma, then stores float32, or scales,
    rounds (floor(v + 0.5), round half to even, or floor(v / tm + 0.5) *
    tm when ``trunc_bits`` > 0), clamps to [0, out_max] and stores
    u8/u16.

``prepare_fused_split`` turns the two operators into device tensors once
per executor, with the lane taps in the chunked form (the unchunked form
becomes ``ceil(TC/128)`` chunks at offset 0 over the whole window, as
for the int8 mode) and each row slice's and each chunk's range of
nonzero taps, at the kernel's slice height (64 rows in both orders).

``apply_fused_split`` launches the kernel on a CUDA tensor and runs
``apply_fused_split_reference`` on a CPU tensor.  The two sum in other
orders, so they agree to float32 rounding, not bit for bit: integer
outputs within one LSB, or, where gamma-out's slope or an output scale
amplifies the float32 difference, within the float32 gate on the output's
range plus one step (``tests/torch_cases.py:split_tol``; at most 2 LSB at
3840x2160 -> 7680x4320 u16 RGBA with gamma on an H100).
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from ...utils import trace
from ..banded import BlockedBandedOp, assert_full_f32
from ..gamma import _srgb_to_linear, f32
from ..lanes import LaneBlockedOp
from .fused_kernel import (
    _LANES,
    EPILOGUE_PARAMS,
    Epilogue,
    _k_ranges,
    _variants,
    finish_reference,
    h_ranges,
)
from .launch import F, I, P, Entry, on_cpu

# Launches of each kernel variant of this module, counted by the wrapper:
# fused_split_{vh,hv}[_gamma][_even] (see Epilogue.suffix).
launches = _variants("fused_split")
# Launches by instantiation (``form``'s key, e.g. "vh/s3/s3/gamma/u16->u16"),
# counted by the wrapper beside ``launches``.
forms = collections.Counter()

MODES = ("split2", "split3")
_IN_KINDS = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_OUT_KINDS = {torch.float32: 0, torch.uint8: 1, torch.uint16: 2}
_TYPE_NAMES = {torch.uint8: "u8", torch.uint16: "u16", torch.float32: "f32"}
# Output rows per thread block of the vh and the hv kernel (csrc: kVhRows,
# kHvRows).
VH_ROWS = 64
HV_ROWS = 64


@dataclasses.dataclass(frozen=True)
class FusedSplitOperands:
    """Device-resident operands of one fused split-bf16 resize."""

    order: str            # "vh" (V pass first) or "hv"
    mode_v: str           # "split2" or "split3" for the V pass
    mode_h: str           # the same for the H pass
    out_dtype: torch.dtype  # float32, uint8 or uint16
    out_max: float
    trunc_bits: int
    tm: float             # float32 quantization step when trunc_bits > 0
    epi: Epilogue
    rows_in: int          # input image [rows_in, lanes_in]
    lanes_in: int
    rows_out: int         # output image [rows_out, lanes_out]
    lanes_out: int
    rows_pad: int         # zero-padded extent the windows reach
    lanes_pad: int
    tc: int               # output lanes per lane block
    offs_v_host: tuple[int, ...]
    offs_v: torch.Tensor   # int32 [Bv]
    tvh: torch.Tensor      # bf16 [Bv, Tv, Wv]
    tvl: torch.Tensor
    offs_l: torch.Tensor   # int32 [Bh]
    rel: torch.Tensor      # int32 [n_ch]
    thh: torch.Tensor      # bf16 [Bh, n_ch, win_c, 128]
    thl: torch.Tensor
    rows: int              # output rows per slice (VH_ROWS, HV_ROWS)
    k_range: torch.Tensor  # int32 [Bv, n_slices, 2] nonzero V-tap rows
    h_range: torch.Tensor  # int32 [Bh, n_ch, 2] nonzero lane-tap rows

    @property
    def device(self) -> torch.device:
        return self.tvh.device

    @property
    def launch_key(self) -> str:
        return f"fused_split_{self.order}{self.epi.suffix}"

    @functools.cached_property
    def packed(self) -> tuple:
        """The kernel's arguments fixed for these operands (LAUNCH.pack)."""
        bv, tv, wv = self.tvh.shape
        bh, n_ch, win_c, _ = self.thh.shape
        n_slices = self.k_range.shape[1]
        if bv * n_slices > 65535:
            raise ValueError("too many output row blocks for one launch")
        return LAUNCH.pack(
            self, self.epi, hv=int(self.order == "hv"), split3_v=self.mode_v == "split3",
            split3_h=self.mode_h == "split3", out_kind=_OUT_KINDS[self.out_dtype], bv=bv,
            tv=tv, wv=wv, bh=bh, n_ch=n_ch, win_c=win_c, n_slices=n_slices,
        )

    @functools.cached_property
    def form_keys(self) -> dict:
        """``form``'s key for each input type, made once: the wrapper
        counts a launch under it in ``forms``."""
        return {t: form(self, t) for t in _IN_KINDS}


def form(ops: FusedSplitOperands, in_dtype: torch.dtype) -> str:
    """The kernel instantiation a launch of ``ops`` on an ``in_dtype``
    image runs, as ``forms`` counts it: the pass order, each pass's mode
    ("s3" split3, "s2" split2; V first), "gamma" or "linear", and the input
    and output types."""
    return "/".join((
        ops.order, "s" + ops.mode_v[-1], "s" + ops.mode_h[-1],
        "gamma" if ops.epi.gamma else "linear",
        f"{_TYPE_NAMES[in_dtype]}->{_TYPE_NAMES[ops.out_dtype]}",
    ))


def _chunked_lane_taps(lop: LaneBlockedOp):
    """(hi, lo, rel, win_c): the bf16 lane taps as [Bh, n_ch, win_c, 128]."""
    if lop.ctaps_hi is not None:
        return lop.ctaps_hi, lop.ctaps_lo, lop.chunk_rel, lop.win_c
    bh, wc, tc = lop.taps_hi.shape
    n_ch = -(-tc // _LANES)

    def chunk(t):
        t = torch.nn.functional.pad(t.float(), (0, n_ch * _LANES - tc))
        t = t.reshape(bh, wc, n_ch, _LANES).permute(0, 2, 1, 3)
        return t.to(torch.bfloat16).contiguous()

    return chunk(lop.taps_hi), chunk(lop.taps_lo), (0,) * n_ch, wc


def prepare_fused_split(
    vop: BlockedBandedOp,
    lop: LaneBlockedOp,
    order: str,
    mode_v: str,
    mode_h: str,
    device: torch.device | str,
    out_dtype: torch.dtype = torch.float32,
    out_max: float = 255.0,
    trunc_bits: int = 0,
    scale: float = 1.0,
    round_mode: str = "biased",
    gamma: bool = False,
    alpha_index: int = -1,
    in_gamma_mult: float = 1.0,
    out_gamma_mult: float = 1.0,
) -> FusedSplitOperands:
    """Operands of the fused split-bf16 resize by ``vop`` (rows) and
    ``lop`` (interleaved lanes) in pass order ``order`` with the given
    per-pass modes and epilogue (``fused_kernel.py:Epilogue``; ``scale``
    applies to integer outputs only), on ``device``."""
    if order not in ("vh", "hv"):
        raise ValueError(f"unknown order {order!r}")
    if mode_v not in MODES or mode_h not in MODES:
        raise ValueError(f"modes must be split2/split3, got {mode_v}/{mode_h}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    if lop.out_idx is not None:
        raise ValueError("lane-subset operators are not supported")
    epi = Epilogue(
        scale=float(scale), round_mode=round_mode, gamma=bool(gamma),
        c=lop.c, alpha_index=int(alpha_index),
        in_gamma_mult=float(in_gamma_mult),
        out_gamma_mult=float(out_gamma_mult),
    )
    tm = 1.0
    if trunc_bits > 0 and out_dtype != torch.float32:
        tm = float(np.float32(out_max / (int(out_max) >> trunc_bits)))
    hi, lo, rel, _ = _chunked_lane_taps(lop)
    rows = VH_ROWS if order == "vh" else HV_ROWS
    k_range = _k_ranges(
        (vop.taps_hi != 0).numpy(), (vop.taps_lo != 0).numpy(), rows
    )

    def dev(a, dtype=None):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a)
        )
        return t.to(device=device, dtype=dtype).contiguous()

    return FusedSplitOperands(
        order=order,
        mode_v=mode_v,
        mode_h=mode_h,
        out_dtype=out_dtype,
        out_max=float(out_max),
        trunc_bits=int(trunc_bits) if out_dtype != torch.float32 else 0,
        tm=tm,
        epi=epi,
        rows_in=vop.n_in,
        lanes_in=lop.n_in * lop.c,
        rows_out=vop.n_out,
        lanes_out=lop.n_out * lop.c,
        rows_pad=vop.n_in_pad,
        lanes_pad=lop.lanes_pad,
        tc=lop.tile * lop.c,
        offs_v_host=tuple(int(o) for o in vop.offs),
        offs_v=dev(vop.offs, torch.int32),
        tvh=dev(vop.taps_hi),
        tvl=dev(vop.taps_lo),
        offs_l=dev(lop.offs_l, torch.int32),
        rel=dev(np.asarray(rel), torch.int32),
        thh=dev(hi),
        thl=dev(lo),
        rows=rows,
        k_range=dev(k_range),
        h_range=dev(h_ranges((hi != 0).numpy(), (lo != 0).numpy())),
    )


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-free bf16 split of a float32 tensor, as float32 tensors."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def to_float32(x: torch.Tensor) -> torch.Tensor:
    """u8/u16 through int32 to float32; float32 as it is."""
    if x.dtype in (torch.uint8, torch.uint16):
        return x.to(torch.int32).float()
    return x.float()


def vh_passes(
    xs: torch.Tensor, tvh: torch.Tensor, tvl: torch.Tensor,
    thh: torch.Tensor, thl: torch.Tensor, offs_v: tuple[int, ...],
    lane_idx: torch.Tensor, s3v: bool, s3h: bool,
) -> torch.Tensor:
    """The V pass, then the chunked H pass, of the float32 image ``xs``
    [rows_pad, lanes_pad] by float32 bf16-valued taps (V [Bv, Tv, Wv] at
    ``offs_v``, H [Bh, n_ch, win_c, 128] over the window lanes
    ``lane_idx`` [Bh, n_ch, win_c]), the input and the intermediate split
    into bf16 hi/lo: float32 [Bv, Tv, Bh, n_ch * 128]."""
    bv, tv, wv = tvh.shape
    bh, n_ch = thh.shape[:2]
    out = torch.empty((bv, tv, bh, n_ch * _LANES), dtype=torch.float32, device=xs.device)
    for b, o in enumerate(offs_v):
        wh, wl = _split(xs[o : o + wv])
        v = tvh[b] @ wh + tvl[b] @ wh
        if s3v:
            v = v + tvh[b] @ wl
        vh, vl = _split(v)
        gh = vh[:, lane_idx]  # [Tv, Bh, n_ch, win_c]
        acc = torch.einsum("tbjw,bjwc->tbjc", gh, thh) + torch.einsum(
            "tbjw,bjwc->tbjc", gh, thl
        )
        if s3h:
            acc = acc + torch.einsum("tbjw,bjwc->tbjc", vl[:, lane_idx], thh)
        out[b] = acc.reshape(tv, bh, -1)
    return out


def apply_fused_split_reference(
    ops: FusedSplitOperands, x: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch fused split-bf16 resize: [rows_in, lanes_in] of u8,
    u16 or float32 -> [rows_out, lanes_out] of ``ops.out_dtype``, on the
    device of ``x``: float32 products of bf16-valued tensors."""
    dev = x.device
    if dev.type == "cuda":
        assert_full_f32()
    xs = torch.zeros((ops.rows_pad, ops.lanes_pad), dtype=torch.float32, device=dev)
    # The windows may end before the image does (an operator that reads a
    # subset of the lanes or rows): what lies past the pad is never read.
    r, l = min(ops.rows_in, ops.rows_pad), min(ops.lanes_in, ops.lanes_pad)
    xs[:r, :l] = to_float32(x[:r, :l])
    epi = ops.epi
    if epi.gamma:  # padding stays 0
        xs = _srgb_to_linear(xs * f32(epi.in_gamma_mult), epi.c, epi.alpha_index)

    tvh, tvl = ops.tvh.float(), ops.tvl.float()
    thh, thl = ops.thh.float(), ops.thl.float()
    s3v, s3h = ops.mode_v == "split3", ops.mode_h == "split3"
    bv, tv, wv = ops.tvh.shape
    bh, n_ch, win_c, _ = ops.thh.shape
    lane_idx = (
        ops.offs_l.long()[:, None, None]
        + ops.rel.long()[None, :, None]
        + torch.arange(win_c, device=dev)
    )  # [Bh, n_ch, win_c]
    if ops.order == "vh":
        out = vh_passes(xs, tvh, tvl, thh, thl, ops.offs_v_host, lane_idx, s3v, s3h)
    else:
        out = torch.empty((bv, tv, bh, n_ch * _LANES), dtype=torch.float32, device=dev)

        def vpass(b, wh, wl):
            acc = tvh[b] @ wh + tvl[b] @ wh
            return acc + tvh[b] @ wl if s3v else acc

        xh, xl = _split(xs)
        hp = torch.empty((ops.rows_pad, bh, n_ch, _LANES), dtype=torch.float32, device=dev)
        for j in range(n_ch):
            gh = xh[:, lane_idx[:, j]]  # [rows, Bh, win_c]
            acc = torch.einsum("rbw,bwc->rbc", gh, thh[:, j]) + torch.einsum(
                "rbw,bwc->rbc", gh, thl[:, j]
            )
            if s3h:
                acc = acc + torch.einsum(
                    "rbw,bwc->rbc", xl[:, lane_idx[:, j]], thh[:, j]
                )
            hp[:, :, j] = acc
        hh, hl = _split(hp.reshape(ops.rows_pad, -1))
        for b, o in enumerate(ops.offs_v_host):
            out[b] = vpass(b, hh[o : o + wv], hl[o : o + wv]).reshape(tv, bh, -1)

    out = out[:, :, :, : ops.tc].reshape(bv * tv, bh * ops.tc)
    return finish_reference(
        out[: ops.rows_out, : ops.lanes_out], epi, ops.out_dtype,
        ops.out_max, ops.trunc_bits, ops.tm,
    ).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# avir_fused_split (csrc/fused_split.cu).
LAUNCH = Entry("fused_split", "avir_fused_split", span="split.launch", params=(
    ("x", P), ("out", P), ("in_kind", I), ("stream", P),
    ("hv", I), ("split3_v", I), ("split3_h", I), ("out_kind", I),
    ("rows_in", I), ("lanes_in", I), ("rows_out", I), ("lanes_out", I),
    ("tvh", P), ("tvl", P), ("offs_v", P), ("bv", I), ("tv", I), ("wv", I),
    ("thh", P), ("thl", P), ("offs_l", P), ("rel", P),
    ("bh", I), ("n_ch", I), ("win_c", I), ("tc", I),
    ("k_range", P), ("n_slices", I), ("h_range", P),
    ("out_max", F), ("tm", F), ("trunc_bits", I),
    *EPILOGUE_PARAMS,
))


def apply_fused_split(ops: FusedSplitOperands, x: torch.Tensor) -> torch.Tensor:
    """Fused split-bf16 resize of ``x`` [rows_in, lanes_in] (u8, u16 or
    float32) -> [rows_out, lanes_out] of ``ops.out_dtype``.  A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version.  While the
    tracer (utils/trace.py) is on, a call is a ``split.call`` span and its
    ``ctypes`` call a ``split.launch`` span inside it."""
    if trace.on:
        return trace.call("split.call", _apply_fused_split, ops, x)
    return _apply_fused_split(ops, x)


def _apply_fused_split(ops: FusedSplitOperands, x: torch.Tensor) -> torch.Tensor:
    if on_cpu(x, ops.device):
        return apply_fused_split_reference(ops, x)
    if x.dtype not in _IN_KINDS or x.shape != (ops.rows_in, ops.lanes_in):
        raise ValueError(
            f"expected u8/u16/f32 [{ops.rows_in}, {ops.lanes_in}], got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("image must be contiguous")
    out = torch.empty((ops.rows_out, ops.lanes_out), dtype=ops.out_dtype, device=x.device)
    LAUNCH.launch(
        x, launches, ops.launch_key, x.data_ptr(), out.data_ptr(), _IN_KINDS[x.dtype],
        packed=ops.packed,
    )
    forms[ops.form_keys[x.dtype]] += 1
    return out
