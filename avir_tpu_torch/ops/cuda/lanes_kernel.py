"""K3: the lane-contracting banded pass, its wrapper and its plain PyTorch
version.

Counterpart of the JAX package's ``ops/pallas/lanes_kernel.py``
(``apply_lanes_pallas`` -> ``_kernel``; the plain version ports its XLA
spec ``apply_lanes_xla``).  The pass contracts the interleaved lane axis
of an image [rows, n_in*C] (u8, u16 or float32, converted as it is
staged) with a lane-blocked operator (ops/lanes.py) and writes float32
[rows, n_out*C] in the final interleaved layout:

    out[:, b*TC : (b+1)*TC] = x[:, offs_l[b] : offs_l[b] + WC] @ taps[b]

in mode "split2" (bf16(x) against the bf16 hi + lo taps) or "split3"
(adds the input residual against hi).

The dense tap blocks are channel-diagonal and banded, so
``prepare_lanes`` keeps each output lane's nonzero diagonal only: the
input lane of its first nonzero tap and ``kp`` taps at a stride of C
lanes (the kernel, ``csrc/lanes.cu``, drops only zero products), plus
each 128-lane output chunk's input window.

``apply_lanes`` launches the kernel on a CUDA tensor and runs
``apply_lanes_reference`` on a CPU tensor.  The two sum in other orders,
so they agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..banded import assert_full_f32
from ..lanes import LaneBlockedOp
from .fused_split import to_float32

# Launches of each mode of this kernel, counted by the wrapper.
launches = {f"lanes_{m}": 0 for m in ("split2", "split3")}

MODES = ("split2", "split3")
_LANES = 128  # output lanes per thread block (csrc: kLanes)
_IN_KINDS = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


@dataclasses.dataclass(frozen=True)
class LanesOperands:
    """Device-resident operands of one lane pass."""

    lop: LaneBlockedOp
    mode: str
    kp: int               # taps per output lane (its nonzero diagonal)
    first: torch.Tensor   # int32 [Bh, tcp]: input lane of tap 0
    hi: torch.Tensor      # bf16 [Bh, kp, tcp] compact taps
    lo: torch.Tensor
    win: torch.Tensor     # int32 [Bh * n_ch, 2]: chunk input lanes [lo, hi)

    @property
    def device(self) -> torch.device:
        return self.hi.device

    @property
    def launch_key(self) -> str:
        return f"lanes_{self.mode}"

    @property
    def n_ch(self) -> int:
        return self.hi.shape[2] // _LANES


def compact_lane_taps(lop: LaneBlockedOp):
    """(first, hi, lo, kp, win) of the kernel's compact form (see the
    module docstring), from the dense bf16 tap blocks; raises if a
    nonzero tap would be dropped."""
    hi = lop.taps_hi.float().numpy()
    lo = lop.taps_lo.float().numpy()
    bh, wc, tc = hi.shape
    c = lop.c
    nz = (hi != 0) | (lo != 0)                      # [Bh, WC, TC]
    used = nz.any(axis=1)                           # [Bh, TC]
    f_rel = np.argmax(nz, axis=1)
    l_rel = wc - 1 - np.argmax(nz[:, ::-1, :], axis=1)
    kp = int(((l_rel - f_rel) // c + 1)[used].max()) if used.any() else 1
    # Columns without taps (past n_out) take their left neighbour's
    # window; column 0 of every block has taps.
    col = np.where(used, np.arange(tc)[None, :], 0)
    f_rel = np.take_along_axis(f_rel, np.maximum.accumulate(col, axis=1), axis=1)

    rows = f_rel[:, None, :] + c * np.arange(kp)[None, :, None]  # [Bh, kp, TC]
    inside = rows < wc
    rows = np.minimum(rows, wc - 1)

    def gather(t):
        g = np.take_along_axis(t, rows, axis=1)
        return np.where(inside, g, 0.0).astype(np.float32)

    chi, clo = gather(hi), gather(lo)
    if int(((chi != 0) | (clo != 0)).sum()) != int(nz.sum()):
        raise ValueError("lane taps are not channel-diagonal bands")

    n_ch = -(-tc // _LANES)
    tcp = n_ch * _LANES
    pad = ((0, 0), (0, 0), (0, tcp - tc))
    chi, clo = np.pad(chi, pad), np.pad(clo, pad)
    first = lop.offs_l.astype(np.int64)[:, None] + f_rel
    first = np.pad(first, ((0, 0), (0, tcp - tc)), mode="edge")  # [Bh, tcp]
    f3 = first.reshape(bh, n_ch, _LANES)
    win = np.stack([f3.min(axis=2), f3.max(axis=2) + (kp - 1) * c + 1], axis=2)
    return (
        first.astype(np.int32),
        torch.from_numpy(chi).to(torch.bfloat16),
        torch.from_numpy(clo).to(torch.bfloat16),
        kp,
        win.reshape(bh * n_ch, 2).astype(np.int32),
    )


def prepare_lanes(
    lop: LaneBlockedOp, mode: str, device: torch.device | str
) -> LanesOperands:
    """Operands of the lane pass by ``lop`` in ``mode`` on ``device``."""
    if mode not in MODES:
        raise ValueError(f"modes are split2/split3, got {mode!r}")
    if lop.out_idx is not None:
        raise ValueError("lane-subset operators are not supported")
    first, hi, lo, kp, win = compact_lane_taps(lop)
    return LanesOperands(
        lop=lop,
        mode=mode,
        kp=kp,
        first=torch.from_numpy(first).to(device),
        hi=hi.to(device),
        lo=lo.to(device),
        win=torch.from_numpy(win).to(device),
    )


def apply_lanes_reference(ops: LanesOperands, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch lane pass (``apply_lanes_xla`` there): per block, the
    input window against the dense bf16 tap block, as float32 products
    of bf16-valued tensors."""
    if x.device.type == "cuda":
        assert_full_f32()
    lop = ops.lop
    x = to_float32(x)
    rows, lanes = x.shape
    if lop.lanes_pad > lanes:
        x = torch.nn.functional.pad(x, (0, lop.lanes_pad - lanes))
    hi = lop.taps_hi.to(x.device).float()
    lo = lop.taps_lo.to(x.device).float()
    wc = lop.win_l
    outs = []
    for b, o in enumerate(int(v) for v in lop.offs_l):
        xw = x[:, o : o + wc]
        xh = xw.to(torch.bfloat16).float()
        y = xh @ hi[b] + xh @ lo[b]
        if ops.mode == "split3":
            y = y + (xw - xh).to(torch.bfloat16).float() @ hi[b]
        outs.append(y)
    return torch.cat(outs, dim=1)[:, : lop.n_out * lop.c]


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [
    _I, _I,                  # split3, in_kind
    _P, _I, _I,              # x, rows, lanes_in
    _P, _I,                  # out, lanes_out
    _P, _P, _P, _P,          # first, hi, lo, win
    _I, _I, _I, _I, _I, _I,  # bh, n_ch, tc, tcp, kp, c
    _P,                      # stream
]


def _library():
    from .build import load_library

    fn = load_library("lanes").avir_lanes
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def apply_lanes(ops: LanesOperands, x: torch.Tensor) -> torch.Tensor:
    """Lane pass of ``x`` [rows, n_in*C] (u8, u16 or float32) -> float32
    [rows, n_out*C].  A CUDA tensor launches the kernel; a CPU tensor
    runs the plain version."""
    if x.device.type == "cpu" and ops.device.type == "cpu":
        return apply_lanes_reference(ops, x)
    if x.device.type != "cuda" or x.device != ops.device:
        raise ValueError(
            f"image on {x.device}, operands on {ops.device}: both must be "
            "on one CUDA device (or both on the CPU)"
        )
    lop = ops.lop
    if x.dtype not in _IN_KINDS or x.dim() != 2 or x.shape[1] != lop.n_in * lop.c:
        raise ValueError(
            f"expected u8/u16/f32 [rows, {lop.n_in * lop.c}], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("image must be contiguous")
    rows = x.shape[0]
    bh = lop.n_blocks
    if -(-rows // 32) > 65535:
        raise ValueError("too many rows for one launch")
    lanes_out = lop.n_out * lop.c
    out = torch.empty((rows, lanes_out), dtype=torch.float32, device=x.device)
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            int(ops.mode == "split3"), _IN_KINDS[x.dtype],
            x.data_ptr(), rows, x.shape[1],
            out.data_ptr(), lanes_out,
            ops.first.data_ptr(), ops.hi.data_ptr(), ops.lo.data_ptr(),
            ops.win.data_ptr(),
            bh, ops.n_ch, lop.tile * lop.c, ops.hi.shape[2], ops.kp, lop.c,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"lanes launch failed: CUDA error {err}")
    launches[ops.launch_key] += 1
    return out
