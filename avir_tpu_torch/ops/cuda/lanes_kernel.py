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

``prepare_lanes`` takes the lane taps in the chunked form that K1 split
already builds (``fused_split._chunked_lane_taps``: per 128-lane output
chunk, its taps over a ``win_c``-lane sub-window at offset ``rel[j]``)
and each chunk's range of nonzero tap rows (``fused_kernel.h_ranges``);
the kernel (``csrc/lanes.cu``) multiplies the image by those dense tap
blocks on the bf16 tensor cores, 64 image rows and one chunk a block.

``apply_lanes`` launches the kernel on a CUDA tensor and runs
``apply_lanes_reference`` on a CPU tensor.  The two sum in other orders,
so they agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..banded import assert_full_f32
from ..lanes import LaneBlockedOp
from .fused_kernel import h_ranges
from .fused_split import _chunked_lane_taps, to_float32
from .launch import I, P, Entry, on_cpu

# Launches of each mode of this kernel, counted by the wrapper.
launches = {f"lanes_{m}": 0 for m in ("split2", "split3")}

MODES = ("split2", "split3")
_IN_KINDS = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
# Image rows per thread block (csrc: kRows); the grid's second axis holds
# at most 65535 of them.
ROWS = 64
_MAX_ROW_BLOCKS = 65535


@dataclasses.dataclass(frozen=True)
class LanesOperands:
    """Device-resident operands of one lane pass."""

    lop: LaneBlockedOp
    mode: str
    offs_l: torch.Tensor   # int32 [Bh]: window start of each lane block
    rel: torch.Tensor      # int32 [n_ch]: chunk offset inside the window
    thh: torch.Tensor      # bf16 [Bh, n_ch, win_c, 128] chunked lane taps
    thl: torch.Tensor
    h_range: torch.Tensor  # int32 [Bh, n_ch, 2]: nonzero tap rows, 32-aligned

    @property
    def device(self) -> torch.device:
        return self.thh.device

    @property
    def launch_key(self) -> str:
        return f"lanes_{self.mode}"

    @property
    def n_ch(self) -> int:
        return self.thh.shape[1]

    @functools.cached_property
    def packed(self) -> tuple:
        """The kernel's arguments fixed for these operands (LAUNCH.pack)."""
        lop = self.lop
        bh, n_ch, win_c, _ = self.thh.shape
        return LAUNCH.pack(
            self, split3=self.mode == "split3", lanes_in=lop.n_in * lop.c,
            lanes_out=lop.n_out * lop.c, bh=bh, n_ch=n_ch, win_c=win_c, tc=lop.tile * lop.c,
        )


def prepare_lanes(
    lop: LaneBlockedOp, mode: str, device: torch.device | str
) -> LanesOperands:
    """Operands of the lane pass by ``lop`` in ``mode`` on ``device``."""
    if mode not in MODES:
        raise ValueError(f"modes are split2/split3, got {mode!r}")
    if lop.out_idx is not None:
        raise ValueError("lane-subset operators are not supported")
    hi, lo, rel, _ = _chunked_lane_taps(lop)
    h_range = h_ranges((hi != 0).numpy(), (lo != 0).numpy())
    return LanesOperands(
        lop=lop,
        mode=mode,
        offs_l=torch.from_numpy(lop.offs_l.astype(np.int32)).to(device),
        rel=torch.tensor(rel, dtype=torch.int32).to(device),
        thh=hi.to(device).contiguous(),
        thl=lo.to(device).contiguous(),
        h_range=torch.from_numpy(h_range).to(device),
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


# avir_lanes (csrc/lanes.cu).
LAUNCH = Entry("lanes", "avir_lanes", params=(
    ("x", P), ("out", P), ("in_kind", I), ("rows", I), ("stream", P),
    ("split3", I), ("lanes_in", I), ("lanes_out", I),
    ("thh", P), ("thl", P), ("offs_l", P), ("rel", P), ("h_range", P),
    ("bh", I), ("n_ch", I), ("win_c", I), ("tc", I),
))


def check_input(ops: LanesOperands, x: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes ``x``: a contiguous u8,
    u16 or float32 [rows, n_in*C] whose row blocks fit one launch."""
    lop = ops.lop
    if x.dtype not in _IN_KINDS or x.dim() != 2 or x.shape[1] != lop.n_in * lop.c:
        raise ValueError(
            f"expected u8/u16/f32 [rows, {lop.n_in * lop.c}], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("image must be contiguous")
    if -(-x.shape[0] // ROWS) > _MAX_ROW_BLOCKS:
        raise ValueError("too many rows for one launch")


def apply_lanes(ops: LanesOperands, x: torch.Tensor) -> torch.Tensor:
    """Lane pass of ``x`` [rows, n_in*C] (u8, u16 or float32) -> float32
    [rows, n_out*C].  A CUDA tensor launches the kernel; a CPU tensor
    runs the plain version."""
    if on_cpu(x, ops.device):
        return apply_lanes_reference(ops, x)
    check_input(ops, x)
    lop = ops.lop
    rows = x.shape[0]
    out = torch.empty((rows, lop.n_out * lop.c), dtype=torch.float32, device=x.device)
    LAUNCH.launch(
        x, launches, ops.launch_key, x.data_ptr(), out.data_ptr(), _IN_KINDS[x.dtype], rows,
        packed=ops.packed,
    )
    return out
