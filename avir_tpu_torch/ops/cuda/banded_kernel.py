"""K2: the row-contracting banded pass, its wrapper and its plain PyTorch
version.

Counterpart of the JAX package's ``ops/pallas/banded_kernel.py``
(``apply_blocked_pallas`` -> ``_kernel``).  The kernel
(``csrc/banded.cu``) applies a blocked banded operator (ops/banded.py)
along the rows of an image [n_in, R] of u8, u16 or float32, converted as
it is staged, and writes float32 [n_out, R]: ``out[b*T:(b+1)*T] =
taps[b] @ x[offs[b] : offs[b] + W]`` in mode "split2", "split3" (the
bf16 hi/lo taps against the input's bf16 split) or "exact" (the float32
sum of the hi/lo taps against the input, as the bf16 products of the two
tap planes and the input's exact bf16 limbs: one for u8, two for u16,
three for float32).  Every mode runs on the bf16 tensor cores at
``SPLIT_ROWS``-row slices and visits only each slice's nonzero tap rows.
Exact's products are exact; only the order of its float32 sums differs
from a float32 multiply-add loop.

``apply_banded`` launches the kernel on a CUDA tensor and runs
``apply_banded_reference`` (``ops/banded.py:apply_blocked`` on the same
taps) on a CPU tensor.  The two sum in other orders, so they agree within
max|plain| * 1e-5 in every mode, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..banded import BLOCKED_MODES, BlockedBandedOp, apply_blocked
from .fused_kernel import _k_ranges
from .launch import I, P, Entry, on_cpu

# Launches of each mode of this kernel, counted by the wrapper.
launches = {f"banded_{m}": 0 for m in ("split2", "split3", "exact")}

_MODES = {"split2": 0, "split3": 1, "exact": 2}
_IN_KINDS = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
# Output rows per thread block in every mode (csrc: kRows).
SPLIT_ROWS = 64
# The bf16 limbs that sum back to an input value exactly, which exact
# multiplies by both tap planes (csrc: the NX of each exact launch).
EXACT_LIMBS = {torch.uint8: 1, torch.uint16: 2, torch.float32: 3}


@dataclasses.dataclass(frozen=True)
class BandedOperands:
    """Device-resident operands of one row pass."""

    bop: BlockedBandedOp
    mode: str
    offs: torch.Tensor     # int32 [B]
    hi: torch.Tensor       # bf16 [B, T, W]
    lo: torch.Tensor
    k_range: torch.Tensor  # int32 [B, n_slices, 2] nonzero tap rows of each slice

    @property
    def rows(self) -> int:
        """Output rows per slice (thread block) of the kernel."""
        return SPLIT_ROWS

    @property
    def device(self) -> torch.device:
        return self.hi.device

    @property
    def launch_key(self) -> str:
        return f"banded_{self.mode}"

    @functools.cached_property
    def packed(self) -> tuple:
        """The kernel's arguments fixed for these operands (LAUNCH.pack)."""
        b, t, w = self.hi.shape
        n_slices = self.k_range.shape[1]
        if b * n_slices > 65535:
            raise ValueError("too many output row blocks for one launch")
        return LAUNCH.pack(
            self, self.bop, mode=_MODES[self.mode], b=b, t=t, w=w, n_slices=n_slices,
        )


def prepare_banded(
    bop: BlockedBandedOp, mode: str, device: torch.device | str
) -> BandedOperands:
    """Operands of the row pass by ``bop`` in ``mode`` on ``device``."""
    if mode not in BLOCKED_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    k_range = _k_ranges(
        (bop.taps_hi != 0).numpy(), (bop.taps_lo != 0).numpy(), SPLIT_ROWS
    )
    return BandedOperands(
        bop=bop,
        mode=mode,
        offs=torch.from_numpy(bop.offs.astype(np.int32)).to(device),
        hi=bop.taps_hi.to(device).contiguous(),
        lo=bop.taps_lo.to(device).contiguous(),
        k_range=torch.from_numpy(k_range).to(device),
    )


def apply_banded_reference(ops: BandedOperands, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch row pass: ``apply_blocked`` on the kernel's taps ("exact"
    takes hi + lo in float32, as the kernel does)."""
    hi, lo = ops.hi.to(x.device), ops.lo.to(x.device)
    taps = hi.float() + lo.float() if ops.mode == "exact" else (hi, lo)
    return apply_blocked(ops.bop, x, ops.mode, taps=taps)


# avir_banded (csrc/banded.cu).
LAUNCH = Entry("banded", "avir_banded", params=(
    ("x", P), ("out", P), ("in_kind", I), ("r", I), ("stream", P),
    ("mode", I), ("n_in", I), ("n_out", I), ("hi", P), ("lo", P), ("offs", P),
    ("b", I), ("t", I), ("w", I), ("k_range", P), ("n_slices", I),
))


def apply_banded(ops: BandedOperands, x: torch.Tensor) -> torch.Tensor:
    """Row pass of ``x`` [n_in, R] (u8, u16 or float32) -> float32
    [n_out, R].  A CUDA tensor launches the kernel; a CPU tensor runs the
    plain version."""
    if on_cpu(x, ops.device):
        return apply_banded_reference(ops, x)
    if x.dtype not in _IN_KINDS or x.dim() != 2 or x.shape[0] != ops.bop.n_in:
        raise ValueError(
            f"expected u8/u16/f32 [{ops.bop.n_in}, R], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("image must be contiguous")
    r = x.shape[1]
    out = torch.empty((ops.bop.n_out, r), dtype=torch.float32, device=x.device)
    LAUNCH.launch(
        x, launches, ops.launch_key, x.data_ptr(), out.data_ptr(), _IN_KINDS[x.dtype], r,
        packed=ops.packed,
    )
    return out
