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

import ctypes
import dataclasses

import numpy as np
import torch

from ..banded import BLOCKED_MODES, BlockedBandedOp, apply_blocked
from .fused_kernel import _k_ranges

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


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [
    _I, _I,            # mode, in_kind
    _P, _I, _I,        # x, n_in, r
    _P, _I,            # out, n_out
    _P, _P, _P,        # hi, lo, offs
    _I, _I, _I,        # b, t, w
    _P, _I,            # k_range, n_slices
    _P,                # stream
]


def _library():
    from .build import load_library

    fn = load_library("banded").avir_banded
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def apply_banded(ops: BandedOperands, x: torch.Tensor) -> torch.Tensor:
    """Row pass of ``x`` [n_in, R] (u8, u16 or float32) -> float32
    [n_out, R].  A CUDA tensor launches the kernel; a CPU tensor runs the
    plain version."""
    if x.device.type == "cpu" and ops.device.type == "cpu":
        return apply_banded_reference(ops, x)
    if x.device.type != "cuda" or x.device != ops.device:
        raise ValueError(
            f"image on {x.device}, operands on {ops.device}: both must be "
            "on one CUDA device (or both on the CPU)"
        )
    if x.dtype not in _IN_KINDS or x.dim() != 2 or x.shape[0] != ops.bop.n_in:
        raise ValueError(
            f"expected u8/u16/f32 [{ops.bop.n_in}, R], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("image must be contiguous")
    b, t, w = ops.hi.shape
    n_slices = ops.k_range.shape[1]
    r = x.shape[1]
    if b * n_slices > 65535:
        raise ValueError("too many output row blocks for one launch")
    out = torch.empty((ops.bop.n_out, r), dtype=torch.float32, device=x.device)
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            _MODES[ops.mode], _IN_KINDS[x.dtype],
            x.data_ptr(), x.shape[0], r,
            out.data_ptr(), ops.bop.n_out,
            ops.hi.data_ptr(), ops.lo.data_ptr(), ops.offs.data_ptr(),
            b, t, w,
            ops.k_range.data_ptr(), n_slices,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"banded launch failed: CUDA error {err}")
    launches[ops.launch_key] += 1
    return out
