"""K5: the linearize-once sRGB prologue, its wrapper and its plain PyTorch
version.

Counterpart of the JAX package's ``ops/pallas/gamma_prologue.py``
(``apply_gamma_prologue`` -> ``_kernel``).  The kernel
(``csrc/gamma_prologue.cu``) linearizes a u8 sRGB image [rows, lanes]
once: ``x * in_gamma_mult`` through K1's 13-bit u8-grid polynomial (the
C = 4 alpha lane only scaled), split into two balanced radix-128 s8 limb
planes.  K1 int8 reads the planes in place of the image
(``fused_kernel.py``, ``prepare_fused_int8(gamma_pre=True)``), so the
polynomial runs once per pixel instead of once per staging.

The planes are [rows_p, lanes_p] with rows_p = max(rows, need_rows) and
lanes_p = max(lanes, need_lanes) rounded up to a multiple of 16 (the
kernel stores 16 lanes at a time), zero past the image: K1 reads rows up
to the V operator's ``n_in_pad`` and lanes up to the lane operator's
``lanes_pad``.  (The TPU kernel's 256 x 1536 block padding is its own
layout and is not carried.)  The kernel reads the image by 16-byte loads
where ``load_path`` says "vector" and byte by byte elsewhere, and
linearizes from a shared table of K1's q13 values.

``apply_gamma_prologue`` launches the kernel on a CUDA tensor and runs
``apply_gamma_prologue_reference`` on a CPU tensor; the two are
bit-equal (the same float32 steps and fused multiply-adds).
"""

from __future__ import annotations

import torch

from ..gamma import _int8_limbs, _srgb_to_linear13_u8poly, f32
from .launch import F, I, P, Entry

# Launches of this kernel, counted by the wrapper.
launches = {"gamma_prologue": 0}


def plane_shape(
    rows: int, lanes: int, need_rows: int, need_lanes: int
) -> tuple[int, int]:
    """(rows_p, lanes_p) of the limb planes."""
    return max(rows, need_rows), -(-max(lanes, need_lanes) // 16) * 16


def alpha_lane(c: int, alpha_index: int) -> int:
    """The lane (lane % 4) that bypasses linearization, or -1."""
    return alpha_index if c == 4 and alpha_index in (0, 3) else -1


def load_path(x: torch.Tensor) -> str:
    """How the kernel reads the image ``x`` [rows, lanes]: "vector" (one
    16-byte load per 16 lanes) when every row starts 16-byte aligned, else
    "byte"."""
    lanes = x.shape[1]
    return "vector" if lanes % 16 == 0 and x.data_ptr() % 16 == 0 else "byte"


def apply_gamma_prologue_reference(
    x: torch.Tensor, need_rows: int, need_lanes: int, c: int,
    alpha_index: int, in_gamma_mult: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch prologue: u8 [rows, lanes] -> s8 limb planes (hi, lo)
    [rows_p, lanes_p]."""
    rows, lanes = x.shape
    rows_p, lanes_p = plane_shape(rows, lanes, need_rows, need_lanes)
    xf = torch.zeros((rows_p, lanes_p), dtype=torch.float32, device=x.device)
    xf[:rows, :lanes] = x.to(torch.int32).float()
    q = _srgb_to_linear13_u8poly(xf * f32(in_gamma_mult), c, alpha_index)
    hi, lo = _int8_limbs(q)
    return hi.to(torch.int8), lo.to(torch.int8)


# avir_gamma_prologue (csrc/gamma_prologue.cu).
LAUNCH = Entry("gamma_prologue", "avir_gamma_prologue", params=(
    ("x", P), ("rows", I), ("lanes", I), ("hi", P), ("lo", P), ("rows_p", I), ("lanes_p", I),
    ("alpha_lane", I), ("in_gamma_mult", F), ("vec", I), ("stream", P),
))


def apply_gamma_prologue(
    x: torch.Tensor, need_rows: int, need_lanes: int, c: int,
    alpha_index: int, in_gamma_mult: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 [rows, lanes] -> s8 limb planes (hi, lo) [rows_p, lanes_p] of
    round(linear * 2^13).  A CUDA tensor launches the kernel; a CPU
    tensor runs the plain version."""
    if x.device.type == "cpu":
        return apply_gamma_prologue_reference(
            x, need_rows, need_lanes, c, alpha_index, in_gamma_mult
        )
    if x.device.type != "cuda":
        raise ValueError(f"image on {x.device}: must be a CUDA or CPU tensor")
    if x.dtype != torch.uint8 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"expected a contiguous u8 [rows, lanes], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    rows, lanes = x.shape
    rows_p, lanes_p = plane_shape(rows, lanes, need_rows, need_lanes)
    hi = torch.empty((rows_p, lanes_p), dtype=torch.int8, device=x.device)
    lo = torch.empty_like(hi)
    LAUNCH.launch(
        x, launches, "gamma_prologue", x.data_ptr(), rows, lanes, hi.data_ptr(), lo.data_ptr(),
        rows_p, lanes_p, alpha_lane(c, alpha_index), f32(in_gamma_mult),
        int(load_path(x) == "vector"),
    )
    return hi, lo
