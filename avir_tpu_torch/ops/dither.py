"""Output-conditioning (dither) ops, device side.

Counterpart of the JAX package's ``ops/dither.py``:
  - default: round + clamp (+ bit-depth truncation by ``trunc_mul``), the
    reference's default ditherer (avir.h:4351-4427);
  - error diffusion: the reference's errdiff ditherer (avir.h:4440-4525)
    with its weights (current row right 0.364842; next row left 0.207305,
    center 0.364842, right 0.063011), in the anti-diagonal wavefront
    formulation of ``errdiff_dither_wavefront_jnp``: its entry
    (``errdiff_wavefront``), its plain version and its CUDA kernel (K4)
    live in ``ops/cuda/wavefront.py``.
"""

from __future__ import annotations

import torch

W_CUR_RIGHT = 0.364842
W_NEXT_LEFT = 0.207305
W_NEXT_CENTER = 0.364842
W_NEXT_RIGHT = 0.063011


def round_biased(v: torch.Tensor) -> torch.Tensor:
    """The reference's typecast round: half away from zero via truncation
    (avir.h:130-135)."""
    return torch.where(v >= 0, torch.floor(v + 0.5), -torch.floor(0.5 - v))


def trunc_mul(trunc_bits: int, out_max: float) -> float:
    out_range = int(out_max)
    return out_max / (out_range >> trunc_bits) if trunc_bits > 0 else 1.0


def default_dither(
    v: torch.Tensor, trunc_bits: int, out_max: float
) -> torch.Tensor:
    """Round + clamp (+ optional bit-depth truncation) of a float32 image,
    avir.h:4392-4419.  Non-negative-range rounding is plain floor(v+.5)."""
    if trunc_bits > 0:
        tm = torch.tensor(
            trunc_mul(trunc_bits, out_max), dtype=torch.float32, device=v.device
        )
        v = torch.floor(v / tm + 0.5) * tm
    else:
        v = torch.floor(v + 0.5)
    return torch.clamp(v, 0.0, out_max)

