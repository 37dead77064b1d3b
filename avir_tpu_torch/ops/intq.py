"""Fixed-point limb quantization of banded-operator taps for the int8
route.

8-bit images are EXACT as s8 after a -128 shift, so integer-in /
8-bit-out pipelines run the whole resize as s8 x s8 -> s32 products.
Taps are quantized to a two-limb radix-128 fixed-point form

    Q = round(taps * 2^shift)         (s32, |Q| <= 127*128 + 63)
    Q = q1 * 128 + q0                 (q1, q0 exact s8 limbs)

so ``A @ x == ((q1 @ x) << 7) + (q0 @ x)) * 2^-shift`` exactly up to
the tap rounding (~14 significant bits -- more tap precision than the
reference's own float32 arithmetic guarantees at 8-bit output,
avir.h:4603).  The u8 -> s8 input shift is compensated with the row-sum
of Q (a per-output constant), and the inter-pass intermediate is
re-quantized on chip to a 15-bit two-limb form (see
ops/cuda/fused_kernel.py).  Copied from the JAX package's ops/intq.py.
"""

from __future__ import annotations

import numpy as np

# Largest |Q| representable by balanced radix-128 limbs with q1 in
# [-127, 127] and q0 in [-64, 63].
_Q_MAX = 127 * 128 + 63


def pick_shift(max_abs: float, cap: int = 14) -> int:
    """Largest shift keeping round(max_abs * 2^shift) within _Q_MAX.

    May be NEGATIVE for very large taps (e.g. float-in -> u16-out
    plans fold the 65535x range scaling into the taps): the limb form
    stays exact-by-construction and the int8 feasibility gates
    (int8_feasible / _int8_x_shift) reject such operators downstream —
    clamping at 0 here instead made quantize_limbs raise and took the
    whole executor build down with it."""
    if max_abs <= 0.0:
        return cap
    return min(cap, int(np.floor(np.log2(_Q_MAX / max_abs))))


def quantize_limbs(
    taps: np.ndarray, shift: int | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """(q1, q0, shift): balanced radix-128 s8 limbs of round(taps*2^s).

    Exact reconstruction: q1.astype(i32) * 128 + q0.astype(i32)
    == round(taps * 2^shift).
    """
    taps = np.asarray(taps, dtype=np.float64)
    if shift is None:
        shift = pick_shift(float(np.max(np.abs(taps), initial=0.0)))
    # 2.0**shift, not 1 << shift: the shift may be NEGATIVE for taps
    # with folded-in range scaling (see pick_shift).
    q = np.round(taps * 2.0 ** shift).astype(np.int64)
    if np.any(np.abs(q) > _Q_MAX):  # pragma: no cover - pick_shift caps
        raise ValueError("tap magnitude overflows two s8 limbs")
    q1 = (q + 64) >> 7
    q0 = q - (q1 << 7)
    assert q1.min() >= -128 and q1.max() <= 127
    assert q0.min() >= -64 and q0.max() <= 63
    return q1.astype(np.int8), q0.astype(np.int8), shift


def first_pass_overflow_safe(
    q1: np.ndarray, q0: np.ndarray, contract_axis: int, x_max: int = 128
) -> bool:
    """True if ((q1 @ x) << 7) + (q0 @ x) + compensation stays in s32
    for |x| <= x_max (s8 inputs).  Real resize filters pass by orders
    of magnitude; this guards pathological taps."""
    s1 = np.abs(q1.astype(np.int64)).sum(axis=contract_axis).max()
    s0 = np.abs(q0.astype(np.int64)).sum(axis=contract_axis).max()
    bound = ((x_max * s1) << 7) + x_max * s0 + ((s1 << 7) + s0) * 128
    return bound < 2**31
