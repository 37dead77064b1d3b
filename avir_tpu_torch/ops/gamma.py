"""sRGB gamma conversion.

A copy of the JAX package's ``ops/gamma.py`` (the reference's polynomial
approximations of pow(x, 2.4) and pow(x, 1/2.4), avir.h:162-196), with:

  - the NumPy forms, the host oracle's (``srgb_to_linear_np``,
    ``linear_to_srgb_np``);
  - the PyTorch forms of ``srgb_to_linear_2d`` / ``linear_to_srgb_2d``
    (the rational forms, with the C=4 alpha lane mask), which the
    ``precision="exact"`` route applies around its passes;
  - the fused kernel K1's division-free forms as plain PyTorch functions,
    copied from the JAX package's ``ops/pallas/fused_kernel.py:40-127``:
    the degree-9 float32 linearization (``_srgb_to_linear``, split
    modes), the degree-7 u8-grid polynomial quantized to 13-bit linear
    light (``_srgb_to_linear13_u8poly``, int8 mode), ``_linear_to_srgb``
    and ``_int8_limbs``.  The plain versions of K1 call them, and the
    CUDA kernels repeat their arithmetic step for step.

Rounding of the kernel forms.  The JAX package's kernel, as XLA compiles
it on the CPU (interpret mode), contracts each ``a * b + c`` of these
forms into one fused multiply-add; the port writes those FMAs out
(``fma32`` here, ``__fmaf_rn`` in the kernels) and every other step as a
single float32 operation, so the three agree bit for bit.  ``fma32``
computes in float64: the product of two float32 values is exact there,
and the one float64 rounding of the sum before the float32 one differs
from a true FMA only when it lands exactly on a float32 midpoint (about
2^-29 of cases).
"""

from __future__ import annotations

import numpy as np
import torch


def _pow24_srgb(x):
    """Approximation of x**2.4 for x in ~[0.09, 1] (avir.h:162-174)."""
    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2
    return (
        0.0985766365536824
        + 0.839474952656502 * x2
        + 0.363287814061725 * x3
        - 0.0125559718896615 / (0.12758338921578 + 0.290283465468235 * x)
        - 0.231757513261358 * x
        - 0.0395365717969074 * x4
    )


# The coefficients of _pow24i_srgb, in its order of evaluation.
_POW24I_COEF = (
    0.000213364515060263,
    0.0149409239419218,
    0.433973412731747,
    0.659628181609715,
    0.0380957908841466,
    0.0706476137208521,
)


def _pow24i_srgb(x, sqrt):
    """Approximation of x**(1/2.4) for x in ~[0.003, 1]
    (avir.h:185-196)."""
    c0, c1, c2, c3, c4, c5 = _POW24I_COEF
    sx = sqrt(x)
    ssx = sqrt(sx)
    sssx = sqrt(ssx)
    return c0 + c1 * x + c2 * sx + ssx * (c3 * sssx - c4 - c5 * sx)


def srgb_to_linear_np(s: np.ndarray, alpha_index: int = -1) -> np.ndarray:
    """convertSRGB2Lin (avir.h:208-220); s pre-scaled to [0, 1].

    alpha_index 0 or 3 bypasses the conversion for that channel of
    4-channel data (linear scaling only)."""
    lin = np.where(
        s <= 0.04045, s / 12.92, _pow24_srgb((s + 0.055) / 1.055)
    )
    if alpha_index in (0, 3) and s.ndim >= 1 and s.shape[-1] == 4:
        lin = lin.copy()
        lin[..., alpha_index] = s[..., alpha_index]
    return lin


def linear_to_srgb_np(s: np.ndarray, alpha_index: int = -1) -> np.ndarray:
    """convertLin2SRGB (avir.h:299-310)."""
    # The approximation branch only applies above 0.0031308; clamp its
    # argument so the unselected branch never evaluates sqrt of a
    # negative value.
    srgb = np.where(
        s <= 0.0031308,
        12.92 * s,
        1.055 * _pow24i_srgb(np.maximum(s, 0.0031308), np.sqrt) - 0.055,
    )
    if alpha_index in (0, 3) and s.ndim >= 1 and s.shape[-1] == 4:
        srgb = srgb.copy()
        srgb[..., alpha_index] = s[..., alpha_index]
    return srgb


def _alpha_mask(x: torch.Tensor, c: int, alpha_index: int):
    """[1, lanes] bool: the alpha lanes of interleaved [rows, W*C] data,
    or None when no lane bypasses the conversion."""
    if alpha_index not in (0, 3) or c != 4:
        return None
    return (torch.arange(x.shape[1], device=x.device) % c == alpha_index)[None, :]


def srgb_to_linear_2d(x: torch.Tensor, c: int, alpha_index: int = -1) -> torch.Tensor:
    """The rational sRGB -> linear form on float32 [rows, W*C] data; the
    alpha lane of 4-channel data passes through."""
    lin = torch.where(
        x <= 0.04045, x / 12.92, _pow24_srgb((x + 0.055) / 1.055)
    )
    mask = _alpha_mask(x, c, alpha_index)
    return lin if mask is None else torch.where(mask, x, lin)


def linear_to_srgb_2d(x: torch.Tensor, c: int, alpha_index: int = -1) -> torch.Tensor:
    srgb = torch.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * _pow24i_srgb(torch.clamp_min(x, 0.0031308), torch.sqrt) - 0.055,
    )
    mask = _alpha_mask(x, c, alpha_index)
    return srgb if mask is None else torch.where(mask, x, srgb)


# ---------------------------------------------------------------------------
# K1's in-kernel forms
# ---------------------------------------------------------------------------

# Degree-9 least-squares fit (power form) of the reference's rational
# pow24 sRGB segment over s in [0.04045, 1], division-free: f32-Horner
# max |err| 2.8e-7 in linear light (fused_kernel.py:45-66 there).
_F32_LIN_COEF = (
    0.0008536138646303981,
    0.035465890603903136,
    0.48196428400734187,
    0.8900508390762532,
    -0.9850409244814118,
    1.257590813503784,
    -1.2337517794771542,
    0.820447767639579,
    -0.32497847508180217,
    0.05739567406964825,
)

# Input-linearization scale of the int8 gamma path: round(lin * 2^13)
# <= 8192 fits two s8 limbs (fused_kernel.py:98-102 there).
GAMMA_IN_BITS = 13

# Degree-7 fit of the reference's pow(x, 2.4) segment over the 245 u8
# sample points above the linear cutoff (fused_kernel.py:104-114 there).
_U8_LIN_COEF = (
    0.0008849456939997724, 0.034331778643864906, 0.4967742755734233,
    0.7946677002602778, -0.6398338110899012, 0.5113014176950982,
    -0.2526727088789862, 0.05454610085971551,
)


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else v


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add); see the
    module docstring.  Scalars must be float32 values (``f32``)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """IEEE float32 square root: through float64, rounded once to
    float32 (PyTorch's float32 ``sqrt`` on the CPU is not always
    correctly rounded)."""
    return torch.sqrt(x.double()).float()


def _horner(x: torch.Tensor, coef, k: float = 1.0) -> torch.Tensor:
    acc = torch.full_like(x, f32(coef[-1] * k))
    for a in coef[-2::-1]:
        acc = fma32(acc, x, f32(a * k))
    return acc


def _srgb_to_linear(x: torch.Tensor, c: int, alpha_index: int) -> torch.Tensor:
    """K1's split-mode pack stage on float32 [rows, lanes] in [0, 1]."""
    lin = torch.where(
        x <= f32(0.04045), x * f32(1.0 / 12.92), _horner(x, _F32_LIN_COEF)
    )
    mask = _alpha_mask(x, c, alpha_index)
    return lin if mask is None else torch.where(mask, x, lin)


def _srgb_to_linear13_u8poly(x: torch.Tensor, c: int, alpha_index: int) -> torch.Tensor:
    """round(srgb_to_linear(x) * 2^13) as int32, for float32 x on the u8
    grid in [0, 1] (round half to even); the 2^13 scale is folded into
    the coefficients."""
    k = float(1 << GAMMA_IN_BITS)
    lin = torch.where(
        x <= f32(0.04045), x * f32(k / 12.92), _horner(x, _U8_LIN_COEF, k)
    )
    mask = _alpha_mask(x, c, alpha_index)
    if mask is not None:
        lin = torch.where(mask, x * k, lin)
    return torch.round(lin).to(torch.int32)


def gamma_q13_table(in_gamma_mult: float) -> torch.Tensor:
    """int32 [2, 256]: ``_srgb_to_linear13_u8poly`` of every u8 value
    times ``in_gamma_mult``, row 0 for a colour lane and row 1 for the
    alpha lane.  K1 int8 reads its linearization from this table
    (``k1::fill_q13_table`` in csrc/k1_common.cuh), so a lookup gives the
    function's own bits."""
    x = torch.arange(256, dtype=torch.float32) * f32(in_gamma_mult)
    # Lanes 0..2 of each group of 4 are colour lanes, lane 3 the alpha lane.
    q = _srgb_to_linear13_u8poly(x.repeat_interleave(4)[None, :], 4, 3)
    q = q.reshape(256, 4)
    return torch.stack([q[:, 0], q[:, 3]])


def _linear_to_srgb(x: torch.Tensor, c: int, alpha_index: int) -> torch.Tensor:
    """K1's unpack stage on float32 [rows, lanes]: the reference's
    _pow24i_srgb form with IEEE square roots."""
    c0, c1, c2, c3, c4, c5 = (f32(v) for v in _POW24I_COEF)
    xm = torch.clamp_min(x, f32(0.0031308))
    sx = sqrt32(xm)
    ssx = sqrt32(sx)
    sssx = sqrt32(ssx)
    t = fma32(c1, xm, c0)
    t = fma32(c2, sx, t)
    u = fma32(c3, sssx, -c4)
    u = fma32(-c5, sx, u)
    r = fma32(ssx, u, t)
    srgb = torch.where(
        x <= f32(0.0031308), x * f32(12.92), fma32(f32(1.055), r, -f32(0.055))
    )
    mask = _alpha_mask(x, c, alpha_index)
    return srgb if mask is None else torch.where(mask, x, srgb)


def _int8_limbs(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Balanced radix-128 limbs of an integer tensor (exact:
    q == q1 * 128 + q0, |q0| <= 64)."""
    q1 = (q + 64) >> 7
    return q1, q - (q1 << 7)
