"""Host-side (NumPy, float64) execution of a ResizePlan.

A copy of the JAX package's ``models/host_reference.py``: the semantics
specification for the device kernels, slow but exact.  Tests and
``chip_smoke.py`` hold the port's outputs to it.  ``execute_plan_numpy``
and ``execute_lancir_numpy`` are also the public ``precision="f64"`` /
``engine="host"`` routes (``models/avir.py``, ``models/lancir.py``).
"""

from __future__ import annotations

import numpy as np

from ..ops.gamma import linear_to_srgb_np, srgb_to_linear_np
from ..plan.compose import apply_banded_numpy
from ..plan.plan import ResizePlan


def round_half_up(v: np.ndarray) -> np.ndarray:
    """The reference's typecast-based rounding (avir.h:130-135) for the
    non-negative range that survives clamping."""
    return np.floor(v + 0.5)


def default_dither(
    v: np.ndarray, trunc_bits: int, out_max: float
) -> np.ndarray:
    """Round + clamp (+ optional bit-depth truncation), the default
    ditherer (avir.h:4392-4419)."""
    if trunc_bits > 0:
        out_range = int(out_max)
        tr_mul = out_max / (out_range >> trunc_bits)
        v = round_half_up(v / tr_mul) * tr_mul
    else:
        v = round_half_up(v)
    return np.clip(v, 0.0, out_max)


def errdiff_dither(
    img: np.ndarray, trunc_bits: int, out_max: float
) -> np.ndarray:
    """Error-diffusion dither (avir.h:4485-4525), serial scan semantics.

    img is [H, W, C] float; weights: current row right 0.364842; next row
    left 0.207305, center 0.364842, right 0.063011.  The scan runs on
    Python floats (IEEE doubles, the same arithmetic as NumPy float64
    scalars, several times faster).
    """
    h, w, c = img.shape
    out_range = int(out_max)
    tr_mul = out_max / (out_range >> trunc_bits) if trunc_bits > 0 else 1.0
    tr_mul_i = 1.0 / tr_mul

    buf = img.astype(np.float64).reshape(h, w * c)
    n = w * c
    carry = [0.0] * (n + c)  # next-row diffusion
    out = np.empty_like(buf)

    for y in range(h):
        row = [b + d for b, d in zip(buf[y].tolist(), carry[c:])]
        carry = [0.0] * (n + c)
        out_row = [0.0] * n
        for j in range(n):
            v = row[j]
            z0 = math_round(v * tr_mul_i) * tr_mul
            noise = v - z0
            out_row[j] = min(max(z0, 0.0), out_max)
            nm1 = noise * 0.364842
            if j + c < n:
                row[j + c] += nm1
                carry[c + j + c] += noise * 0.063011
            carry[j] += noise * 0.207305  # maps to j - c in next row
            carry[c + j] += nm1
        out[y] = out_row
    return out.reshape(h, w, c)


def math_round(d: float) -> float:
    # Biased typecast rounding (avir.h:130-135).
    return -float(int(0.5 - d)) if d < 0 else float(int(d + 0.5))


def execute_plan_numpy(
    plan: ResizePlan,
    src: np.ndarray,
    errdiff: bool = False,
    return_predither: bool = False,
) -> np.ndarray:
    """Run a full resize on the host. src is [H, W, C] of the planned
    input dtype; returns [new_h, new_w, C] of the output dtype.

    ``return_predither=True`` returns the float64 image after gamma-out
    but before the dither/quantize stage."""
    x = src.astype(np.float64)

    if plan.use_srgb_gamma:
        x = srgb_to_linear_np(x * plan.in_gamma_mult, plan.alpha_index)

    # Horizontal pass over axis 1.
    x = np.moveaxis(x, 1, 0)  # [W, H, C]
    x = apply_banded_numpy(plan.h.op, x)
    x = np.moveaxis(x, 0, 1)  # [H, new_w, C]
    # Vertical pass over axis 0.
    x = apply_banded_numpy(plan.v.op, x)

    if plan.use_srgb_gamma:
        x = linear_to_srgb_np(x, plan.alpha_index) * (
            plan.out_gamma_mult if plan.out_gamma_mult != 0.0 else 1.0
        )

    if plan.is_out_float:
        return x.astype(np.float64 if plan.out_float64 else np.float32)
    if return_predither:
        return x

    out_bits = 8 if plan.out_type_max == 255.0 else 16
    trunc_bits = out_bits - plan.res_bit_depth
    if errdiff:
        x = errdiff_dither(x, trunc_bits, plan.out_type_max)
    else:
        x = default_dither(x, trunc_bits, plan.out_type_max)
    dtype = np.uint8 if out_bits == 8 else np.uint16
    return x.astype(dtype)


def execute_plan_rows_numpy(
    plan: ResizePlan, src: np.ndarray, rows
) -> np.ndarray:
    """Float64 oracle for a subset of output rows: equal to
    ``execute_plan_numpy(plan, src)[rows]``, in the caller's row order,
    at a cost that scales with ``len(rows)`` (only the input rows that feed
    them go through the horizontal pass).  Default dither only: error
    diffusion carries a whole-image recurrence."""
    rows = np.asarray(rows, dtype=np.int64)
    vop = plan.v.op
    idx = (
        vop.starts[rows].astype(np.int64)[:, None]
        + np.arange(vop.width)[None, :]
    )
    need = np.unique(idx.ravel())
    x = src[need].astype(np.float64)
    if plan.use_srgb_gamma:
        x = srgb_to_linear_np(x * plan.in_gamma_mult, plan.alpha_index)
    x = np.moveaxis(x, 1, 0)  # [W, len(need), C]
    x = apply_banded_numpy(plan.h.op, x)
    x = np.moveaxis(x, 0, 1)  # [len(need), new_w, C]

    # Vertical pass on the sampled rows, starts remapped into ``need``.
    pos = np.searchsorted(need, idx.ravel()).reshape(idx.shape)
    x = np.einsum("ow,owrc->orc", vop.taps[rows], x[pos])

    if plan.use_srgb_gamma:
        x = linear_to_srgb_np(x, plan.alpha_index) * (
            plan.out_gamma_mult if plan.out_gamma_mult != 0.0 else 1.0
        )
    if plan.is_out_float:
        return x.astype(np.float64 if plan.out_float64 else np.float32)
    out_bits = 8 if plan.out_type_max == 255.0 else 16
    x = default_dither(x, out_bits - plan.res_bit_depth, plan.out_type_max)
    return x.astype(np.uint8 if out_bits == 8 else np.uint16)


def execute_lancir_numpy(plan, src: np.ndarray) -> np.ndarray:
    """Float64 host execution of a LancirPlan, the LANCIR analog of
    ``execute_plan_numpy`` and the compute path behind the public
    ``precision="f64"`` tier (the reference templates the whole LANCIR
    pipeline on T = double, lancir.h:386-390).

    src is [H, W, C] of the planned input dtype; returns
    [new_h, new_w, C] in the planned output representation (float64 for
    float outputs, round-half-even quantized ints otherwise, matching
    the reference's nearest-even output conversions,
    lancir.h:1870-2002)."""
    x = src.astype(np.float64)
    x = np.moveaxis(x, 1, 0)  # [W, H, C]
    x = apply_banded_numpy(plan.h, x)
    x = np.moveaxis(x, 0, 1)  # [H, new_w, C]
    x = apply_banded_numpy(plan.v, x)
    if plan.out_mul != 1.0:
        x = x * plan.out_mul
    if plan.is_out_float:
        return x
    # np.rint is round-half-even, like the SIMD cvt instructions the
    # reference's outputScanline relies on.
    x = np.clip(np.rint(x), 0.0, plan.clamp)
    return x.astype(np.uint8 if plan.clamp == 255.0 else np.uint16)
