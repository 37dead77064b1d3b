"""Resize-plan orchestration.

Equivalent of the planning half of CImageResizer::resizeImage
(avir.h:4680-4954): resolves per-axis stepping and
offsets, searches build modes with the analytic complexity model, builds
the real filtering steps for both axes (with the reference's
V-pass-reuse + correction-DC-rescale rule), and composes each axis's
chain into a single banded operator ready for the device kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..params import Params, PARAMS_DEF
from .complexity import bank_init_complexity, calc_complexity, used_frac_map
from .compose import BandedOp, compose_steps
from .geometry import update_step_buffers
from .steps import BankManager, FilterStep, build_filter_steps


@dataclasses.dataclass
class AxisPlan:
    op: BandedOp
    build_mode: int
    k: float
    o: float


@dataclasses.dataclass
class ResizePlan:
    h: AxisPlan
    v: AxisPlan
    src_w: int
    src_h: int
    new_w: int
    new_h: int
    el_count: int
    use_srgb_gamma: bool
    in_gamma_mult: float
    out_gamma_mult: float
    alpha_index: int
    is_in_float: bool
    is_out_float: bool
    in_type_max: float  # 255/65535 for integer inputs, 0 for float
    out_type_max: float
    res_bit_depth: int
    # float64 output requested (the reference's fptype=double mode,
    # avir.h:4569-4592): the host route computes and returns f64; the
    # device route computes f32 (no f64 device compute) and the
    # driver restores the dtype.
    out_float64: bool = False


def _resolve_k_o(
    k: float, src: int, new: int, o: float
) -> tuple[float, float]:
    """Per-axis step/offset resolution (avir.h:4709-4736)."""
    if k == 0.0:
        ka = src / new
        return ka, o + (ka - 1.0) * 0.5
    if k > 0.0:
        return k, o + (k - 1.0) * 0.5
    return -k, o


def _mark_created(banks: BankManager, fs: FilterStep) -> None:
    """Record which fractional filters a real build creates: filter 0 (the
    correction-filter response probe) plus every rpos fti; order-1 creation
    also fills the next filter (avir.h:1814-1846)."""
    created = banks.created[fs.bank_key]
    accessed = np.unique(np.concatenate(([0], fs.fti)))
    created[accessed] = True
    if fs.bank.order > 0:
        created[np.minimum(accessed + 1, fs.bank.frac_count)] = True


def _copy_steps_for_reuse(steps: list[FilterStep]) -> list[FilterStep]:
    out = []
    for fs in steps:
        out.append(dataclasses.replace(fs))
    return out


def _rescale_correction(steps: list[FilterStep], m: float) -> None:
    """modifyCorrFilterDCGain (avir.h:6137-6157)."""
    last = steps[-1]
    target = (
        last
        if (not last.is_upsample and last.resample_factor == 1)
        else steps[0]
    )
    target.flt = (target.flt.astype(np.float64) * m).astype(np.float32)


def _model_cost(
    banks: BankManager,
    mode: int,
    k: float,
    o: float,
    src_len: int,
    new_len: int,
    dc_gain: float,
    params: Params,
    el_count: int,
    scanline_count: int,
    h_real_key: Optional[tuple],
) -> int:
    steps, rs = build_filter_steps(k, banks, dc_gain, mode, params, True)
    _, _, is_resize2 = update_step_buffers(steps, rs, k, o, src_len, new_len)
    used = used_frac_map(steps[rs])
    key = steps[rs].bank_key

    if key == banks.fixed_key:
        bank_cost = 0
    elif h_real_key is not None and key == h_real_key:
        bank_cost = bank_init_complexity(
            banks, key, used, False, banks.created.get(key)
        )
    else:
        bank_cost = bank_init_complexity(banks, key, used, True, None)

    return calc_complexity(
        steps, rs, el_count, is_resize2, bank_cost, scanline_count
    )


def build_resize_plan(
    src_w: int,
    src_h: int,
    new_w: int,
    new_h: int,
    el_count: int,
    in_dtype: np.dtype,
    out_dtype: np.dtype,
    k: float = 0.0,
    ox: float = 0.0,
    oy: float = 0.0,
    params: Params = PARAMS_DEF,
    res_bit_depth: int = 8,
    src_bit_depth: int = 0,
    use_srgb_gamma: bool = False,
    alpha_index: int = -1,
    build_mode: int = -1,
) -> ResizePlan:
    in_dtype = np.dtype(in_dtype)
    out_dtype = np.dtype(out_dtype)
    if src_bit_depth == 0:
        src_bit_depth = res_bit_depth

    kx, ox = _resolve_k_o(k, src_w, new_w, ox)
    ky, oy = _resolve_k_o(k, src_h, new_h, oy)

    # Output multipliers (avir.h:4740-4782).
    is_in_float = in_dtype.kind == "f"
    is_out_float = out_dtype.kind == "f"
    in_max = 0.0 if is_in_float else (255.0 if in_dtype.itemsize == 1 else 65535.0)
    out_max = 0.0 if is_out_float else (255.0 if out_dtype.itemsize == 1 else 65535.0)

    if use_srgb_gamma:
        in_gamma_mult = 1.0 if is_in_float else 1.0 / in_max
        out_gamma_mult = 1.0 if is_out_float else out_max
        out_mul = 1.0
    else:
        in_gamma_mult = 0.0
        out_gamma_mult = 0.0
        out_mul = 1.0 if is_out_float else out_max
        if not is_in_float:
            out_mul /= in_max

    banks = BankManager(res_bit_depth, src_bit_depth, params)
    fixed_order = banks.frac_count_and_order(False)[1]
    build_mode_count = 4 if fixed_order == 0 else 2

    # ---- Horizontal pass -------------------------------------------------
    if build_mode >= 0:
        use_mode_h = build_mode
    else:
        best = None
        use_mode_h = 1
        for m in range(build_mode_count):
            c = _model_cost(
                banks, m, kx, ox, src_w, new_w, out_mul, params, el_count,
                src_h, None,
            )
            if best is None or c < best:
                best = c
                use_mode_h = m

    steps_h, rs_h = build_filter_steps(
        kx, banks, out_mul, use_mode_h, params, False
    )
    kh, oh, _ = update_step_buffers(steps_h, rs_h, kx, ox, src_w, new_w)
    _mark_created(banks, steps_h[rs_h])
    h_key = steps_h[rs_h].bank_key
    op_h = compose_steps(steps_h, src_w)

    # ---- Vertical pass ---------------------------------------------------
    if build_mode >= 0:
        use_mode_v = build_mode
    else:
        best = None
        use_mode_v = 1
        for m in range(build_mode_count):
            c = _model_cost(
                banks, m, ky, oy, src_h, new_h, 1.0, params, el_count,
                new_w, h_key,
            )
            if best is None or c < best:
                best = c
                use_mode_v = m

    if use_mode_v == use_mode_h and ky == kx:
        steps_v = _copy_steps_for_reuse(steps_h)
        rs_v = rs_h
        if out_mul != 1.0:
            _rescale_correction(steps_v, 1.0 / out_mul)
    else:
        steps_v, rs_v = build_filter_steps(
            ky, banks, 1.0, use_mode_v, params, False
        )
    kv, ov, _ = update_step_buffers(steps_v, rs_v, ky, oy, src_h, new_h)
    op_v = compose_steps(steps_v, src_h)

    return ResizePlan(
        h=AxisPlan(op=op_h, build_mode=use_mode_h, k=kh, o=oh),
        v=AxisPlan(op=op_v, build_mode=use_mode_v, k=kv, o=ov),
        src_w=src_w,
        src_h=src_h,
        new_w=new_w,
        new_h=new_h,
        el_count=el_count,
        use_srgb_gamma=use_srgb_gamma,
        in_gamma_mult=in_gamma_mult,
        out_gamma_mult=out_gamma_mult,
        alpha_index=alpha_index,
        is_in_float=is_in_float,
        is_out_float=is_out_float,
        in_type_max=in_max,
        out_type_max=out_max,
        res_bit_depth=res_bit_depth,
        out_float64=is_out_float and out_dtype.itemsize == 8,
    )
