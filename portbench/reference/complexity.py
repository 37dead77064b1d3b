"""Analytic complexity model used to pick the build mode.

Re-derivation of calcComplexity / fillUsedFracMap / calcInitComplexity
(avir.h:1895-1929,6167-6270).  The model scores the
reference's scanline-kernel MAC counts — not this framework's matmul
cost — because matching the reference's mode choice is what makes the
planned taps (and hence the output image) match at 8/16-bit tolerance.
"""

from __future__ import annotations

import numpy as np

from .steps import BankManager, FilterStep

FLT_INIT_COST = 65  # per-sample fractional-filter init cost (avir.h:1897)


def used_frac_map(fs: FilterStep) -> np.ndarray:
    """Boolean map of fractional filters used by the resize step
    (fillUsedFracMap, avir.h:6167-6183)."""
    used = np.zeros(fs.bank.frac_count + 1, dtype=bool)
    used[np.unique(fs.fti)] = True
    return used


def bank_init_complexity(
    banks: BankManager,
    key: tuple,
    used: np.ndarray,
    init_required: bool,
    created: np.ndarray | None,
) -> int:
    """calcInitComplexity (avir.h:1895-1929) for a bank in a given
    creation state."""
    order, wf_len2, wf_freq, alpha, frac_count, ext_params = key
    bank = banks.get_bank(key, None) if key in banks._banks else None
    if bank is None:
        raise RuntimeError("bank must be materialized before costing")
    ext_len = ext_params[1] if ext_params is not None else 0
    use_cost = bank.filter_len * order + bank.src_filter_len * ext_len

    if init_required:
        ic = frac_count * bank.src_filter_len * FLT_INIT_COST
        ic += use_cost * int(used[: frac_count].sum())
    else:
        if created is None:
            created = np.zeros(frac_count + 1, dtype=bool)
        ic = use_cost * int(
            (used[:frac_count] & ~created[:frac_count]).sum()
        )
    return ic


def calc_complexity(
    steps: list[FilterStep],
    resize_step: int,
    el_count: int,
    is_resize2: bool,
    bank_cost: int,
    scanline_count: int,
) -> int:
    """Per-scanline MAC-count model (calcComplexity, avir.h:6206-6270),
    interleaved packmode (fcnum/fcdenom = 3/4)."""
    s = 0
    s2 = 0

    for i, fs in enumerate(steps):
        s2 += 65 * fs.flt_cap

        if fs.is_upsample:
            if fs.flt_orig is not None:
                continue
            s += (
                fs.flt_cap * (fs.in_prefix + fs.in_len + fs.in_suffix)
                + fs.suffix_dc_cap
                + fs.prefix_dc_cap
            ) * el_count
        elif fs.resample_factor == 0:
            s += (
                fs.bank.filter_len
                * (fs.bank.order + el_count)
                * fs.out_len
            )
            if i == resize_step and is_resize2:
                s >>= 1
            s2 += bank_cost
        else:
            s += fs.flt_cap * el_count * fs.out_len * 3 // 4

    return s + s2 // scanline_count
