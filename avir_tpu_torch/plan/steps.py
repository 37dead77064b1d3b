"""Filtering-step planning.

Re-derivation of the reference's pipeline construction:
buildFilterSteps / assignFilterParams / addCorrectionFilter / initFilterBank
(avir.h:5128-5739).  The planned steps are *declarative*
(taps + geometry); they are never executed one-by-one — the compose module
collapses them into a single banded operator per axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..filters.design import (
    FirEq,
    FracFilterBank,
    calc_fir_response,
    lpf_geometry,
    normalize_fir,
    peaked_cosine_lpf,
)
from ..params import Params


@dataclasses.dataclass
class FilterStep:
    """One planned filtering step (cf. CImageResizerFilterStep,
    avir.h:2568-2728)."""

    is_upsample: bool = False
    resample_factor: int = 1  # 0 => resize (fractional interpolation) step
    flt: Optional[np.ndarray] = None  # float32 taps
    flt_latency: int = 0
    dc_gain: float = 1.0
    edge_pixel_count: int = 0
    # Original float64 design, kept when it is to be folded into the
    # interpolation bank as an external filter (combo modes), in which case
    # an upsampling step runs filterless.
    flt_orig: Optional[np.ndarray] = None
    # Resize step only:
    bank: Optional[FracFilterBank] = None
    bank_key: Optional[tuple] = None
    bank_is_fixed: bool = False
    # Geometry (filled by plan.geometry.update_step_buffers):
    in_len: int = 0
    in_prefix: int = 0
    in_suffix: int = 0
    out_len: int = 0
    out_prefix: int = 0
    out_suffix: int = 0
    # Resize positions (filled by geometry):
    src_pos_int: Optional[np.ndarray] = None  # int64
    fti: Optional[np.ndarray] = None  # int64
    frac_x: Optional[np.ndarray] = None  # float32

    @property
    def flt_cap(self) -> int:
        return 0 if self.flt is None else len(self.flt)

    @property
    def prefix_dc_cap(self) -> int:
        # assignFilterParams: l = cap - FltLatency - ResampleFactor
        # (avir.h:5309-5312); elalign == 1 so FltExt == 0.
        return self.flt_cap - self.flt_latency - self.resample_factor

    @property
    def suffix_dc_cap(self) -> int:
        return self.flt_latency


EDGE_PIXEL_COUNT_DEF = 3  # avir.h:2629-2631
BIN_COUNT = 65  # correction-filter response bins, avir.h:5401


def bank_params_key(
    frac_count: int,
    order: int,
    base_len: float,
    cutoff: float,
    alpha: float,
    ext_params: Optional[tuple],
) -> tuple:
    """Equality key matching CDSPFracFilterBankLin::operator==
    (avir.h:1702-1707): order, WFLen2, WFFreq, WFAlpha, FracCount, ext."""
    wf_len2 = 0.5 * base_len * frac_count
    wf_freq = math.pi * cutoff / frac_count
    return (order, wf_len2, wf_freq, alpha, frac_count, ext_params)


class BankManager:
    """Cache of fractional-delay filter banks keyed on design parameters.

    Plays the role of the reference's FixedFilterBank member plus the
    per-call dynamic bank, including the bookkeeping that the complexity
    model needs (which fractional filters were already created).
    """

    def __init__(self, res_bit_depth: int, src_bit_depth: int, params: Params):
        self.params = params
        self.int_bit_depth = max(res_bit_depth, src_bit_depth)
        self._banks: dict[tuple, FracFilterBank] = {}
        # Created-filter flags per bank key (for the complexity model).
        self.created: dict[tuple, np.ndarray] = {}
        self.fixed_key = self.bank_key(1.0, False, None)
        fixed = self.get_bank(self.fixed_key, None)
        # The fixed bank is eagerly built (createAllFilters, avir.h:4638).
        self.created[self.fixed_key] = np.ones(
            fixed.frac_count + 1, dtype=bool
        )

    def frac_count_and_order(self, force_hi_order: bool) -> tuple[int, int]:
        """SNR-model selection of interpolation order and the number of
        fractional filters (avir.h:5135-5159)."""
        snr = -6.02 * (self.int_bit_depth + 3)
        if force_hi_order or self.int_bit_depth > 8:
            order = 1
            frac_count = int(math.ceil(0.23134052 * math.exp(-0.058062929 * snr)))
        else:
            order = 0
            frac_count = int(math.ceil(0.33287686 * math.exp(-0.11334583 * snr)))
        return max(frac_count, 2), order

    def bank_key(
        self,
        cutoff_mult: float,
        force_hi_order: bool,
        ext_params: Optional[tuple],
    ) -> tuple:
        frac_count, order = self.frac_count_and_order(force_hi_order)
        return bank_params_key(
            frac_count,
            order,
            self.params.int_flt_len / cutoff_mult,
            self.params.int_flt_cutoff * cutoff_mult,
            self.params.int_flt_alpha,
            ext_params,
        )

    def get_bank(
        self, key: tuple, ext_filter: Optional[np.ndarray]
    ) -> FracFilterBank:
        bank = self._banks.get(key)
        if bank is None:
            order, wf_len2, wf_freq, alpha, frac_count, _ = key
            # Reconstruct base_len/cutoff from the canonical key values.
            base_len = wf_len2 * 2.0 / frac_count
            cutoff = wf_freq * frac_count / math.pi
            bank = FracFilterBank(
                frac_count, order, base_len, cutoff, alpha, ext_filter
            )
            self._banks[key] = bank
            if key not in self.created:
                self.created[key] = np.zeros(frac_count + 1, dtype=bool)
        return bank


def assign_filter_params(
    fs: FilterStep,
    is_upsample: bool,
    resample_factor: int,
    flt_cutoff: float,
    dc_gain: float,
    use_flt_orig: bool,
    params: Params,
) -> None:
    """Design the step's low-pass filter (avir.h:5231-5360).

    flt_cutoff == 0 selects the predefined half-band filter; otherwise the
    preset's LPFlt* parameters scaled by the cutoff.
    """
    if flt_cutoff == 0.0:
        m = 2.0 / resample_factor
        flt_alpha = params.hb_flt_alpha
        len2 = 0.5 * params.hb_flt_len / m
        freq = math.pi * params.hb_flt_cutoff * m
    else:
        flt_alpha = params.lp_flt_alpha
        len2 = 0.25 * params.lp_flt_base_len / flt_cutoff
        freq = math.pi * params.lp_flt_cutoff_mult * flt_cutoff

    if is_upsample:
        len2 *= resample_factor
        freq /= resample_factor
        fs.dc_gain = dc_gain * resample_factor
    else:
        fs.dc_gain = dc_gain

    fl2, _ = lpf_geometry(len2)
    fs.is_upsample = is_upsample
    fs.resample_factor = resample_factor
    fs.flt_latency = fl2

    flt_orig = peaked_cosine_lpf(len2, freq, flt_alpha, dc_gain=fs.dc_gain)
    fs.flt = flt_orig.astype(np.float32)
    fs.flt_orig = flt_orig if use_flt_orig else None

    if not is_upsample and not use_flt_orig:
        fs.edge_pixel_count = EDGE_PIXEL_COUNT_DEF


def add_correction_filter(
    steps: list[FilterStep],
    bw: float,
    is_pre_correction: bool,
    params: Params,
    is_model: bool,
) -> None:
    """Design the frequency-response correction filter by measuring every
    step's deviation from its nominal DC gain over 65 bins and building a
    compensating FIR with the paragraphic EQ (avir.h:5384-5506)."""
    if is_pre_correction:
        nfs = steps[0]
    else:
        nfs = FilterStep()
        steps.append(nfs)
    nfs.is_upsample = False
    nfs.resample_factor = 1
    nfs.dc_gain = 1.0
    nfs.edge_pixel_count = EDGE_PIXEL_COUNT_DEF if is_pre_correction else 0

    if is_model:
        flen, lat = FirEq.calc_filter_length(params.corr_flt_len)
        nfs.flt = np.zeros(flen, dtype=np.float32)
        nfs.flt_latency = lat
        return

    bins = np.ones(BIN_COUNT, dtype=np.float64)
    curbw = 1.0
    si = 1 if is_pre_correction else 0
    end = len(steps) - (0 if is_pre_correction else 1)

    for fs in steps[si:end]:
        if fs.is_upsample:
            curbw *= fs.resample_factor
            if fs.flt_orig is not None:
                continue

        if fs.resample_factor == 0:
            flt = fs.bank.filters[0]
            flt_len = fs.bank.filter_len
        else:
            flt = fs.flt
            flt_len = fs.flt_cap

        thm = math.pi * bw / (curbw * (BIN_COUNT - 1))
        for j in range(BIN_COUNT):
            re, im = calc_fir_response(flt[:flt_len], j * thm)
            bins[j] *= fs.dc_gain / math.sqrt(re * re + im * im)

        if not fs.is_upsample and fs.resample_factor > 1:
            curbw /= fs.resample_factor

    eq = FirEq(
        bw * 2.0, params.corr_flt_len, BIN_COUNT, 0.0, bw, False,
        params.corr_flt_alpha,
    )
    nfs.flt_latency = eq.latency
    flt = normalize_fir(eq.build_filter(bins), 1.0)
    nfs.flt = flt.astype(np.float32)


def build_filter_steps(
    k: float,
    banks: BankManager,
    dc_gain: float,
    mode_flags: int,
    params: Params,
    is_model: bool,
) -> tuple[list[FilterStep], int]:
    """Plan the per-axis step sequence for resizing factor ``k``
    (avir.h:5616-5739).

    mode_flags: bit0 = fold the LPF into the interpolation bank,
    bit1 = force order-1 interpolation, bit2 = half-band cascade.
    Returns (steps, resize_step_index).
    """
    do_combo = (mode_flags & 1) != 0
    force_hi_order = (mode_flags & 2) != 0
    use_halfband = (mode_flags & 4) != 0

    steps: list[FilterStep] = []
    bw = 1.0 / k
    upsample_factor = 2 if int(math.floor(k)) < 2 else 1

    if k <= 1.0:
        is_pre_correction = True
        flt_cutoff = 1.0
        corrbw = 1.0
        steps.append(FilterStep())  # pre-correction placeholder
    else:
        is_pre_correction = False
        flt_cutoff = bw
        corrbw = bw

    if upsample_factor > 1:
        fs = FilterStep()
        steps.append(fs)
        assign_filter_params(
            fs, True, upsample_factor, flt_cutoff, dc_gain, do_combo, params
        )
        int_cutoff_mult = flt_cutoff * 2.0 / upsample_factor
        reuse_step = None
        ext_flt_step = fs if do_combo else None
    else:
        while True:
            downsample_factor = int(math.floor(0.5 / flt_cutoff))
            if use_halfband and downsample_factor > 1:
                hb = FilterStep()
                steps.append(hb)
                assign_filter_params(
                    hb, False, downsample_factor, 0.0, 1.0, False, params
                )
                flt_cutoff *= downsample_factor
            else:
                downsample_factor = max(downsample_factor, 1)
                break

        fs = FilterStep()
        steps.append(fs)
        assign_filter_params(
            fs, False, downsample_factor, flt_cutoff, dc_gain, do_combo, params
        )
        int_cutoff_mult = flt_cutoff / 0.5
        if do_combo:
            reuse_step = fs
            ext_flt_step = fs
        else:
            int_cutoff_mult *= downsample_factor
            reuse_step = None
            ext_flt_step = None

    # Resizing step (possibly reusing the LPF step with the LPF folded into
    # the bank as external filter).
    if reuse_step is None:
        fs = FilterStep()
        steps.append(fs)
    else:
        fs = reuse_step
    resize_step = len(steps) - 1
    fs.is_upsample = False
    fs.resample_factor = 0
    fs.dc_gain = ext_flt_step.dc_gain if ext_flt_step is not None else 1.0

    ext = ext_flt_step.flt_orig if ext_flt_step is not None else None
    ext_params = None
    if ext is not None:
        # Mirror CFltBuffer parameter equality: the design tuple.
        ext_params = ("ext", len(ext), float(ext[0]), float(ext[-1]),
                      float(ext.sum()))
    key = banks.bank_key(int_cutoff_mult, force_hi_order, ext_params)
    fs.bank_key = key
    fs.bank_is_fixed = key == banks.fixed_key
    # Banks are cheap to build; always materialize (model passes too) so
    # correction-filter response measurement and composition can use them.
    fs.bank = banks.get_bank(key, ext)

    add_correction_filter(steps, corrbw, is_pre_correction, params, is_model)
    return steps, resize_step
