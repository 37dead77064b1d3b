"""Step-geometry computation: buffer lengths, prefixes/suffixes, resizing
positions, upsample extension and the IsResize2 detection.

Re-derivation of updateFilterStepBuffers / extendUpsample / fillRPosBuf
(avir.h:5753-5937).  The composition layer relies on this
geometry to materialize each step's output over exactly the index range
the reference computes.
"""

from __future__ import annotations

import math

import numpy as np

from .steps import FilterStep


def fill_rpos(fs: FilterStep, k: float, o: float) -> None:
    """Resizing positions for the resize step (fillRPosBuf,
    avir.h:5782-5808): SrcPos = o + k*i, integer part, fractional filter
    index fti and float32 interpolation coefficient x."""
    frac_count = fs.bank.frac_count
    i = np.arange(fs.out_len, dtype=np.float64)
    src_pos = o + k * i
    src_pos_int = np.floor(src_pos).astype(np.int64)
    x = (src_pos - src_pos_int) * frac_count
    fti = x.astype(np.int64)
    # Guard against fti == frac_count from floating roundoff at exact
    # integer positions (cannot happen in the reference's double math, but
    # keep the invariant explicit).
    fti = np.minimum(fti, frac_count)
    fs.src_pos_int = src_pos_int
    fs.fti = fti
    fs.frac_x = (x - fti).astype(np.float32)


def extend_upsample(fs: FilterStep, next_step: FilterStep) -> None:
    """Extend an upsampling step to cover the next step's prefix/suffix
    needs (extendUpsample, avir.h:5753-5766)."""
    r = fs.resample_factor
    fs.in_prefix = (next_step.in_prefix + r - 1) // r
    fs.out_prefix += fs.in_prefix * r
    next_step.in_prefix = 0
    fs.in_suffix = (next_step.in_suffix + r - 1) // r
    fs.out_suffix += fs.in_suffix * r
    next_step.in_suffix = 0


def update_step_buffers(
    steps: list[FilterStep],
    resize_step: int,
    k: float,
    o: float,
    src_len: int,
    new_len: int,
) -> tuple[float, float, bool]:
    """Compute per-step geometry; returns (k, o, is_resize2) with the
    k/o values as updated through the chain (updateFilterStepBuffers,
    avir.h:5827-5937)."""
    upstep = -1

    for i, fs in enumerate(steps):
        fs.in_len = src_len

        if fs.is_upsample:
            upstep = i
            r = fs.resample_factor
            k *= r
            o *= r
            fs.in_prefix = 0
            fs.in_suffix = 0
            fs.out_len = fs.in_len * r
            fs.out_prefix = fs.flt_latency
            fs.out_suffix = fs.flt_cap - fs.flt_latency - r

            l0 = fs.out_prefix + fs.out_len + fs.out_suffix
            l = fs.in_len * r + fs.suffix_dc_cap
            if l > l0:
                fs.out_suffix += l - l0
            l0 = fs.out_len + fs.out_suffix
            if fs.prefix_dc_cap > l0:
                fs.out_suffix += fs.prefix_dc_cap - l0
        elif fs.resample_factor == 0:
            flen_d2 = fs.bank.filter_len // 2
            resize_l_pix = int(math.floor(o)) - (flen_d2 - 1)
            fs.in_prefix = -resize_l_pix if resize_l_pix < 0 else 0
            resize_r_pix = (
                int(math.floor(o + (new_len - 1) * k)) + flen_d2 + 1
            )
            fs.in_suffix = (
                resize_r_pix - fs.in_len if resize_r_pix > fs.in_len else 0
            )
            fs.out_len = new_len
            fill_rpos(fs, k, o)
        else:
            r = fs.resample_factor
            k /= r
            o /= r
            o += fs.edge_pixel_count

            fs.in_prefix = fs.flt_latency
            fs.in_suffix = fs.flt_cap - fs.flt_latency - 1
            fs.out_len = (
                (fs.in_len + r - 1) // r + fs.edge_pixel_count
            )
            fs.in_suffix += (fs.out_len - 1) * r + 1 - fs.in_len
            fs.in_prefix += fs.edge_pixel_count * r
            fs.out_len += fs.edge_pixel_count

        src_len = fs.out_len

    is_resize2 = False
    if upstep != -1:
        extend_upsample(steps[upstep], steps[upstep + 1])
        if (
            steps[upstep].resample_factor == 2
            and resize_step == upstep + 1
            and steps[upstep].flt_orig is not None
        ):
            # Interleaved packmode stride-2 resize over the filterless 2x
            # upsample (avir.h:5920-5936).  Purely a CPU-side optimization
            # in the reference; here it only affects the complexity model
            # used for build-mode selection parity.
            is_resize2 = True

    return k, o, is_resize2
