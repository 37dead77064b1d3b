"""Resizing algorithm parameter sets.

Equivalent of the reference's ``CImageResizerParams`` hierarchy
(avir.h:2262-2464).  The preset constants were
machine-optimized by the reference's author against a white-noise k=1
round-trip score; they are design *data* (not code) and are reproduced
verbatim so that the new framework delivers the same frequency response.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Params:
    """Resizing algorithm tunables (see avir.h:2262-2317 for semantics).

    corr_flt_alpha / corr_flt_len: correction-filter Peaked Cosine window
        alpha and length in taps.
    int_flt_alpha / int_flt_cutoff / int_flt_len: interpolation low-pass
        filter window alpha, normalized cutoff [0;1], and length in taps.
    lp_flt_alpha / lp_flt_base_len / lp_flt_cutoff_mult: anti-aliasing
        low-pass filter window alpha, base length, and cutoff multiplier.
    hb_flt_*: half-band filter internals (fixed technical values).
    """

    corr_flt_alpha: float
    corr_flt_len: float
    int_flt_alpha: float
    int_flt_cutoff: float
    int_flt_len: float
    lp_flt_alpha: float
    lp_flt_base_len: float
    lp_flt_cutoff_mult: float
    hb_flt_alpha: float = 1.94609
    hb_flt_cutoff: float = 0.46437
    hb_flt_len: float = 24.0

    def cache_key(self) -> tuple:
        return dataclasses.astuple(self)


# Default parameter set (avir.h:2328-2341), score 10.06/1.88/1.029.
PARAMS_DEF = Params(
    corr_flt_alpha=0.97946,
    corr_flt_len=6.4262,
    int_flt_alpha=6.41341,
    int_flt_cutoff=0.7372,
    int_flt_len=18,
    lp_flt_alpha=4.76449,
    lp_flt_base_len=7.55999999999998,
    lp_flt_cutoff_mult=0.79285,
)

# Ultra-low-ringing set (avir.h:2353-2366), score 7.50/2.01/1.083.
PARAMS_ULR = Params(
    corr_flt_alpha=0.95521,
    corr_flt_len=5.70774,
    int_flt_alpha=1.00766,
    int_flt_cutoff=0.74202,
    int_flt_len=18,
    lp_flt_alpha=1.6801,
    lp_flt_base_len=6.62,
    lp_flt_cutoff_mult=0.67821,
)

# Low-ringing set (avir.h:2377-2390), score 7.91/1.96/1.065.
PARAMS_LR = Params(
    corr_flt_alpha=1.0,
    corr_flt_len=5.865,
    int_flt_alpha=1.79529,
    int_flt_cutoff=0.74325,
    int_flt_len=18,
    lp_flt_alpha=1.87597,
    lp_flt_base_len=6.89999999999999,
    lp_flt_cutoff_mult=0.69326,
)

# Lower-ringing set (avir.h:2401-2414), score 9.21/1.91/1.040.
PARAMS_LOW = Params(
    corr_flt_alpha=0.99739,
    corr_flt_len=6.20326,
    int_flt_alpha=4.6836,
    int_flt_cutoff=0.73879,
    int_flt_len=18,
    lp_flt_alpha=7.86565,
    lp_flt_base_len=6.91999999999999,
    lp_flt_cutoff_mult=0.78379,
)

# Low-aliasing set (avir.h:2426-2439), score 11.59/1.84/1.015.
PARAMS_HIGH = Params(
    corr_flt_alpha=0.97433,
    corr_flt_len=6.87893,
    int_flt_alpha=7.74731,
    int_flt_cutoff=0.73844,
    int_flt_len=18,
    lp_flt_alpha=4.8149,
    lp_flt_base_len=8.07999999999996,
    lp_flt_cutoff_mult=0.79335,
)

# Ultra low-aliasing set (avir.h:2451-2464), score 13.68/1.79/1.000.
PARAMS_ULTRA = Params(
    corr_flt_alpha=0.99705,
    corr_flt_len=7.42695,
    int_flt_alpha=1.71985,
    int_flt_cutoff=0.7571,
    int_flt_len=18,
    lp_flt_alpha=6.71313,
    lp_flt_base_len=8.27999999999996,
    lp_flt_cutoff_mult=0.78413,
)

_PRESETS = {
    "def": PARAMS_DEF,
    "default": PARAMS_DEF,
    "ulr": PARAMS_ULR,
    "lr": PARAMS_LR,
    "low": PARAMS_LOW,
    "high": PARAMS_HIGH,
    "ultra": PARAMS_ULTRA,
}


def preset(name: str) -> Params:
    """Look up a named quality preset (def/ulr/lr/low/high/ultra)."""
    try:
        return _PRESETS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; valid: {sorted(set(_PRESETS))}"
        ) from None
