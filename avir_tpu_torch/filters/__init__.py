"""Host-side filter design (float64 NumPy).

Everything downstream (planner, device kernels) consumes plain arrays
produced here.  Mirrors the math of the reference's filter-design layer
(avir.h:996-2100) with direct vectorized evaluation in place of the
reference's recurrence oscillators.
"""

from .design import (
    peaked_cosine_window,
    peaked_cosine_lpf,
    lpf_geometry,
    calc_fir_response,
    normalize_fir,
    FirEq,
    FracFilterBank,
)
from .lanczos import FRAC_COUNT, LanczosBank, lanczos_filter, lanczos_geometry

__all__ = [
    "FRAC_COUNT",
    "LanczosBank",
    "lanczos_filter",
    "lanczos_geometry",
    "peaked_cosine_window",
    "peaked_cosine_lpf",
    "lpf_geometry",
    "calc_fir_response",
    "normalize_fir",
    "FirEq",
    "FracFilterBank",
]
