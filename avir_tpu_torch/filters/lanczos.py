"""Lanczos fractional-delay filters for the LANCIR fast path.

A copy of the JAX package's ``filters/lanczos.py``: the re-derivation of
CLancIR::CResizeFilters (lancir.h:840-1219): kernel length
2*ceil(la/norm_freq) with norm_freq = min(1, 1/k); taps
sin(F*u)*sin(Fa*u)/u^2 sum-normalized; 1000 fractional positions
(sufficient for the 8-bit-precision contract of this path).
"""

from __future__ import annotations

import math

import numpy as np

FRAC_COUNT = 1000  # lancir.h:914


def lanczos_geometry(la: float, k: float) -> tuple[int, float, float, float]:
    """(kernel_len, len2, freq, freq_a) for Lanczos parameter ``la`` and
    resizing step ``k`` (lancir.h:889-895)."""
    norm_freq = 1.0 if k <= 1.0 else 1.0 / k
    freq = math.pi * norm_freq
    freq_a = freq / la
    len2 = la / norm_freq
    fl2 = int(math.ceil(len2))
    return fl2 + fl2, len2, freq, freq_a


def lanczos_filter(la: float, k: float, frac_delay: float) -> np.ndarray:
    """Normalized Lanczos fractional-delay filter (float32).

    ``frac_delay`` in [0; 1].  Tap j corresponds to u = j - fl2 +
    frac_delay; value sin(freq*u)*sin(freq_a*u)/u**2, with the u == 0 limit
    freq*freq_a, zeroed outside |u| <= len2, then sum-normalized.
    Mirrors makeFilterNorm (lancir.h:1076-1156) including its exact
    first/last-tap zeroing conditions and the 2.3e-13 zero threshold.
    """
    kernel_len, len2, freq, freq_a = lanczos_geometry(la, k)
    fl2 = kernel_len // 2
    j = np.arange(kernel_len, dtype=np.float64)
    u = j - fl2 + frac_delay

    with np.errstate(divide="ignore", invalid="ignore"):
        vals = np.sin(freq * u) * np.sin(freq_a * u) / (u * u)

    # u == 0 limit (taken when frac_delay is within 2.3e-13 of 0 or 1).
    zero_mask = np.abs(u) < 2.3e-13
    vals = np.where(zero_mask, freq * freq_a, vals)

    # First tap zeroed if it falls left of the window; last tap zeroed if
    # it falls right of the window (lancir.h:1087-1094, 1135-1145).
    if -fl2 + frac_delay < -len2:
        vals[0] = 0.0
    if fl2 - 1 + frac_delay > len2:
        vals[-1] = 0.0

    # The reference stores float taps, sums them in double, and rescales
    # each tap in double before the final float store (lancir.h:1147-1155).
    vals32 = vals.astype(np.float32)
    s = 1.0 / float(vals32.sum(dtype=np.float64))
    return (vals32.astype(np.float64) * s).astype(np.float32)


class LanczosBank:
    """Bank of Lanczos fractional-delay filters, quantized to 1000
    fractional positions like the reference (lancir.h:940-967).

    ``filter_for_frac(x)`` returns the filter for fractional position x in
    [0; 1]: Frac = int(x * 1000 + 0.5), delay = 1 - Frac/1000.
    """

    def __init__(self, la: float, k: float):
        self.la = la
        self.k = k
        self.kernel_len = lanczos_geometry(la, k)[0]
        self.fl2 = self.kernel_len // 2
        self._cache: dict[int, np.ndarray] = {}

    def filter_for_frac(self, x: float) -> np.ndarray:
        frac = int(x * FRAC_COUNT + 0.5)
        flt = self._cache.get(frac)
        if flt is None:
            flt = lanczos_filter(self.la, self.k, 1.0 - frac / FRAC_COUNT)
            self._cache[frac] = flt
        return flt
