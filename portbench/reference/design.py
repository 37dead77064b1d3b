"""AVIR filter design: Peaked Cosine windows, windowed-sinc low-pass
filters, the paragraphic FIR equalizer, and the fractional-delay filter
bank.

All functions are host-side float64 NumPy re-derivations of the reference
designs (citations per function).  The reference evaluates sines via 2-tap
recurrence oscillators for speed; here everything is evaluated directly,
which is slightly *more* accurate and fully vectorized.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def peaked_cosine_window(alpha: float, len2: float, n: int) -> np.ndarray:
    """Right half of the Peaked Cosine window function.

    w(t) = sin(pi/2 + t*pi/(2*len2)) * (1 - (t/len2)**alpha),  t = 0..n-1.

    Semantics of avir.h:1054-1093
    (CDSPWindowGenPeakedCosine).  ``alpha`` balances early vs late tap
    attenuation; ``len2`` is the non-truncated half length.
    """
    t = np.arange(n, dtype=np.float64)
    return np.sin(math.pi / 2 + t * (math.pi / 2) / len2) * (
        1.0 - (t / len2) ** alpha
    )


def lpf_geometry(len2: float) -> tuple[int, int]:
    """(fl2, filter_len) for a symmetric-odd LPF of half-length ``len2``.

    fl2 = ceil(len2) - 1 is also the filter's latency (group delay).
    Matches avir.h:1506-1514.
    """
    fl2 = int(math.ceil(len2)) - 1
    return fl2, 2 * fl2 + 1


def peaked_cosine_lpf(
    len2: float, freq2: float, alpha: float, dc_gain: float = 1.0
) -> np.ndarray:
    """Linear-phase symmetric-odd windowed-sinc low-pass filter.

    Taps: center = freq2 * w(0); tap(t) = sin(freq2*t)/t * w(t) mirrored.
    If ``dc_gain`` > 0 the taps are scaled so they sum to ``dc_gain``;
    otherwise returned unnormalized.

    Semantics of CDSPPeakedCosineLPF::generateLPF
    (avir.h:1528-1582).
    """
    fl2, flen = lpf_geometry(len2)
    w = peaked_cosine_window(alpha, len2, fl2 + 1)
    t = np.arange(1, fl2 + 1, dtype=np.float64)
    half = np.sin(freq2 * t) / t * w[1:]
    taps = np.empty(flen, dtype=np.float64)
    taps[fl2] = freq2 * w[0]
    taps[fl2 + 1 :] = half
    taps[:fl2] = half[::-1]
    if dc_gain > 0.0:
        taps *= dc_gain / taps.sum()
    return taps


def calc_fir_response(
    flt: np.ndarray, th: float, fltlat: int = 0
) -> tuple[float, float]:
    """Complex frequency response (re, im) of an FIR filter at circular
    frequency ``th`` in [0; pi], with latency ``fltlat`` taps.

    Semantics of calcFIRFilterResponse (avir.h:460-503).
    """
    flt = np.asarray(flt, dtype=np.float64)
    ph = -(fltlat + np.arange(flt.size, dtype=np.float64)) * th
    re = float(np.dot(np.cos(ph), flt))
    im = float(np.dot(np.sin(ph), flt))
    return re, im


def normalize_fir(taps: np.ndarray, dc_gain: float = 1.0) -> np.ndarray:
    """Scale taps so the DC gain (sum) equals ``dc_gain``
    (avir.h:516-541)."""
    taps = np.asarray(taps, dtype=np.float64)
    return taps * (dc_gain / taps.sum())


class FirEq:
    """Paragraphic-equalizer FIR generator.

    Builds symmetric-odd FIR filters matching arbitrary per-band linear
    gains.  The frequency range is decomposed into bands, each represented
    by a linear and a ramp kernel windowed by the Peaked Cosine window;
    buildFilter() combines them with weights derived from the band gains.

    Re-derivation of CDSPFIREQ (avir.h:1116-1480).
    """

    def __init__(
        self,
        sample_rate: float,
        filter_length: float,
        band_count: int,
        min_freq: float,
        max_freq: float,
        is_log_bands: bool,
        wf_alpha: float,
    ):
        self.filter_length = filter_length
        self.band_count = band_count
        z = int(math.ceil(filter_length * 0.5))
        self.z = z
        self.z2 = z * 2

        winbuf = peaked_cosine_window(wf_alpha, filter_length * 0.5, z)[::-1]
        # winbuf[k] = w(z - 1 - k), matching initWinBuf (avir.h:1374-1383).

        self.use_first_virt = min_freq > 0.0
        nbands_alloc = band_count + (1 if self.use_first_virt else 0) + 1
        self.kern1 = np.zeros((nbands_alloc, z), dtype=np.float64)
        self.kern2 = np.zeros((nbands_alloc, z), dtype=np.float64)
        self.center_freqs = np.zeros(band_count, dtype=np.float64)

        if is_log_bands:
            m = math.exp(math.log(max_freq / min_freq) / (band_count - 1))
            mo = 0.0
        else:
            m = 1.0
            mo = (max_freq - min_freq) / (band_count - 1)

        f = min_freq
        x1 = 0.0
        if self.use_first_virt:
            si = 0
        else:
            si = 1
            self.center_freqs[0] = 0.0
            f = f * m + mo

        kb = 0
        for i in range(si, band_count):
            x2 = f * 2.0 / sample_rate
            self.center_freqs[i] = x2
            self._fill_band_kernel(x1, x2, kb, winbuf)
            kb += 1
            x1 = x2
            f = f * m + mo

        if x1 < 1.0:
            self.use_last_virt = True
            self._fill_band_kernel(x1, 1.0, kb, winbuf)
        else:
            self.use_last_virt = False

    def _fill_band_kernel(
        self, x1: float, x2: float, kb: int, winbuf: np.ndarray
    ) -> None:
        """Band kernel pair for corner frequencies (x1, x2) in (0..1).

        Direct evaluation of fillBandKernel (avir.h:1402-1437):
        for ks in 1..z-1, with x = pi*(ks - z),
          kern1[ks-1] = (x2*sin(pi*x2*(ks-z)) - x1*sin(pi*x1*(ks-z))
                         + (cos(pi*x2*(ks-z)) - cos(pi*x1*(ks-z)))/x) * v0
          kern2[ks-1] = (sin(pi*x2*(ks-z)) - sin(pi*x1*(ks-z))) * v0
          v0 = winbuf[ks-1] / ((x1 - x2) * x)
        and the center taps kern1[z-1] = 0.5*(x2^2-x1^2)/(x1-x2),
        kern2[z-1] = -1.
        """
        z = self.z
        ks = np.arange(1, z, dtype=np.float64)
        x = math.pi * (ks - z)
        s1 = np.sin(math.pi * x1 * (ks - z))
        c1 = np.cos(math.pi * x1 * (ks - z))
        s2 = np.sin(math.pi * x2 * (ks - z))
        c2 = np.cos(math.pi * x2 * (ks - z))
        v0 = winbuf[: z - 1] / ((x1 - x2) * x)
        self.kern1[kb, : z - 1] = (x2 * s2 - x1 * s1 + (c2 - c1) / x) * v0
        self.kern2[kb, : z - 1] = (s2 - s1) * v0
        self.kern1[kb, z - 1] = (x2 * x2 - x1 * x1) / (x1 - x2) * 0.5
        self.kern2[kb, z - 1] = -1.0

    @property
    def filter_len(self) -> int:
        return self.z2 - 1

    @property
    def latency(self) -> int:
        return self.z - 1

    @staticmethod
    def calc_filter_length(filter_length: float) -> tuple[int, int]:
        """(filter_len, latency) for a required non-truncated length
        (avir.h:1316-1322)."""
        z = int(math.ceil(filter_length * 0.5))
        return z * 2 - 1, z - 1

    def build_filter(self, band_gains: np.ndarray) -> np.ndarray:
        """Symmetric-odd FIR with the given linear gains at band crossover
        points (avir.h:1247-1304)."""
        g = np.asarray(band_gains, dtype=np.float64)
        z = self.z
        half = np.zeros(z, dtype=np.float64)

        x1 = 0.0
        y1 = g[0]
        if self.use_first_virt:
            si = 1
            x2 = self.center_freqs[0]
            y2 = y1
        else:
            si = 2
            x2 = self.center_freqs[1]
            y2 = g[1]

        kb = 0
        half += (y1 - y2) * self.kern1[kb] + (x1 * y2 - x2 * y1) * self.kern2[kb]
        kb += 1
        x1, y1 = x2, y2

        for i in range(si, self.band_count):
            x2 = self.center_freqs[i]
            y2 = g[i]
            half += (y1 - y2) * self.kern1[kb] + (
                x1 * y2 - x2 * y1
            ) * self.kern2[kb]
            kb += 1
            x1, y1 = x2, y2

        if self.use_last_virt:
            # Virtual band up to Nyquist: x2 = 1, y2 = y1.
            half += (x1 * y1 - y1) * self.kern2[kb]

        flt = np.empty(self.z2 - 1, dtype=np.float64)
        flt[:z] = half
        flt[z:] = half[z - 2 :: -1]
        return flt


class FracFilterBank:
    """Sinc-based fractional-delay filter bank.

    One long Peaked-Cosine-windowed sinc LPF is polyphase-decomposed into
    ``frac_count + 1`` sub-filters, each DC-normalized; each sub-filter is
    optionally convolved with an external filter; order-1 banks also store
    the delta to the next fractional filter for linear interpolation.

    Re-derivation of CDSPFracFilterBankLin (avir.h:
    1647-2100).  The bank is built eagerly (it is small) and stored as
    float32 to mirror the reference's fptype quantization of tap tables.

    Attributes:
      filters: float32 [frac_count + 1, filter_len] tap rows.
      deltas: float32 [frac_count + 1, filter_len] next-minus-current rows
        (order 1 only, else None).
    """

    def __init__(
        self,
        frac_count: int,
        order: int,
        base_len: float,
        cutoff: float,
        wf_alpha: float,
        ext_filter: Optional[np.ndarray] = None,
    ):
        self.frac_count = frac_count
        self.order = order
        wf_len2 = 0.5 * base_len * frac_count
        wf_freq = math.pi * cutoff / frac_count

        fl2, _ = lpf_geometry(wf_len2)
        src_filter_len = (fl2 // frac_count + 1) * 2
        self.src_filter_len = src_filter_len

        filter_len = src_filter_len
        ext_len = 0
        if ext_filter is not None and len(ext_filter) > 0:
            ext_len = len(ext_filter)
            filter_len += ext_len - 1
        self.filter_len = filter_len

        # Long unnormalized LPF, zero-padded into the polyphase buffer
        # (buildSrcTable, avir.h:1970-2009).
        buf_len = src_filter_len * frac_count + 1
        buf_center = src_filter_len * frac_count // 2
        buf = np.zeros(buf_len, dtype=np.float64)
        lpf = peaked_cosine_lpf(wf_len2, wf_freq, wf_alpha, dc_gain=0.0)
        buf[buf_center - fl2 : buf_center + fl2 + 1] = lpf

        # Polyphase split: bank row n holds phase (frac_count - n).
        n = np.arange(frac_count + 1)
        j = np.arange(src_filter_len)
        src_table = buf[(frac_count - n)[:, None] + j[None, :] * frac_count]
        src_table /= src_table.sum(axis=1, keepdims=True)

        # Zero-placement + optional external-filter convolution
        # (createFilter, avir.h:2021-2099).
        ext_latency = ext_len // 2
        res_latency = ext_latency + src_filter_len // 2
        res_len = src_filter_len + (ext_len - 1 if ext_len else 0)
        res_offs = filter_len // 2 - res_latency

        rows = np.zeros((frac_count + 1, filter_len), dtype=np.float64)
        if ext_len:
            ext = np.asarray(ext_filter, dtype=np.float64)
            for i in range(frac_count + 1):
                rows[i, res_offs : res_offs + res_len] = np.convolve(
                    src_table[i], ext
                )
        else:
            rows[:, res_offs : res_offs + res_len] = src_table

        self.filters = rows.astype(np.float32)
        if order > 0:
            self.deltas = (
                self.filters[1:] - self.filters[:-1]
            )  # float32, like the reference's in-table deltas
        else:
            self.deltas = None

    def tap_row(self, fti: int, x: float) -> np.ndarray:
        """Effective tap row for fractional index ``fti`` and interpolation
        coefficient ``x`` (float32 arithmetic, like doResize's
        ftp[i] + ftp2[i]*x at avir.h:3926)."""
        if self.order > 0:
            return self.filters[fti] + self.deltas[fti] * np.float32(x)
        return self.filters[fti]
