"""DSP metrology: frequency response, dynamic range and peak error of the
resizing pipelines.

Counterpart of the JAX package's ``metrology.py``, a re-derivation of the
reference's quality harness (other/frtest.cpp:1-253): single-channel
cosine-grating images (debiased, power-normalized per row) at log-spaced
frequencies, each resized over a sweep of scale factors and measured:

  FR - RMS of the resized grating (response at that frequency), dB
  DR - RMS error of the two-way resize (k then 1/k) against the source,
       after gain renormalization, dB
  PE - peak error of the round trip, dB

``measure`` and ``whitenoise_roundtrip_rms`` run the port's ``resize`` /
``LancIR.resize`` on ``device`` (None: the CUDA card; "cpu": the kernels'
plain versions).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np


def make_grating(
    src_w: int, src_h: int, theta: float, bias: float = 0.0
) -> np.ndarray:
    """Cosine grating image [src_h, src_w] float32: per-row debiased and
    power-normalized (frtest.cpp:181-215)."""
    i = np.arange(src_w, dtype=np.float64)
    row = np.cos(i * theta)
    row = row - row.mean()
    row = row / math.sqrt((row**2).mean())
    img = np.broadcast_to(row + bias, (src_h, src_w)).astype(np.float32)
    return np.ascontiguousarray(img)


def _rms(p: np.ndarray) -> float:
    return float(np.sqrt(np.mean(p.astype(np.float64) ** 2)))


def fr_dr_pe_at(
    resize_fn: Callable[[np.ndarray, int, int, float], np.ndarray],
    src: np.ndarray,
    ks: Sequence[float],
    offs: int = 32,
) -> tuple[float, float, float]:
    """Aggregate (FR_dB, DR_dB, PE_dB) over the k sweep for one grating.

    ``resize_fn(img, new_w, new_h, k)`` must resize with uniform factor k
    and no centering offset (the reference passes -k, frtest.cpp:108-118).
    """
    src_h, src_w = src.shape
    p1g = 1.0 / _rms(src[:, offs : src_w - offs])

    avgd = avgd2 = 0.0
    peakd = 0.0
    for k in ks:
        dw = math.ceil(src_w / k)
        dh = math.ceil(src_h / k)
        dst = resize_fn(src, dw, dh, k)
        back = resize_fn(dst, src_w, src_h, 1.0 / k)

        r = _rms(dst[:, offs : dw - offs])
        p2g = 1.0 / _rms(back[:, offs : src_w - offs])
        d = (
            src[:, offs : src_w - offs].astype(np.float64) * p1g
            - back[:, offs : src_w - offs].astype(np.float64) * p2g
        )
        avgd += r * r
        avgd2 += float(np.mean(d**2))
        peakd = max(peakd, float(np.abs(d).max()))

    n = len(ks)
    return (
        10.0 * math.log10(avgd / n),
        10.0 * math.log10(avgd2 / n),
        20.0 * math.log10(peakd) if peakd > 0 else -math.inf,
    )


def k_sweep(
    size_coeff: float = 0.3, k_step: float = 0.95, upsample: bool = True
) -> list[float]:
    """The reference's factor sweep: k = 1.0, *k_step while > size_coeff
    (frtest.cpp:222-241); downsampling uses 1/k."""
    ks = []
    k = 1.0
    while k > size_coeff:
        ks.append(k if upsample else 1.0 / k)
        k *= k_step
    return ks


def measure(
    algo: str = "avir",
    upsample: bool = True,
    n_freqs: int = 128,
    src_w: int = 1024 * 16,
    src_h: int = 12,
    size_coeff: float = 0.3,
    k_step: float = 0.95,
    min_f: float = 0.01,
    params=None,
    precision: str = "auto",
    device=None,
) -> np.ndarray:
    """Full FR/DR/PE table: rows [freq/Nyquist, FR_dB, DR_dB, PE_dB].

    Frequencies are log-spaced over [min_f, max_f] x pi with
    max_f = 0.99 (upsampling) or 0.99*size_coeff (downsampling)
    (frtest.cpp:160-168).
    """
    import avir_tpu_torch

    if algo == "avir":
        rz = avir_tpu_torch.ImageResizer(
            res_bit_depth=16,
            params=params if params is not None else avir_tpu_torch.PARAMS_DEF,
        )

        def resize_fn(img, w, h, k):
            return rz.resize(img, w, h, k=-k, precision=precision, device=device)

    elif algo == "lancir":
        lz = avir_tpu_torch.LancIR()

        def resize_fn(img, w, h, k):
            return lz.resize(
                img, w, h, kx=-k, ky=-k, precision=precision, device=device
            )

    else:
        raise ValueError(algo)

    max_f = 0.99 if upsample else 0.99 * size_coeff
    ks = k_sweep(size_coeff, k_step, upsample)
    out = np.empty((n_freqs, 4), dtype=np.float64)
    for j in range(n_freqs):
        f = math.exp(
            math.log(min_f)
            + math.log(max_f / min_f) * j / max(n_freqs - 1, 1)
        )
        src = make_grating(src_w, src_h, math.pi * f)
        fr, dr, pe = fr_dr_pe_at(resize_fn, src, ks)
        out[j] = (f, fr, dr, pe)
    return out


def whitenoise_roundtrip_rms(
    preset_name: str = "def",
    size: tuple[int, int] = (512, 512),
    k: float = 1.0,
    seed: int = 0,
    precision: str = "auto",
    device=None,
) -> float:
    """White-noise round-trip error, the reference's preset-optimization
    oracle (avir.h:2250-2259: presets were tuned to minimize the squared
    error of a round trip on a uniform-white-noise image).  Returns the
    RMS error in float units (input range [0, 1]); lower is better, and
    the published ordering is Ultra < High < Def < Low < LR < ULR."""
    import avir_tpu_torch

    h, w = size
    rng = np.random.default_rng(seed)
    src = rng.random((h, w), dtype=np.float32)
    rz = avir_tpu_torch.ImageResizer(
        res_bit_depth=16, params=avir_tpu_torch.preset(preset_name)
    )
    dw, dh = max(1, round(w / k)), max(1, round(h / k))
    mid = rz.resize(src, dw, dh, k=-k, precision=precision, device=device)
    back = rz.resize(mid, w, h, k=-(1.0 / k), precision=precision, device=device)
    o = 16  # ignore edge effects
    d = (
        src[o : h - o, o : w - o].astype(np.float64)
        - back[o : h - o, o : w - o].astype(np.float64)
    )
    return float(np.sqrt(np.mean(d * d)))
