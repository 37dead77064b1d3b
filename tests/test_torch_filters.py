"""The port's filter design (avir_tpu_torch/filters) against the golden
dumps of the compiled reference library (f_window, f_lpf_*, f_eq*,
f_bank_*, f_lanc_*), at tests/test_filters.py's tolerances, and against
the JAX package's filters on the same arguments."""

import numpy as np
import pytest

from conftest import load_golden

from avir_tpu import filters as jax_filters
from avir_tpu.filters.lanczos import LanczosBank as JaxLanczosBank

from avir_tpu_torch.filters import (
    FirEq,
    FracFilterBank,
    LanczosBank,
    calc_fir_response,
    lanczos_filter,
    normalize_fir,
    peaked_cosine_lpf,
    peaked_cosine_window,
)


@pytest.mark.parametrize(
    "name, args", [("f_window", (4.76449, 24.5, 25)), ("f_window2", (1.0, 7.3, 8))]
)
def test_peaked_cosine_window(name, args):
    got = peaked_cosine_window(*args)
    np.testing.assert_allclose(got, load_golden(name), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got, jax_filters.peaked_cosine_window(*args))


@pytest.mark.parametrize(
    "name, args, dc_gain",
    [
        ("f_lpf_norm", (9.2, 1.3, 4.76449), 1.0),
        ("f_lpf_raw", (9.2, 1.3, 4.76449), 0.0),
        ("f_lpf_hb", (24.0, np.pi * 0.46437 * 2.0, 1.94609), 1.0),
    ],
)
def test_peaked_cosine_lpf(name, args, dc_gain):
    got = peaked_cosine_lpf(*args, dc_gain=dc_gain)
    ref = load_golden(name)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got, jax_filters.peaked_cosine_lpf(*args, dc_gain=dc_gain))


@pytest.mark.parametrize(
    "name, args",
    [
        ("f_eq", (2.0, 6.4262, 65, 0.0, 1.0, False, 0.97946)),
        ("f_eq_bw", (2.0 * 0.31, 7.0, 65, 0.0, 0.31, False, 1.2)),
    ],
)
def test_fir_eq(name, args):
    bins = 1.0 + 0.5 * np.sin(np.arange(65) * 0.3)
    eq = FirEq(*args)
    if name == "f_eq":
        meta = load_golden("f_eq_meta")
        assert (eq.filter_len, eq.latency) == (meta[0], meta[1])
    got = eq.build_filter(bins)
    np.testing.assert_allclose(got, load_golden(name), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got, jax_filters.FirEq(*args).build_filter(bins))


def test_fir_response_against_eq_design():
    bins = 1.0 + 0.3 * np.sin(np.arange(65) * 0.08)
    eq = FirEq(2.0, 30.0, 65, 0.0, 1.0, False, 1.2)
    flt = eq.build_filter(bins)
    for j in [5, 20, 40]:
        re, im = calc_fir_response(flt, np.pi * j / 64, fltlat=eq.latency)
        assert abs(np.hypot(re, im) - bins[j]) < 0.05
        jre, jim = jax_filters.calc_fir_response(flt, np.pi * j / 64, fltlat=eq.latency)
        assert (re, im) == (jre, jim)


def test_normalize_fir():
    out = normalize_fir(np.array([1.0, 2.0, 3.0]), 2.0)
    assert abs(out.sum() - 2.0) < 1e-15


@pytest.mark.parametrize(
    "name,frac_count,order,base_len,cutoff,alpha,ids",
    [
        ("f_bank_o1", 10, 1, 18.0 / 0.7, 0.7372 * 0.7, 6.41341, [0, 3, 9]),
        ("f_bank_o0", 44, 0, 18.0, 0.7372, 6.41341, [0, 21, 43]),
    ],
)
def test_frac_filter_bank(name, frac_count, order, base_len, cutoff, alpha, ids):
    meta = load_golden(name + "_meta")
    bank = FracFilterBank(frac_count, order, base_len, cutoff, alpha)
    jbank = jax_filters.FracFilterBank(frac_count, order, base_len, cutoff, alpha)
    assert bank.filter_len == meta[0]
    ref = load_golden(name)
    for row, i in enumerate(ids):
        if order == 1:
            np.testing.assert_allclose(bank.filters[i], ref[row, 0], rtol=0, atol=2e-7)
            np.testing.assert_allclose(bank.deltas[i], ref[row, 1], rtol=0, atol=2e-7)
        else:
            np.testing.assert_allclose(bank.filters[i], ref[row], rtol=0, atol=2e-7)
    np.testing.assert_array_equal(np.asarray(bank.filters), np.asarray(jbank.filters))


def test_frac_filter_bank_ext():
    meta = load_golden("f_bank_ext_meta")
    ext = peaked_cosine_lpf(6.0, 2.2, 4.0, dc_gain=2.0)
    bank = FracFilterBank(10, 1, 18.0, 0.7372, 6.41341, ext_filter=ext)
    assert bank.filter_len == meta[0]
    ref = load_golden("f_bank_ext")
    for row, i in enumerate([0, 5, 9]):
        np.testing.assert_allclose(bank.filters[i], ref[row, 0], rtol=0, atol=2e-6)
        np.testing.assert_allclose(bank.deltas[i], ref[row, 1], rtol=0, atol=2e-6)


@pytest.mark.parametrize(
    "name,la,k,fracs",
    [
        ("f_lanc_k17", 3.0, 1.7, [0.0, 0.37, 0.5, 1.0]),
        ("f_lanc_k08", 2.0, 0.8, [0.0, 0.25, 0.662, 1.0]),
    ],
)
def test_lanczos_filters(name, la, k, fracs):
    meta = load_golden(name + "_meta")
    ref = load_golden(name)
    bank, jbank = LanczosBank(la, k), JaxLanczosBank(la, k)
    assert bank.kernel_len == meta[0]
    for row, x in enumerate(fracs):
        got = bank.filter_for_frac(x)
        np.testing.assert_allclose(got, ref[row], rtol=0, atol=3e-7)
        np.testing.assert_array_equal(got, np.asarray(jbank.filter_for_frac(x)))


def test_lanczos_dc_gain():
    for d in [0.0, 0.123, 0.5, 0.999, 1.0]:
        assert abs(lanczos_filter(3.0, 2.3, d).sum(dtype=np.float64) - 1.0) < 1e-6
