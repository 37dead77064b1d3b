"""The port's metrology (avir_tpu_torch/metrology.py) on the CPU, a cheap
subset of tests/test_metrology.py: the same FR/DR/PE property gates on the
port's tables at the JAX test's reduced sizes, and the port's tables held
to the JAX package's on the same sweeps at the tolerances of its own
full-table spot check (FR 0.05 dB, DR 1 dB, PE 2 dB)."""

import numpy as np
import pytest
import torch

from avir_tpu import metrology as jax_metrology

from avir_tpu_torch.metrology import (
    k_sweep,
    make_grating,
    measure,
    whitenoise_roundtrip_rms,
)

torch.set_num_threads(1)
SWEEP = dict(upsample=True, n_freqs=6, src_w=2048, k_step=0.7)
DOWN = dict(upsample=False, n_freqs=3, src_w=2048, k_step=0.7, size_coeff=0.4)
PRESETS = ["ultra", "high", "def", "low", "lr", "ulr"]


def _held_to_jax(table, jax_table):
    assert table.shape == jax_table.shape
    np.testing.assert_array_equal(table[:, 0], jax_table[:, 0])
    assert np.abs(table[:, 1] - jax_table[:, 1]).max() <= 0.05
    assert np.abs(table[:, 2] - jax_table[:, 2]).max() <= 1.0
    assert np.abs(table[:, 3] - jax_table[:, 3]).max() <= 2.0


@pytest.fixture(scope="module")
def avir_up():
    return measure(algo="avir", device="cpu", **SWEEP)


@pytest.fixture(scope="module")
def lancir_up():
    return measure(algo="lancir", device="cpu", **SWEEP)


def test_avir_fr_flat_passband(avir_up):
    passband = avir_up[avir_up[:, 0] <= 0.6]
    assert len(passband) >= 4
    assert np.abs(passband[:, 1]).max() <= 0.15, passband


def test_avir_dr_high_at_low_freq(avir_up):
    low = avir_up[avir_up[:, 0] <= 0.1]
    assert (low[:, 2] <= -70.0).all(), low
    assert (low[:, 3] <= -55.0).all(), low


def test_avir_dr_degrades_toward_nyquist(avir_up):
    assert avir_up[-1, 2] > avir_up[0, 2] + 20.0


def test_avir_beats_lancir_dr(avir_up, lancir_up):
    low_a = avir_up[avir_up[:, 0] <= 0.2][:, 2]
    low_l = lancir_up[lancir_up[:, 0] <= 0.2][:, 2]
    assert (low_a <= low_l - 8.0).all(), (low_a, low_l)


@pytest.mark.parametrize("algo", ["avir", "lancir"])
def test_tables_match_jax(algo, avir_up, lancir_up):
    table = avir_up if algo == "avir" else lancir_up
    _held_to_jax(table, jax_metrology.measure(algo=algo, **SWEEP))


def test_downsample_dr():
    t = measure(algo="avir", device="cpu", **DOWN)
    low = t[t[:, 0] <= 0.1]
    assert (low[:, 2] <= -60.0).all(), t
    _held_to_jax(t, jax_metrology.measure(algo="avir", **DOWN))


def test_grating_properties():
    g = make_grating(512, 4, np.pi * 0.25)
    assert abs(float(g.mean())) < 1e-6
    assert abs(float((g.astype(np.float64) ** 2).mean()) - 1.0) < 1e-6
    np.testing.assert_array_equal(g, jax_metrology.make_grating(512, 4, np.pi * 0.25))


def test_k_sweep_matches_reference():
    ks = k_sweep(0.3, 0.95, True)
    assert ks[0] == 1.0 and all(k > 0.3 for k in ks) and len(ks) == 24
    assert ks == jax_metrology.k_sweep(0.3, 0.95, True)
    assert k_sweep(0.3, 0.7, False) == jax_metrology.k_sweep(0.3, 0.7, False)


def test_preset_quality_ordering():
    """White-noise round trips keep the published preset ordering, Ultra <
    High < Def < Low < LR < ULR, and the JAX package's scores within
    1e-6 (float32 pipelines, sums in another order)."""
    scores = [
        whitenoise_roundtrip_rms(p, size=(192, 192), k=1.4142, device="cpu")
        for p in PRESETS
    ]
    assert all(a < b for a, b in zip(scores, scores[1:])), scores
    jax_scores = [
        jax_metrology.whitenoise_roundtrip_rms(p, size=(192, 192), k=1.4142)
        for p in PRESETS
    ]
    assert np.abs(np.array(scores) - np.array(jax_scores)).max() <= 1e-6
