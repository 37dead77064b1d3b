"""The roofline's band-MAC and byte counts against a direct count from
the dense operators."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline
from portbench.reference import avir, lancir

from .helpers import CELLS, small_cell

AVIR = {"resizer": "avir", "preset": "def", "channels": 3, "in_dtype": "uint8",
        "out_dtype": "uint8", "use_srgb_gamma": False, "dither": "default",
        "res_bit_depth": 8}
LANCIR = {"resizer": "lancir", "la": 3.0, "channels": 3, "in_dtype": "uint8",
          "out_dtype": "uint8"}


def direct_macs(ref, c: int, order: str) -> int:
    """Multiply-adds of each pass counted by multiplying the operators'
    nonzero patterns with the shape of what they act on."""
    (nh, h), (nw, w) = ref.v.shape, ref.h.shape
    pv, ph = (ref.v != 0).astype(np.int64), (ref.h != 0).astype(np.int64)
    if order == "vh":
        first = pv @ np.ones((h, w * c), dtype=np.int64)
        second = np.ones((nh * c, w), dtype=np.int64) @ ph.T
    else:
        first = np.ones((h * c, w), dtype=np.int64) @ ph.T
        second = pv @ np.ones((h, nw * c), dtype=np.int64)
    return int(first.sum() + second.sum())


CASES = [
    (avir, AVIR, (257, 193), (64, 48), "vh"),
    (avir, AVIR, (97, 61), (151, 83), "hv"),
    (lancir, LANCIR, (160, 120), (97, 73), "vh"),
    (lancir, LANCIR, (97, 61), (151, 83), "hv"),
]


@pytest.mark.parametrize("module,config,src,dst,order", CASES)
def test_counts_equal_a_direct_count(module, config, src, dst, order):
    ref = module.build(config, src, dst)
    assert ref.order == order
    assert roofline.band_macs(ref, 3) == direct_macs(ref, 3, order)
    (w, h), (nw, nh) = src, dst
    x = np.zeros((h, w, 3), np.uint8)
    y = np.zeros((nh, nw, 3), np.uint8)
    taps = np.count_nonzero(ref.v) + np.count_nonzero(ref.h)
    assert roofline.frame_bytes(ref, 3, 1, 1) == x.nbytes + y.nbytes + 4 * taps
    b = roofline.bound(ref, 3, 1, 1)
    assert b["ops"] == 2 * direct_macs(ref, 3, order)
    assert b["bound_s"] == max(b["bytes"] / 3.35e12, b["ops"] / 1.979e15)


def test_the_cells_full_size_bounds():
    """The two cells at their own size: the bytes set each bound."""
    from portbench import harness, spec

    bench = spec.load_benchmark()
    got = {}
    for name in CELLS:
        cell = spec.load_cell(bench, name)
        src, dst = harness.geometry(cell.traffic)
        ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
        got[name] = (ref.order, roofline.band_macs(ref, 3), roofline.bound(ref, 3, 1, 1))
    order, macs, b = got[CELLS[0]]
    assert order == "vh" and b["bound_by"] == "bytes"
    assert 1.3e9 < macs < 1.45e9  # V ~1.00 G + H ~0.37 G at ~50 taps a row
    assert 18.0e-6 < b["bound_s"] < 18.6e-6  # 53.7 MB in, 7.4 MB out, taps
    order, macs, b = got[CELLS[1]]
    assert order == "hv" and b["bound_by"] == "bytes"
    assert 0.2e9 < macs < 0.25e9  # 6 taps a row at 2x up
    assert 9.2e-6 < b["bound_s"] < 9.5e-6  # 6.2 MB in, 24.9 MB out


def test_small_cells_keep_their_order():
    """A cell cut by 32 keeps its full size's pass order: vh where the
    frame shrinks, hv where it grows."""
    from portbench import spec

    for name in CELLS:
        cell, (src, dst) = small_cell(name)
        ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
        (w, h), (nw, nh) = cell.traffic["src"], cell.traffic["dst"]
        assert ref.order == ("vh" if nw * nh <= w * h else "hv")
