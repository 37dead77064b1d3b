"""Shared pieces of the harness's own tests."""

from __future__ import annotations

import numpy as np

from portbench import harness, spec


def xs128_u8(n: int, seed: int) -> np.ndarray:
    """The golden generator's u8 image fill (``tests/golden/src/gen_golden.cpp``:
    XS128 seeded by ``seed``, 16 draws discarded, the top byte of each)."""
    m = 0xFFFFFFFF
    x = (123456789 ^ (seed * 2654435761)) & m
    y = (362436069 ^ (seed * 0x9E3779B9)) & m
    z = (521288629 + seed) & m
    w = (88675123 ^ (seed << 7)) & m
    out = np.empty(n + 16, dtype=np.uint8)
    for i in range(n + 16):
        t = (x ^ (x << 11)) & m
        x, y, z = y, z, w
        w = (w ^ (w >> 19) ^ t ^ (t >> 8)) & m
        out[i] = w >> 24
    return out[16:]


def small_cell(name: str, scale: int = 32):
    """A cell of BENCHMARK.json and its geometry divided by ``scale``."""
    cell = spec.load_cell(spec.load_benchmark(), name)
    return cell, harness.geometry(cell.traffic, scale)


# Every cell of BENCHMARK.json, in its order.
CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])
