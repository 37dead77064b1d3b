"""The plain reference: a float64 dense resize, and upstream's own output."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import avir, lancir

from .helpers import xs128_u8
from .test_pb_counts import AVIR, LANCIR

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden" / "data"


@pytest.mark.parametrize(
    "module,config,src,dst",
    [
        (avir, AVIR, (37, 29), (16, 12)),
        (avir, AVIR, (23, 17), (41, 30)),
        (lancir, LANCIR, (37, 29), (16, 12)),
        (lancir, LANCIR, (23, 17), (41, 30)),
    ],
)
def test_reference_is_a_float64_dense_resize(module, config, src, dst):
    """``forward`` equals out[i, j] = sum_a sum_b V[i, a] H[j, b] x[a, b]
    written out in NumPy, in either pass order; ``finish`` rounds as the
    configuration states and clamps."""
    ref = module.build(config, src, dst)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (src[1], src[0], 3), dtype=np.uint8)
    want = np.einsum("ia,jb,abc->ijc", ref.v, ref.h, x.astype(np.float64)) * ref.out_mul
    got = ref.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    y = torch.tensor([-3.0, 0.5, 1.5, 2.5, 254.5, 300.0], dtype=torch.float64)
    rounded = ref.finish(y).tolist()
    if ref.rounding == "half_up":
        assert rounded == [0.0, 1.0, 2.0, 3.0, 255.0, 255.0]
    else:
        assert rounded == [0.0, 0.0, 2.0, 2.0, 254.0, 255.0]


@pytest.mark.parametrize("name", ["a_down3u8", "a_up3u8", "a_down8x", "l_up3u8", "l_down4u8"])
def test_reference_equals_upstream(name):
    """Against the C++ library's own 8-bit output (float32 inside), held
    in ``tests/golden/data``: equal on every value of these images."""
    entry = json.loads((GOLDEN / "manifest.json").read_text())[name]
    sw, sh, nw, nh, ch = (entry[k] for k in ("sw", "sh", "nw", "nh", "ch"))
    x = xs128_u8(sw * sh * ch, entry["seed"]).reshape(sh, sw, ch)
    if entry["kind"] == "avir":
        ref = avir.build({**AVIR, "channels": ch, "preset": entry["preset"]}, (sw, sh), (nw, nh))
    else:
        ref = lancir.build({**LANCIR, "channels": ch, "la": entry["la"]}, (sw, sh), (nw, nh))
    got = ref.finish(ref.forward(torch.from_numpy(x))).numpy()
    want = np.load(GOLDEN / f"{name}.npy").astype(np.float64)
    np.testing.assert_array_equal(got, want)
