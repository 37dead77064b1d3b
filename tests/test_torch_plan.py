"""The port's host planner builds the same banded operators as the JAX
package's on every AVIR golden config (starts and taps array-equal)."""

import json

import numpy as np
import pytest

from conftest import GOLDEN_DIR

import avir_tpu
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

import avir_tpu_torch
from avir_tpu_torch.convert import banded_op_from_numpy
from avir_tpu_torch.plan.plan import build_resize_plan

DT = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32,
      "f64": np.float64}

with open(GOLDEN_DIR / "manifest.json") as f:
    _M = json.load(f)
AVIR_CONFIGS = [n for n, c in _M.items() if c.get("kind") == "avir"]


def plan_args(cfg):
    return dict(
        src_w=cfg["sw"], src_h=cfg["sh"], new_w=cfg["nw"], new_h=cfg["nh"],
        el_count=cfg["ch"], in_dtype=DT[cfg["tin"]],
        out_dtype=DT[cfg["tout"]], k=cfg["k"], ox=cfg["ox"], oy=cfg["oy"],
        res_bit_depth=cfg["bitdepth"], use_srgb_gamma=bool(cfg["gamma"]),
        alpha_index=cfg["alphaidx"],
    )


@pytest.mark.parametrize("name", AVIR_CONFIGS)
def test_plan_matches_jax(name):
    cfg = _M[name]
    ref = jax_build_resize_plan(
        params=avir_tpu.preset(cfg["preset"]), **plan_args(cfg)
    )
    got = build_resize_plan(
        params=avir_tpu_torch.preset(cfg["preset"]), **plan_args(cfg)
    )
    for axis in ("h", "v"):
        r, g = getattr(ref, axis), getattr(got, axis)
        assert (g.build_mode, g.k, g.o) == (r.build_mode, r.k, r.o)
        assert (g.op.n_in, g.op.n_out) == (r.op.n_in, r.op.n_out)
        np.testing.assert_array_equal(g.op.starts, r.op.starts)
        np.testing.assert_array_equal(g.op.taps, r.op.taps)
    for field in (
        "src_w", "src_h", "new_w", "new_h", "el_count", "use_srgb_gamma",
        "in_gamma_mult", "out_gamma_mult", "alpha_index", "is_in_float",
        "is_out_float", "in_type_max", "out_type_max", "res_bit_depth",
        "out_float64",
    ):
        assert getattr(got, field) == getattr(ref, field), field


def test_presets_match_jax():
    for name in ("def", "ulr", "lr", "low", "high", "ultra"):
        assert (
            avir_tpu_torch.preset(name).cache_key()
            == avir_tpu.preset(name).cache_key()
        )


@pytest.mark.parametrize(
    "n_in, n_out, starts, width",
    [(10, 4, [0, 2, 4], 3), (10, 3, [0, 2, 8], 3)],
)
def test_convert_rejects_malformed_operators(n_in, n_out, starts, width):
    with pytest.raises(ValueError):
        banded_op_from_numpy(n_in, n_out, starts, np.ones((len(starts), width)))
