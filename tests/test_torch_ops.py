"""The port's blocked operators (ops/banded.py, ops/lanes.py) and limb
quantizer (ops/intq.py) equal the JAX package's exactly on the AVIR
golden plans: geometry, bf16 hi/lo bit patterns, s8 limbs, shifts and
norms."""

import numpy as np
import pytest
import torch

import avir_tpu
from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.intq import quantize_limbs as jax_quantize_limbs
from avir_tpu.ops.lanes import lane_block_banded as jax_lane_block_banded
from avir_tpu.ops.lanes import lane_chunk_geometry as jax_lane_chunk_geometry
from avir_tpu.ops.lanes import pick_lane_tile as jax_pick_lane_tile
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

import avir_tpu_torch
from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.intq import quantize_limbs
from avir_tpu_torch.ops.lanes import (
    lane_block_banded,
    lane_chunk_geometry,
    pick_lane_tile,
)
from avir_tpu_torch.plan.plan import build_resize_plan

from test_torch_plan import AVIR_CONFIGS, _M, plan_args

torch.set_num_threads(1)


def _in_bytes(cfg):
    return {"u8": 1, "u16": 2}.get(cfg["tin"], 4)


def _bits(a):
    """Bit pattern of a bf16 array (ml_dtypes numpy or torch tensor)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _same(got, ref):
    if ref is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _plans(name):
    cfg = _M[name]
    ref = jax_build_resize_plan(
        params=avir_tpu.preset(cfg["preset"]), **plan_args(cfg)
    )
    got = build_resize_plan(
        params=avir_tpu_torch.preset(cfg["preset"]), **plan_args(cfg)
    )
    return cfg, ref, got


@pytest.mark.parametrize("name", AVIR_CONFIGS)
def test_block_banded_matches_jax(name):
    cfg, ref_plan, plan = _plans(name)
    nb = _in_bytes(cfg)
    for axis in ("h", "v"):
        r = jax_block_banded(getattr(ref_plan, axis).op, in_bytes=nb)
        g = block_banded(getattr(plan, axis).op, in_bytes=nb)
        for f in ("n_in", "n_out", "n_in_pad", "tile", "win", "q_shift",
                  "l1_max", "q_abs1", "q_abs0"):
            assert getattr(g, f) == getattr(r, f), f
        _same(g.offs, r.offs)
        _same(g.taps, r.taps)
        _same(_bits(g.taps_hi), _bits(r.taps_hi))
        _same(_bits(g.taps_lo), _bits(r.taps_lo))
        _same(g.taps_q1, r.taps_q1)
        _same(g.taps_q0, r.taps_q0)


@pytest.mark.parametrize("name", AVIR_CONFIGS)
def test_lane_block_banded_matches_jax(name):
    cfg, ref_plan, plan = _plans(name)
    nb, c = _in_bytes(cfg), cfg["ch"]
    r = jax_lane_block_banded(ref_plan.h.op, c, in_bytes=nb)
    g = lane_block_banded(plan.h.op, c, in_bytes=nb)
    for f in ("n_in", "n_out", "c", "tile", "win_l", "lanes_pad", "q_shift",
              "chunk_rel", "win_c", "l1_max", "q_abs1", "q_abs0"):
        assert getattr(g, f) == getattr(r, f), f
    _same(g.offs_l, r.offs_l)
    _same(_bits(g.taps_hi), _bits(r.taps_hi))
    _same(_bits(g.taps_lo), _bits(r.taps_lo))
    _same(g.taps_q1, r.taps_q1)
    _same(g.taps_q0, r.taps_q0)
    if r.ctaps_hi is None:
        assert g.ctaps_hi is None and g.ctaps_q1 is None
    else:
        _same(_bits(g.ctaps_hi), _bits(r.ctaps_hi))
        _same(_bits(g.ctaps_lo), _bits(r.ctaps_lo))
        _same(g.ctaps_q1, r.ctaps_q1)
        _same(g.ctaps_q0, r.ctaps_q0)


@pytest.mark.parametrize(
    "sw, nw, c, in_bytes",
    [(1920, 3840, 3, 1), (1024, 4096, 4, 2), (2048, 512, 3, 1),
     (700, 1400, 1, 4)],
)
def test_lane_tiles_and_subsets_match_jax(sw, nw, c, in_bytes):
    ref_op = jax_build_resize_plan(sw, 8, nw, 8, c, np.uint8, np.uint8).h.op
    op = build_resize_plan(sw, 8, nw, 8, c, np.uint8, np.uint8).h.op
    tile = pick_lane_tile(op, c, in_bytes=in_bytes)
    assert tile == jax_pick_lane_tile(ref_op, c, in_bytes=in_bytes)
    assert lane_chunk_geometry(op, c, tile) == jax_lane_chunk_geometry(
        ref_op, c, tile
    )
    n_blocks = -(-op.n_out // tile)
    subset = list(range(1, n_blocks - 1)) or [0]
    r = jax_lane_block_banded(ref_op, c, tile=tile, block_list=subset)
    g = lane_block_banded(op, c, tile=tile, block_list=subset)
    assert (g.chunk_rel, g.win_c) == (r.chunk_rel, r.win_c)
    _same(g.out_idx, r.out_idx)
    _same(g.offs_l, r.offs_l)
    _same(g.taps_q1, r.taps_q1)
    _same(g.ctaps_q0, r.ctaps_q0)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_limbs_matches_jax(seed):
    rng = np.random.default_rng(seed)
    taps = rng.normal(0.0, 10.0 ** rng.uniform(-3, 2), (7, 33))
    q1, q0, s = quantize_limbs(taps)
    r1, r0, rs = jax_quantize_limbs(taps)
    assert s == rs
    _same(q1, r1)
    _same(q0, r0)
    q1, q0, s = quantize_limbs(taps, shift=5)
    r1, r0, rs = jax_quantize_limbs(taps, shift=5)
    assert s == rs == 5
    _same(q1, r1)
    _same(q0, r0)
