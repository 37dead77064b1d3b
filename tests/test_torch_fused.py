"""K1 int8 mode in the port: the plain PyTorch version is bit-equal to the
JAX package's Pallas kernel (interpret mode, on the CPU), on the port's
own blocked operators and on the JAX package's plans carried across by
``avir_tpu_torch.convert``.  The kernel itself is held against the plain
version on the card only (tests/test_torch_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avir_tpu.ops.banded import block_banded as jax_block_banded
from avir_tpu.ops.lanes import lane_block_banded as jax_lane_block_banded
from avir_tpu.ops.pallas.fused_kernel import apply_fused_pallas
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from torch_cases import FUSED_CASES as CASES

from avir_tpu_torch.convert import resize_plan_from_numpy
from avir_tpu_torch.ops.banded import block_banded
from avir_tpu_torch.ops.cuda import fused_kernel as fk
from avir_tpu_torch.ops.lanes import lane_block_banded
from avir_tpu_torch.plan.plan import build_resize_plan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _order(sw, sh, nw, nh):
    return "vh" if nw * nh <= sw * sh else "hv"


def _jax_fused(plan, x, c, order, tile):
    vop = jax_block_banded(plan.v.op)
    lop = jax_lane_block_banded(plan.h.op, c, tile=tile)
    out = apply_fused_pallas(
        vop, lop, jnp.asarray(x), "int8", "int8", out_dtype=jnp.uint8,
        out_max=255.0, order=order, interpret=True,
    )
    return np.asarray(out)[: vop.n_out, : lop.n_out * c], lop


def _port_plain(plan, x, c, order, tile):
    vop = block_banded(plan.v.op)
    lop = lane_block_banded(plan.h.op, c, tile=tile)
    ops = fk.prepare_fused_int8(vop, lop, order, "cpu")
    return fk.apply_fused_int8(ops, torch.from_numpy(x)).numpy(), lop


def _plan_fields(plan):
    fields = {
        f.name: getattr(plan, f.name)
        for f in dataclasses.fields(plan) if f.name not in ("h", "v")
    }
    for axis in ("h", "v"):
        ap = getattr(plan, axis)
        fields[axis] = (
            ap.op.n_in, ap.op.n_out, np.asarray(ap.op.starts),
            np.asarray(ap.op.taps), ap.build_mode, ap.k, ap.o,
        )
    return fields


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_int8(name):
    sw, sh, nw, nh, c, tile = CASES[name]
    order = _order(sw, sh, nw, nh)
    x = np.random.default_rng(sum(map(ord, name))).integers(
        0, 256, (sh, sw * c), dtype=np.uint8
    )
    jplan = jax_build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    ref, jlop = _jax_fused(jplan, x, c, order, tile)

    plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8)
    got, lop = _port_plain(plan, x, c, order, tile)
    assert (lop.chunk_rel is None) == (jlop.chunk_rel is None)
    assert got.shape == ref.shape == (nh, nw * c)
    np.testing.assert_array_equal(got, ref)

    # The JAX package's own plan, carried across.
    conv, _ = _port_plain(
        resize_plan_from_numpy(_plan_fields(jplan)), x, c, order, tile
    )
    np.testing.assert_array_equal(conv, ref)


@pytest.mark.parametrize("order", ["vh", "hv"])
def test_plain_matches_pallas_other_order(order):
    """Either pass order runs either resize direction."""
    sw, sh, nw, nh, c = 96, 80, 70, 101, 3
    x = np.random.default_rng(5).integers(
        0, 256, (sh, sw * c), dtype=np.uint8
    )
    ref, _ = _jax_fused(
        jax_build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8),
        x, c, order, None,
    )
    got, _ = _port_plain(
        build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8),
        x, c, order, None,
    )
    np.testing.assert_array_equal(got, ref)


def test_cpu_tensor_takes_plain_version():
    plan = build_resize_plan(40, 30, 20, 15, 3, np.uint8, np.uint8)
    ops = fk.prepare_fused_int8(
        block_banded(plan.v.op), lane_block_banded(plan.h.op, 3), "vh", "cpu"
    )
    x = torch.randint(0, 256, (30, 120), dtype=torch.uint8)
    before = dict(fk.launches)
    out = fk.apply_fused_int8(ops, x)
    assert fk.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, fk.apply_fused_int8_reference(ops, x))


def test_wrapper_never_falls_back_off_the_cpu():
    """Operands off the CPU with a CPU image (or the reverse) raise: only
    a CPU image with CPU operands takes the plain version."""
    plan = build_resize_plan(40, 30, 20, 15, 3, np.uint8, np.uint8)
    vop, lop = block_banded(plan.v.op), lane_block_banded(plan.h.op, 3)
    x = torch.zeros((30, 120), dtype=torch.uint8)
    ops = fk.prepare_fused_int8(vop, lop, "vh", "meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fk.apply_fused_int8(ops, x)
    ops = fk.prepare_fused_int8(vop, lop, "vh", "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        fk.apply_fused_int8(ops, x.to("meta"))


def test_pack4_layout():
    q = np.arange(-64, 64, dtype=np.int8).reshape(1, 8, 16)
    q = np.repeat(q, 8, axis=2)  # [1, 8, 128]
    p = fk._pack4(q)
    assert p.shape == (1, 2, 128)
    for k in range(8):
        got = (p[0, k // 4] >> (8 * (k % 4))) & 0xFF
        np.testing.assert_array_equal(got, q[0, k].view(np.uint8))
