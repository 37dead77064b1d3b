"""The port's ditherers against the JAX package's: the plain version of K4
(the wavefront error diffusion) against ``errdiff_dither_wavefront_jnp``
on its XLA route and on its Pallas kernels in interpret mode, single
block and row-blocked; both against the port's float64 serial oracle;
and the default ditherer.  The kernel itself is held against the plain
version on the card only (tests/test_torch_cuda.py).

Tolerances are the JAX package's own (tests/test_dither.py,
ops/pallas/wavefront_kernel.py:25-30): bit-equal for unit-step
quantization (``trunc_bits=0``), within one quantization step otherwise,
and within one step of the serial float64 scan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avir_tpu.ops.dither import (
    default_dither_jnp,
    errdiff_dither_wavefront_jnp,
)

from torch_cases import WAVEFRONT_CASES, float_image

from avir_tpu_torch.models import host_reference
from avir_tpu_torch.ops import dither
from avir_tpu_torch.ops.cuda import wavefront as wf

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _port(img, tb, out_max, block_rows=None):
    return wf.errdiff_wavefront(
        torch.from_numpy(img), tb, out_max, block_rows=block_rows
    ).numpy()


def _step(tb, out_max):
    return dither.trunc_mul(tb, out_max)


@pytest.mark.parametrize("h, w, c, tb, om", WAVEFRONT_CASES)
def test_plain_matches_xla_wavefront(h, w, c, tb, om):
    img = float_image(h, w, c, om, h * w + c)
    ref = np.asarray(
        errdiff_dither_wavefront_jnp(jnp.asarray(img), tb, om, engine="xla")
    )
    got = _port(img, tb, om)
    if tb == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= _step(tb, om)


@pytest.mark.parametrize("h, w, c, tb, om", WAVEFRONT_CASES)
def test_plain_matches_pallas_interpret(h, w, c, tb, om):
    """Single block (``wavefront_scan_pallas``) and row blocks of 8
    (``wavefront_scan_pallas_carry``), each against the port run with
    the same and with other block sizes."""
    img = float_image(h, w, c, om, 3 * h + w)
    tol = 0.0 if tb == 0 else _step(tb, om)
    for block_rows, port_rows in ((None, None), (8, 8), (8, 5)):
        ref = np.asarray(
            errdiff_dither_wavefront_jnp(
                jnp.asarray(img), tb, om, interpret=True, pallas_chunk=8,
                block_rows=block_rows if block_rows else h,
            )
        )
        got = _port(img, tb, om, block_rows=port_rows)
        assert np.abs(got - ref).max() <= tol, (block_rows, port_rows)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_blocked_equals_single_block(c):
    img = float_image(37, 23, c, 255.0, c)
    one = _port(img, 0, 255.0, block_rows=37)
    for rows in (1, 4, 10, 36):
        np.testing.assert_array_equal(_port(img, 0, 255.0, block_rows=rows), one)


@pytest.mark.parametrize(
    "h, w, c, tb, om",
    [(16, 24, 3, 0, 255.0), (14, 20, 1, 0, 65535.0), (12, 18, 4, 2, 255.0),
     (13, 17, 3, 4, 65535.0)],
)
def test_plain_matches_serial_oracle(h, w, c, tb, om):
    img = float_image(h, w, c, om, 7 * h + c).astype(np.float64)
    oracle = host_reference.errdiff_dither(img, tb, om)
    got = _port(img.astype(np.float32), tb, om)
    # One quantization step, plus the float32 rounding of the step
    # multiples themselves (tests/test_dither.py's sweep tolerance).
    assert np.abs(got - oracle).max() <= _step(tb, om) * 1.001


def test_default_dither_matches_jax():
    rng = np.random.default_rng(5)
    v = (rng.random((40, 60)) * 300.0 - 20.0).astype(np.float32)
    for tb, om in ((0, 255.0), (2, 255.0), (0, 65535.0), (4, 65535.0)):
        vv = v * (om / 255.0)
        ref = np.asarray(default_dither_jnp(jnp.asarray(vv), tb, om))
        got = dither.default_dither(torch.from_numpy(vv), tb, om).numpy()
        np.testing.assert_array_equal(got, ref)
        if tb == 0:  # with truncation the float64 step differs in its last bits
            np.testing.assert_array_equal(
                got, host_reference.default_dither(vv.astype(np.float64), 0, om)
            )


def test_output_types_and_cast():
    img = float_image(9, 11, 3, 255.0, 1)
    f = _port(img, 0, 255.0)
    u8 = wf.errdiff_wavefront(torch.from_numpy(img), 0, 255.0, out_dtype=torch.uint8)
    assert u8.dtype == torch.uint8
    np.testing.assert_array_equal(u8.numpy(), f.astype(np.uint8))
    with pytest.raises(ValueError, match="output dtype"):
        wf.errdiff_wavefront(torch.from_numpy(img), 0, 255.0, out_dtype=torch.int8)


def test_quant_steps_reciprocal_is_float32():
    tm, tmi = wf.quant_steps(4, 65535.0)
    assert tm == float(np.float32(65535.0 / 4095))
    assert tmi == float(np.float32(1.0) / np.float32(tm))


def test_chain_steps():
    assert wf.chain_steps(1080, 1920, 3) == (
        3 * (1920 + 2 * 340) + (1920 + 2 * 56)
    )
    assert wf.chain_steps(10, 7, 1, block_rows=10) == 7 + 18
