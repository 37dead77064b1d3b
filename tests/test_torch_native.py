"""The port's native binding (avir_tpu_torch/native) against the JAX
package's (avir_tpu/native): the same PNG bytes and pixels, the same error
diffusion and generator words, and a loader that never writes into the
repository's native/ directory."""

import hashlib
import io
import os

import numpy as np
import pytest

from avir_tpu import native as jax_native

from avir_tpu_torch import native
from avir_tpu_torch.models.host_reference import errdiff_dither as np_errdiff

from conftest import xorshift128_fill


def _digest(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture()
def need_native():
    if not native.have_native():
        pytest.skip("no native library and no g++ to build one")


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_roundtrip(ch, dtype, need_native):
    img = xorshift128_fill((13, 17, ch), dtype, 42 + ch)
    data = native.png_encode(img)
    np.testing.assert_array_equal(native.png_decode(data), img)
    assert data == jax_native.png_encode(img)
    np.testing.assert_array_equal(jax_native.png_decode(data), img)


def test_png_cross_pillow(need_native):
    from PIL import Image

    img = xorshift128_fill((21, 33, 3), np.uint8, 7)
    pil = np.asarray(Image.open(io.BytesIO(native.png_encode(img))).convert("RGB"))
    np.testing.assert_array_equal(pil, img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    back = native.png_decode(buf.getvalue())
    np.testing.assert_array_equal(back.reshape(img.shape), img)


@pytest.mark.parametrize("tb", [0, 2])
def test_errdiff_matches_numpy_spec(tb, need_native):
    img = xorshift128_fill((9, 14, 3), np.uint16, 5).astype(np.float64) / 257.0
    a = native.errdiff_dither(img.copy(), tb, 255.0)
    np.testing.assert_array_equal(a, np_errdiff(img.copy(), tb, 255.0))
    np.testing.assert_array_equal(a, jax_native.errdiff_dither(img.copy(), tb, 255.0))


def test_errdiff_leaves_its_input(need_native):
    img = xorshift128_fill((9, 14, 3), np.uint16, 6).astype(np.float64) / 257.0
    keep = img.copy()
    native.errdiff_dither(img, 0, 255.0)
    np.testing.assert_array_equal(img, keep)


def test_errdiff_numpy_fallback(monkeypatch):
    """Without a library, errdiff_dither is the NumPy scan, the JAX
    package's fallback; the PNG codec raises."""
    monkeypatch.setattr(native, "_load", lambda: None)
    img = xorshift128_fill((7, 9, 2), np.uint16, 8).astype(np.float64) / 257.0
    np.testing.assert_array_equal(
        native.errdiff_dither(img, 0, 255.0), np_errdiff(img.copy(), 0, 255.0)
    )
    with pytest.raises(RuntimeError):
        native.png_encode(np.zeros((2, 2, 3), np.uint8))
    assert native.xs128_words(4, 1) is None


def test_xs128_words_match(need_native):
    np.testing.assert_array_equal(
        native.xs128_words(1000, 77), jax_native.xs128_words(1000, 77)
    )


def test_stale_library_builds_outside_native(tmp_path, monkeypatch):
    """A tracked library older than its source is not loaded: the loader
    builds into its build directory and never writes into native/."""
    if not native.SOURCE.exists() or os.system("g++ --version > /dev/null 2>&1"):
        pytest.skip("no g++")
    before = {p.name: _digest(p) for p in native.SOURCE.parent.iterdir() if p.is_file()}
    stale = tmp_path / "libavir_host.so"
    stale.write_bytes(native.TRACKED.read_bytes())
    old = native.SOURCE.stat().st_mtime - 3600
    os.utime(stale, (old, old))
    monkeypatch.setattr(native, "TRACKED", stale)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_path", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.have_native()
    assert native.library_path() == native.built_path()
    assert native.library_path().parent == tmp_path / "build"
    img = xorshift128_fill((5, 6, 3), np.uint8, 2)
    np.testing.assert_array_equal(native.png_decode(native.png_encode(img)), img)
    after = {p.name: _digest(p) for p in native.SOURCE.parent.iterdir() if p.is_file()}
    assert after == before
