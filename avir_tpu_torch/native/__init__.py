"""ctypes binding of the native host runtime (``native/avir_host.cpp``).

Counterpart of the JAX package's ``native/__init__.py``, with the same
entry points and C signatures: ``errdiff_dither`` (the reference's serial
error-diffusion scan in float64), ``xs128_words`` (the tests' xorshift128
generator), ``png_encode`` and ``png_decode`` (8- and 16-bit PNG with
zlib).

The library is the repository's ``native/libavir_host.so`` when it is not
older than its source.  Otherwise (absent, or stale) it is built with
``g++ -O2 -shared -fPIC ... -lz`` into ``build/native/`` at the root of
the checkout, named by a digest of the source, so an edited source is
rebuilt and a stale library is never loaded.  This module never writes
into ``native/``.  Without a library, ``errdiff_dither`` runs the NumPy
scan of ``models/host_reference.py`` (the same host function, as in the
JAX package) and the PNG codec raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "avir_host.cpp"
TRACKED = _ROOT / "native" / "libavir_host.so"
BUILD_DIR = _ROOT / "build" / "native"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_path: Path | None = None
_tried = False

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    # name: (restype, argtypes), as native/avir_host.cpp declares them
    "avir_errdiff_dither": (_I, [_P, _I64, _I64, _I64, _I, ctypes.c_double]),
    "avir_png_encode": (_I64, [_P, _I64, _I64, _I, _I, ctypes.POINTER(_P)]),
    "avir_png_info": (_I, [
        _P, _I64, ctypes.POINTER(_I64), ctypes.POINTER(_I64),
        ctypes.POINTER(_I), ctypes.POINTER(_I),
    ]),
    "avir_png_decode": (_I, [_P, _I64, _P]),
    "avir_free": (None, [_P]),
    "avir_xs128_fill": (None, [_P, _I64, ctypes.c_uint32]),
}


def built_path() -> Path:
    """Where this checkout builds the library: ``build/native/``, named by
    a digest of the source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libavir_host-{digest}.so"


def _build(dest: Path) -> None:
    """g++ into a temporary file beside ``dest``, then an atomic rename (two
    processes may build at once)."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dest.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, str(SOURCE), "-lz"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)  # AttributeError: a library of another source
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _path, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            return None
        fresh = (
            TRACKED.exists()
            and TRACKED.stat().st_mtime >= SOURCE.stat().st_mtime
        )
        for path in ((TRACKED,) if fresh else ()) + (built_path(),):
            if not path.exists():
                try:
                    _build(path)
                except (OSError, subprocess.SubprocessError):
                    return None
            try:
                _lib, _path = _open(path), path
                return _lib
            except (OSError, AttributeError):
                continue
        return None


def have_native() -> bool:
    return _load() is not None


def library_path() -> Path | None:
    """The library this process loaded, or None without one."""
    _load()
    return _path


def errdiff_dither(
    img: np.ndarray, trunc_bits: int, out_max: float
) -> np.ndarray:
    """Error-diffusion dither of [H, W, C] float -> quantized float64 in
    [0, out_max], the reference's scan semantics (avir.h:4485-4525).
    Without the library, the NumPy scan of ``models/host_reference.py``."""
    h, w, c = img.shape
    buf = np.ascontiguousarray(img, dtype=np.float64)
    if buf is img:
        buf = buf.copy()  # the scan works in place
    lib = _load()
    if lib is not None:
        rc = lib.avir_errdiff_dither(
            buf.ctypes.data, h, w, c, trunc_bits, float(out_max)
        )
        if rc == 0:
            return buf
    from ..models.host_reference import errdiff_dither as np_errdiff

    return np_errdiff(buf, trunc_bits, out_max)


def xs128_words(n: int, seed: int) -> np.ndarray | None:
    """n words of the xorshift128 test generator (bit-exact with the golden
    generator and tests/conftest.py), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(n, dtype=np.uint32)
    lib.avir_xs128_fill(out.ctypes.data, n, seed & 0xFFFFFFFF)
    return out


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native PNG codec unavailable (no library, no g++)")
    return lib


def png_encode(pixels: np.ndarray) -> bytes:
    """Encode [H, W, C] (or [H, W]) uint8/uint16 to PNG bytes."""
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w, c = pixels.shape
    if pixels.dtype == np.uint8:
        depth = 8
    elif pixels.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"unsupported dtype {pixels.dtype}")
    lib = _need()
    buf = np.ascontiguousarray(pixels)
    out = ctypes.c_void_p()
    n = lib.avir_png_encode(buf.ctypes.data, w, h, c, depth, ctypes.byref(out))
    if n < 0:
        raise ValueError("PNG encode failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.avir_free(out)


def png_decode(data: bytes) -> np.ndarray:
    """Decode PNG bytes to [H, W, C] uint8/uint16 (C in 1..4)."""
    lib = _need()
    w, h = ctypes.c_int64(), ctypes.c_int64()
    ch, depth = ctypes.c_int(), ctypes.c_int()
    rc = lib.avir_png_info(
        data, len(data), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(ch), ctypes.byref(depth),
    )
    if rc != 0:
        raise ValueError(f"unsupported or invalid PNG (code {rc})")
    dtype = np.uint8 if depth.value == 8 else np.uint16
    out = np.empty((h.value, w.value, ch.value), dtype=dtype)
    rc = lib.avir_png_decode(data, len(data), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"PNG decode failed (code {rc})")
    return out
