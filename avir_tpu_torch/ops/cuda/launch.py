"""The host side of the hand-written kernels' C entry points.

Each library of ``csrc/`` (``build.py``) exports C functions.  An ``Entry``
names one of them and its parameters once, in one ordered table of (name,
ctypes type) pairs in the C order.  A launch function takes the values of
one call first (the input and output pointers, anything read off the input
tensor), then ``stream``, then the values fixed for an operand set
(pointers of the operands' own tensors, sizes, shifts, the epilogue).
``Entry.pack`` computes those fixed values, once per operand set;
``Entry.launch`` enters the input's device, appends the caller's current
stream and the packed values to the call's own, calls, raises on a CUDA
error and counts the launch.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ...utils import trace

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def on_cpu(x: torch.Tensor, device: torch.device) -> bool:
    """True where the input ``x`` and operands on ``device`` are both on the
    CPU (the plain version runs), False where both are on one CUDA device;
    else ValueError."""
    if x.device.type == "cpu" and device.type == "cpu":
        return True
    if x.device.type != "cuda" or x.device != device:
        raise ValueError(
            f"image on {x.device}, operands on {device}: both must be "
            "on one CUDA device (or both on the CPU)"
        )
    return False


class Entry:
    """The C function ``symbol`` of the kernel library ``library``, its
    parameters ``params`` [(name, ctypes type), ...] in the C order.  In a
    launch function the ``stream`` parameter parts the values of one call
    (before it) from those fixed for an operand set (after it, ``fixed``).
    ``span``: the tracer's span around a launch's ``ctypes`` call."""

    def __init__(self, library: str, symbol: str, params, span: str | None = None):
        self.library, self.symbol, self.span = library, symbol, span
        self.params = tuple(params)
        names = [name for name, _ in self.params]
        self.fixed = self.params[names.index("stream") + 1:] if "stream" in names else ()
        self._fn = None

    def bind(self, lib: ctypes.CDLL):
        """The function in ``lib``, with its C types set."""
        fn = getattr(lib, self.symbol)
        fn.argtypes = [t for _, t in self.params]
        fn.restype = ctypes.c_int
        return fn

    def function(self):
        """The function in the library's own build, loaded once."""
        if self._fn is None:
            from .build import load_library

            self._fn = self.bind(load_library(self.library))
        return self._fn

    @contextlib.contextmanager
    def through(self, lib: ctypes.CDLL):
        """Launch through ``lib``, another build of the same library (such
        as a copy with timing marks), while the context is open."""
        saved, self._fn = self._fn, self.bind(lib)
        try:
            yield
        finally:
            self._fn = saved

    def pack(self, *sources, **values) -> tuple:
        """The values fixed for an operand set, in the C order: each the
        keyword of its name, else the attribute of that name of the first
        of ``sources`` that has one; a tensor gives its ``data_ptr()``
        (None: a null pointer)."""
        out = []
        for name, _ in self.fixed:
            if name in values:
                v = values.pop(name)
            else:
                for s in sources:
                    if hasattr(s, name):
                        v = getattr(s, name)
                        break
                else:
                    raise AttributeError(f"no value for {self.symbol}'s {name}")
            out.append(v.data_ptr() if isinstance(v, torch.Tensor) else v)
        if values:
            raise TypeError(f"{self.symbol} has no fixed parameters {sorted(values)}")
        return tuple(out)

    def __call__(self, device: torch.device, *args) -> None:
        """Call the function with ``args`` on ``device`` (a query: no
        stream); RuntimeError on a CUDA error."""
        with torch.cuda.device(device):
            self._check(self.function()(*args))

    def launch(self, x: torch.Tensor, counts: dict, key: str, *args, packed: tuple = ()) -> None:
        """Launch with the call's own ``args``, the current stream of the
        device of ``x`` and ``packed`` (``pack``'s values), on that device;
        RuntimeError on a CUDA error, else one more ``counts[key]``."""
        fn = self._fn or self.function()
        dev = x.device
        with torch.cuda.device(dev):
            args = (*args, torch.cuda.current_stream(dev).cuda_stream, *packed)
            err = trace.call(self.span, fn, *args) if trace.on and self.span else fn(*args)
        self._check(err)
        counts[key] += 1

    def _check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err}")
