"""LANCIR: the fast Lanczos resize path, its public API.

Counterpart of the JAX package's ``models/lancir.py`` (``LancIR.resize``,
``resize_batch``, ``lancir_resize`` and ``make_lancir_resize_fn``), the
equivalent of ``avir::CLancIR::resizeImage`` (lancir.h:386-713).
``resize`` plans on the host (NumPy), builds an executor once per
configuration (cached) and runs it on ``device``: K1 with its
round-half-even epilogue (models/runtime.py: make_lancir_executor).
``resize_batch`` runs N frames with pinned staging, as AVIR's.  The object
only holds immutable cached executors and locked batch staging, and is
safe to share.
"""

from __future__ import annotations

import numpy as np

from ..plan.lancir_plan import build_lancir_plan
from ..utils import trace
from ..utils.excache import ExecutorCache
from .avir import check_engine, deliver, device_fn, to_device, torch_dtype
from .batch import BatchRunner
from .host_reference import execute_lancir_numpy
from .runtime import make_lancir_executor, resolve_device


class LancIR:
    def __init__(self):
        self._cache = ExecutorCache(maxsize=64)

    def _executor(
        self, sh: int, sw: int, ch: int, in_dtype: np.dtype,
        new_w: int, new_h: int, kx: float = 0.0, ky: float = 0.0,
        ox: float = 0.0, oy: float = 0.0, la: float = 3.0, out_dtype=None,
        precision: str = "auto", device=None,
    ):
        """(cache key, executor, device) of one configuration: a host
        function of the [H, W, C] view for ``precision="f64"``, else a
        device executor of [H, W*C]."""
        host = precision == "f64"
        device = None if host else resolve_device(device)
        out_dtype = np.dtype(in_dtype if out_dtype is None else out_dtype)
        key = (
            sw, sh, new_w, new_h, ch, np.dtype(in_dtype).str, out_dtype.str,
            kx, ky, ox, oy, la, precision, None if host else str(device),
        )

        def build():
            plan = build_lancir_plan(
                sw, sh, new_w, new_h, ch, in_dtype, out_dtype,
                kx=kx, ky=ky, ox=ox, oy=oy, la=la,
            )
            if host:
                return lambda src3: execute_lancir_numpy(plan, src3)
            return make_lancir_executor(plan, precision=precision, device=device)

        return key, self._cache.get_or_build(key, build), device

    def resize(
        self,
        src: np.ndarray,
        new_w: int,
        new_h: int,
        kx: float = 0.0,
        ky: float = 0.0,
        ox: float = 0.0,
        oy: float = 0.0,
        la: float = 3.0,
        out_dtype=None,
        precision: str = "auto",
        out: np.ndarray | None = None,
        device=None,
    ) -> np.ndarray:
        """Lanczos resize of ``src`` ([H, W, C] or [H, W], any C; u8, u16,
        float32 or float64) to new_w x new_h, in ``out_dtype`` (default:
        the input's).

        ``kx``/``ky``: 0 = auto scale with centering; >0 = given scale
        with centering; <0 = |k| without centering (lancir.h:430-457).
        ``la``: Lanczos window size, >= 2 (lancir.h:291-307).
        ``precision``: "auto" (K1 int8 mode for u8 in and u8 out, else
        split-bf16), "fast" (split2 for both passes), "exact" (full-float32
        products by ``torch.bmm``) or "f64" (float64 on the host, the
        reference's T=double instantiation, lancir.h:386-390; it reads the
        [H, W, C] view as given, strided or not).
        ``out``: optional preallocated destination, possibly a strided
        view (the reference's NewBuf + NewSSize output contract,
        lancir.h:260-307); written through its strides and returned.
        ``device``: None means the CUDA card (an error without one);
        ``"cpu"`` runs the kernels' plain versions.  Device compute is
        float32.
        """
        src = np.asarray(src)
        squeeze = src.ndim == 2
        if squeeze:
            src = src[:, :, None]
        sh, sw, ch = src.shape
        out_dtype = np.dtype(src.dtype if out_dtype is None else out_dtype)
        if new_w <= 0 or new_h <= 0:
            raise ValueError("target size must be positive")
        if sw == 0 or sh == 0:
            # Degenerate source: blank output (cf. lancir.h:392-425).
            res = np.zeros((new_h, new_w, ch), dtype=out_dtype)
            return deliver(res[:, :, 0] if squeeze else res, out)
        _, fn, device = self._executor(
            sh, sw, ch, src.dtype, new_w, new_h, kx=kx, ky=ky, ox=ox, oy=oy,
            la=la, out_dtype=out_dtype, precision=precision, device=device,
        )
        if device is None:
            res = fn(src)
        else:
            res = fn(to_device(src, device)).cpu().numpy().reshape(new_h, new_w, ch)
        if res.dtype != out_dtype:
            res = res.astype(out_dtype)  # float64 round trip
        return deliver(res[:, :, 0] if squeeze else res, out)

    def resize_batch(
        self,
        batch: np.ndarray,
        new_w: int,
        new_h: int,
        out: np.ndarray | None = None,
        **kwargs,
    ) -> np.ndarray:
        """Resize N same-shape frames [N, H, W, C] (the reference's video
        batching, where one CLancIR object reuses its buffers across
        frames, lancir.h:319-324), with the keyword arguments of
        ``resize``.  Each frame keeps the single-image route and bits; the
        copies run through pinned staging (``models/batch.py``).
        ``precision="f64"`` runs frame by frame on the host."""
        batch = np.asarray(batch)
        if batch.ndim != 4:
            raise ValueError("batch must be [N, H, W, C]")
        n, sh, sw, ch = batch.shape
        if kwargs.get("precision") == "f64" or not sw or not sh:
            frames = [self.resize(im, new_w, new_h, **kwargs) for im in batch]
            res = np.stack(frames) if frames else np.zeros(
                (0, new_h, new_w, ch),
                np.dtype(kwargs.get("out_dtype") or batch.dtype),
            )
            return deliver(res, out)
        if new_w <= 0 or new_h <= 0:
            raise ValueError("target size must be positive")
        key, fn, device = self._executor(sh, sw, ch, batch.dtype, new_w, new_h, **kwargs)
        out_dtype = np.dtype(kwargs.get("out_dtype") or batch.dtype)
        if out is None:
            out = np.empty((n, new_h, new_w, ch), dtype=out_dtype)
        runner = self._cache.get_or_build(
            ("batch",) + key,
            lambda: BatchRunner(
                fn, (sh, sw, ch), torch_dtype(batch.dtype), (new_h, new_w, ch),
                torch_dtype(out_dtype), device,
            ),
        )
        return runner(batch, out)


def lancir_resize(src: np.ndarray, new_w: int, new_h: int, **kwargs) -> np.ndarray:
    """One-shot LANCIR resize (see LancIR.resize)."""
    return LancIR().resize(src, new_w, new_h, **kwargs)


def make_lancir_resize_fn(
    src_shape,
    in_dtype,
    new_w: int,
    new_h: int,
    kx: float = 0.0,
    ky: float = 0.0,
    ox: float = 0.0,
    oy: float = 0.0,
    la: float = 3.0,
    out_dtype=None,
    precision: str = "auto",
    engine: str = "auto",
    flat: bool = False,
    device=None,
):
    """LANCIR resize on device tensors, [H, W, C] -> [new_h, new_w, C] (or
    2-D grayscale, or flat [H, W*C]): the Lanczos counterpart of
    ``make_resize_fn`` (see models/avir.py, also on ``split_lanes``)."""
    check_engine(engine)
    if engine == "host" or precision == "f64":
        raise ValueError("the float64 host route is not a device function")
    with trace.span("setup.make_fn"):
        device = resolve_device(device)
        squeeze = len(src_shape) == 2
        sh, sw = src_shape[0], src_shape[1]
        ch = 1 if squeeze else src_shape[2]
        in_dtype = np.dtype(in_dtype)
        out_dt = np.dtype(out_dtype) if out_dtype is not None else in_dtype
        with trace.span("setup.plan"):
            plan = build_lancir_plan(
                sw, sh, new_w, new_h, ch, in_dtype, out_dt,
                kx=kx, ky=ky, ox=ox, oy=oy, la=la,
            )
        with trace.span("setup.operands"):
            run = make_lancir_executor(plan, precision=precision, device=device)
        return device_fn(run, src_shape, in_dtype, out_dt, new_w, new_h, flat, device)
