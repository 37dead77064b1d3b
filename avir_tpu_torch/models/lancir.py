"""LANCIR: the fast Lanczos resize path, its public API.

Counterpart of the JAX package's ``models/lancir.py`` (``LancIR.resize``
and ``lancir_resize``), the equivalent of ``avir::CLancIR::resizeImage``
(lancir.h:386-713).  ``resize`` plans on the host (NumPy), builds an
executor once per configuration (cached) and runs it on ``device``: K1
with its round-half-even epilogue (models/runtime.py:
make_lancir_executor).  The object only holds immutable cached executors
and is safe to share.
"""

from __future__ import annotations

import numpy as np
import torch

from ..plan.lancir_plan import build_lancir_plan
from ..utils.excache import ExecutorCache
from .host_reference import execute_lancir_numpy
from .runtime import make_lancir_executor, resolve_device

_BATCH = (
    "not ported yet: the batch and traceable entry points, which share "
    "AVIR's resize_batch / make_resize_fn wrapper (ROADMAP.md Queue 1 "
    "item 4)"
)


class LancIR:
    def __init__(self):
        self._cache = ExecutorCache(maxsize=64)

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
        """Lanczos resize of ``src`` ([H, W, C] or [H, W]; u8, u16,
        float32 or float64) to new_w x new_h, in ``out_dtype`` (default:
        the input's).

        ``kx``/``ky``: 0 = auto scale with centering; >0 = given scale
        with centering; <0 = |k| without centering (lancir.h:430-457).
        ``la``: Lanczos window size, >= 2 (lancir.h:291-307).
        ``precision``: "auto" (K1 int8 mode for u8 in and u8 out, else
        split-bf16), "fast" (split2 for both passes), "exact" (full-float32
        products, no kernel) or "f64" (float64 on the host, the
        reference's T=double instantiation, lancir.h:386-390).
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
            return self._deliver(res[:, :, 0] if squeeze else res, out)
        host = precision == "f64"
        if not host:
            device = resolve_device(device)

        key = (
            sw, sh, new_w, new_h, ch, src.dtype.str, out_dtype.str,
            kx, ky, ox, oy, la, precision, None if host else str(device),
        )

        def build():
            plan = build_lancir_plan(
                sw, sh, new_w, new_h, ch, src.dtype, out_dtype,
                kx=kx, ky=ky, ox=ox, oy=oy, la=la,
            )
            if host:
                return lambda src3: execute_lancir_numpy(plan, src3)
            return make_lancir_executor(plan, precision=precision, device=device)

        fn = self._cache.get_or_build(key, build)
        if host:
            res = fn(src)
        else:
            flat = src.reshape(sh, sw * ch)
            if flat.dtype == np.float64:
                flat = flat.astype(np.float32)  # device compute is float32
            x = torch.from_numpy(np.ascontiguousarray(flat)).to(device)
            res = fn(x).cpu().numpy().reshape(new_h, new_w, ch)
        if res.dtype != out_dtype:
            res = res.astype(out_dtype)  # float64 round trip
        return self._deliver(res[:, :, 0] if squeeze else res, out)

    @staticmethod
    def _deliver(res: np.ndarray, out: np.ndarray | None) -> np.ndarray:
        if out is None:
            return res
        if out.shape != res.shape:
            raise ValueError(f"out shape {out.shape} != result {res.shape}")
        np.copyto(out, res, casting="same_kind")
        return out

    def resize_batch(self, batch, new_w: int, new_h: int, **kwargs):
        """Not ported yet (ROADMAP.md Queue 1 item 4)."""
        raise NotImplementedError(_BATCH)


def lancir_resize(src: np.ndarray, new_w: int, new_h: int, **kwargs) -> np.ndarray:
    """One-shot LANCIR resize (see LancIR.resize)."""
    return LancIR().resize(src, new_w, new_h, **kwargs)


def make_lancir_resize_fn(*args, **kwargs):
    """Not ported yet (ROADMAP.md Queue 1 item 4)."""
    raise NotImplementedError(_BATCH)
