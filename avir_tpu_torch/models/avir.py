"""AVIR pipeline driver: the public resize API.

Counterpart of the JAX package's ``models/avir.py``
(``ImageResizer.resize`` and the module-level ``resize``): the
constructor fixes bit depths and the quality preset; ``resize`` plans on
the host (NumPy), builds an executor once per configuration (cached),
and runs it on ``device``.  Arrays go in and come out as NumPy arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..params import PARAMS_DEF, Params
from ..plan.plan import build_resize_plan
from ..utils.excache import ExecutorCache
from .runtime import GAMMA_ROUTE_ENV, make_avir_executor, resolve_device

DITHERS = ("default", "errdiff", "errdiff-wavefront")


class ImageResizer:
    """Image resizer with a fixed quality preset and output bit depth
    (avir.h:4630-4639): ``res_bit_depth`` is the significant output bit
    depth (8 or 16, or lower for dithered low-bit output),
    ``src_bit_depth`` defaults to it."""

    def __init__(
        self,
        res_bit_depth: int = 8,
        src_bit_depth: int = 0,
        params: Params = PARAMS_DEF,
    ):
        self.res_bit_depth = res_bit_depth
        self.src_bit_depth = src_bit_depth
        self.params = params
        self._cache = ExecutorCache(maxsize=64)

    def resize(
        self,
        src: np.ndarray,
        new_w: int,
        new_h: int,
        k: float = 0.0,
        ox: float = 0.0,
        oy: float = 0.0,
        out_dtype=None,
        use_srgb_gamma: bool = False,
        alpha_index: int = -1,
        dither: str = "default",
        build_mode: int = -1,
        precision: str = "auto",
        engine: str = "auto",
        device=None,
    ) -> np.ndarray:
        """Resize ``src`` ([H, W, C] or [H, W]; u8, u16, float32 or
        float64) to new_w x new_h, in ``out_dtype`` (default: the input's).

        ``k``: 0 = auto per-axis scale with centering; >0 = uniform scale
        with centering; <0 = |k| without centering (avir.h:4709-4736).
        ``ox``/``oy``: sub-pixel shift in source pixels.
        ``dither``: "default" (round + clamp, with the ``res_bit_depth``
        truncation) or "errdiff" (error diffusion by the wavefront scan,
        kernel K4; "errdiff-wavefront" is the same); float output ignores
        it.  Error diffusion reads a full-precision pre-dither image, so
        it never takes K1's int8 mode (see models/runtime.py).
        ``precision``: "auto" (K1 int8 mode for u8 in / 8-bit out /
        default dither, else split-bf16: split2 for a first pass over u8
        input without gamma, split3 otherwise), "fast" (split2 for both
        passes) or "exact" (full-float32 products, no kernel).  Device
        compute is
        float32: float64 input is cast to float32 on the host, and float64
        output is float32 cast back.  ``device``: None means the CUDA card
        (an error without one); ``"cpu"`` runs the kernels' plain versions.

        ``use_srgb_gamma``: resize in linear light (sRGB in and out, in
        the kernel); ``alpha_index`` 0 or 3 of 4-channel data passes that
        channel through the gamma stages unchanged.  The environment
        variable ``AVIR_TPU_GAMMA_ROUTE`` picks the int8 gamma route (all
        bit-equal; see models/runtime.py): unset or "auto" runs the
        shift-ring kernel K6 where it is viable (uniform-stride
        downsizes) and otherwise K1 with the in-kernel linearization;
        "inkernel" always runs K1 that way; "prologue" linearizes the
        image once (kernel K5) before K1; "ring" runs K6, and warns and
        takes the in-kernel route where K6 is not viable.

        Still raising NotImplementedError, with their ROADMAP.md item:
        ``dither="errdiff-device"``, a callable ditherer,
        ``precision="f64"``, ``engine="host"`` and more than 4 channels.
        """
        if callable(dither):
            raise NotImplementedError(
                "not ported yet: custom ditherer callable (ROADMAP.md Queue 1 "
                "item 4)"
            )
        if dither == "errdiff-device":
            raise NotImplementedError(
                "not ported yet: dither='errdiff-device', the sequential "
                "nested scan (ROADMAP.md Queue 1 item 8)"
            )
        if dither not in DITHERS:
            raise ValueError(f"unknown dither {dither!r}")
        if engine == "host":
            raise NotImplementedError(
                "not ported yet: engine='host', the float64 host oracle "
                "route (ROADMAP.md Queue 1 items 4 and 10)"
            )
        if engine != "auto":
            raise ValueError(f"unknown engine {engine!r}")
        device = resolve_device(device)
        src = np.asarray(src)
        squeeze = src.ndim == 2
        if squeeze:
            src = src[:, :, None]
        sh, sw, ch = src.shape
        out_dtype = np.dtype(src.dtype if out_dtype is None else out_dtype)
        if new_w <= 0 or new_h <= 0:
            raise ValueError("target size must be positive")
        if sw == 0 or sh == 0:
            out = np.zeros((new_h, new_w, ch), dtype=out_dtype)
            return out[:, :, 0] if squeeze else out

        errdiff = dither != "default"
        key = (
            sw, sh, new_w, new_h, ch, src.dtype.str, out_dtype.str,
            k, ox, oy, use_srgb_gamma, alpha_index, build_mode, precision,
            errdiff, self.res_bit_depth, self.src_bit_depth, str(device),
            # the int8 gamma route is chosen when the executor is built
            os.environ.get(GAMMA_ROUTE_ENV, "auto"),
        )

        def build():
            plan = build_resize_plan(
                src_w=sw, src_h=sh, new_w=new_w, new_h=new_h,
                el_count=ch, in_dtype=src.dtype, out_dtype=out_dtype,
                k=k, ox=ox, oy=oy, params=self.params,
                res_bit_depth=self.res_bit_depth,
                src_bit_depth=self.src_bit_depth,
                use_srgb_gamma=use_srgb_gamma,
                alpha_index=alpha_index,
                build_mode=build_mode,
            )
            return make_avir_executor(
                plan, errdiff=errdiff, precision=precision, device=device
            )

        fn = self._cache.get_or_build(key, build)
        flat = src.reshape(sh, sw * ch)
        if flat.dtype == np.float64:
            flat = flat.astype(np.float32)  # device compute is float32
        x = torch.from_numpy(np.ascontiguousarray(flat))
        res = fn(x.to(device)).cpu().numpy().reshape(new_h, new_w, ch)
        if res.dtype != out_dtype:
            res = res.astype(out_dtype)  # float64 round trip
        return res[:, :, 0] if squeeze else res


def resize(src: np.ndarray, new_w: int, new_h: int, **kwargs) -> np.ndarray:
    """One-shot resize with the default preset (see ImageResizer.resize).

    Extra keyword arguments ``params``, ``res_bit_depth`` and
    ``src_bit_depth`` configure the resizer itself.
    """
    rz = ImageResizer(
        res_bit_depth=kwargs.pop("res_bit_depth", 8),
        src_bit_depth=kwargs.pop("src_bit_depth", 0),
        params=kwargs.pop("params", PARAMS_DEF),
    )
    return rz.resize(src, new_w, new_h, **kwargs)
