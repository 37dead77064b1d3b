"""AVIR pipeline driver: the public resize API.

Counterpart of the JAX package's ``models/avir.py``: the constructor
fixes bit depths, the quality preset and the plan cache; ``resize`` plans
on the host (NumPy), builds an executor once per configuration (cached),
and runs it on ``device``; ``resize_batch`` runs N same-shape frames with
pinned staging (``models/batch.py``); ``make_resize_fn`` returns a
function on device tensors.  The float64 host route (``precision="f64"``
/ ``engine="host"``) runs the NumPy oracle with the native error
diffusion.  NumPy arrays go in and come out, except through
``make_resize_fn``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..params import PARAMS_DEF, Params
from ..plan.cache import build_resize_plan_cached
from ..plan.plan import build_resize_plan
from ..utils import trace
from ..utils.excache import ExecutorCache
from .batch import BatchRunner
from .host_reference import execute_plan_numpy
from .runtime import GAMMA_ROUTE_ENV, make_avir_executor, resolve_device

# Every error-diffusion spelling runs K4 on a device (errdiff_impl), and the
# native serial scan on the host route; see ImageResizer.resize.
ERRDIFF = ("errdiff", "errdiff-wavefront", "errdiff-device")
DITHERS = ("default",) + ERRDIFF
ENGINES = ("auto", "pallas", "host")


def errdiff_impl(dither) -> str:
    """K4's sum order for a dither spelling: "errdiff-device" names the JAX
    package's sequential nested scan, the others its wavefront."""
    return "scan" if dither == "errdiff-device" else "wavefront"


def check_engine(engine: str) -> None:
    if engine == "xla":
        raise ValueError(
            "engine='xla' is the JAX package's library route; here the "
            "library route is precision='exact' (full-float32 torch.bmm)"
        )
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def torch_dtype(dt: np.dtype) -> torch.dtype:
    """The device type of a host image type: float64 computes in float32."""
    return {
        "u1": torch.uint8, "u2": torch.uint16, "f4": torch.float32,
        "f8": torch.float32,
    }[np.dtype(dt).str[1:]]


def to_device(src3: np.ndarray, device) -> torch.Tensor:
    """[H, W, C] host image -> [H, W*C] tensor on ``device`` (float64 cast
    to float32 on the host; a copy only for a non-contiguous view)."""
    sh, sw, ch = src3.shape
    flat = src3.reshape(sh, sw * ch)
    if flat.dtype == np.float64:
        flat = flat.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(flat)).to(device)


def deliver(res: np.ndarray, out: np.ndarray | None) -> np.ndarray:
    """The reference's NewBuf + NewSSize output contract (avir.h:4680-4692,
    lancir.h:260-307): write ``res`` through the strides of ``out`` (maybe
    a view of a larger buffer) and return it."""
    if out is None:
        return res
    if out.shape != res.shape:
        raise ValueError(f"out shape {out.shape} != result {res.shape}")
    np.copyto(out, res, casting="same_kind")
    return out


def _host_executor(plan, dither, rnd_seed: int = 0):
    """Float64 host executor (``precision="f64"`` / ``engine="host"``), the
    reference's fptype=double mode (avir.h:4569-4592): the NumPy oracle end
    to end, error diffusion by the native serial scan, a callable
    ``dither`` on the float64 pre-dither image.  Takes the [H, W, C] view
    as given (maybe strided, the reference's SrcScanlineSize contract) and
    never flattens it."""
    custom = callable(dither)
    errdiff = not custom and dither in ERRDIFF

    def run(src3: np.ndarray) -> np.ndarray:
        if (not errdiff and not custom) or plan.is_out_float:
            return execute_plan_numpy(plan, src3)
        pre = execute_plan_numpy(plan, src3, return_predither=True)
        out_bits = 8 if plan.out_type_max == 255.0 else 16
        trunc_bits = out_bits - plan.res_bit_depth
        out_dt = np.uint8 if out_bits == 8 else np.uint16
        if custom:
            return np.asarray(
                dither(pre, trunc_bits, plan.out_type_max, rnd_seed)
            ).astype(out_dt)
        return native.errdiff_dither(pre, trunc_bits, plan.out_type_max).astype(out_dt)

    return run


class _Route(NamedTuple):
    """What ``resize`` and ``resize_batch`` run for one configuration."""

    key: tuple            # the executor cache's key
    fn: object            # host [H, W, C] -> array, or a device executor
    host: bool            # fn is the float64 host route
    custom: object        # the callable ditherer of a device route, or None
    out_dtype: np.dtype
    device: torch.device | None


class ImageResizer:
    """Image resizer with a fixed quality preset and output bit depth
    (avir.h:4630-4639): ``res_bit_depth`` is the significant output bit
    depth (8 or 16, or lower for dithered low-bit output),
    ``src_bit_depth`` defaults to it.  ``plan_cache=True`` keeps built
    plans on disk (``plan/cache.py``).  The object holds only immutable
    cached executors and locked batch staging, and is safe to share."""

    def __init__(
        self,
        res_bit_depth: int = 8,
        src_bit_depth: int = 0,
        params: Params = PARAMS_DEF,
        plan_cache: bool = False,
    ):
        self.res_bit_depth = res_bit_depth
        self.src_bit_depth = src_bit_depth
        self.params = params
        self.plan_cache = plan_cache
        self._cache = ExecutorCache(maxsize=64)

    def _route(
        self, sh: int, sw: int, ch: int, in_dtype: np.dtype,
        new_w: int, new_h: int,
        k: float = 0.0, ox: float = 0.0, oy: float = 0.0, out_dtype=None,
        use_srgb_gamma: bool = False, alpha_index: int = -1,
        dither="default", build_mode: int = -1, precision: str = "auto",
        rnd_seed: int = 0, engine: str = "auto", device=None,
    ) -> _Route:
        if precision == "f64":
            engine = "host"
        check_engine(engine)
        custom = callable(dither)
        if not custom and dither not in DITHERS:
            raise ValueError(f"unknown dither {dither!r}")
        if new_w <= 0 or new_h <= 0:
            raise ValueError("target size must be positive")
        out_dtype = np.dtype(in_dtype if out_dtype is None else out_dtype)
        host = engine == "host"
        device = None if host else resolve_device(device)
        use_custom = custom and out_dtype.kind != "f"
        key = (
            sw, sh, new_w, new_h, ch, np.dtype(in_dtype).str, out_dtype.str,
            k, ox, oy, use_srgb_gamma, alpha_index,
            # a callable ditherer caches by a token of its identity
            self._cache.token(dither) if custom else dither,
            rnd_seed if custom and host else 0,
            build_mode, precision, "host" if host else str(device),
            # the int8 gamma route is chosen when the executor is built
            os.environ.get(GAMMA_ROUTE_ENV, "auto"),
        )

        def build():
            plan_kw = dict(
                src_w=sw, src_h=sh, new_w=new_w, new_h=new_h, el_count=ch,
                in_dtype=in_dtype, out_dtype=out_dtype, k=k, ox=ox, oy=oy,
                params=self.params, res_bit_depth=self.res_bit_depth,
                src_bit_depth=self.src_bit_depth,
                use_srgb_gamma=use_srgb_gamma, alpha_index=alpha_index,
                build_mode=build_mode,
            )
            plan = (
                build_resize_plan_cached(**plan_kw) if self.plan_cache
                else build_resize_plan(**plan_kw)
            )
            if host:
                return _host_executor(plan, dither, rnd_seed)
            return make_avir_executor(
                plan, errdiff=not custom and dither in ERRDIFF,
                precision=precision, device=device,
                return_predither=use_custom, errdiff_impl=errdiff_impl(dither),
            )

        fn = self._cache.get_or_build(key, build)
        return _Route(key, fn, host, dither if use_custom else None, out_dtype, device)

    def _finish_custom(self, pre, dither, out_dtype, rnd_seed):
        """The custom-ditherer slot (the reference's fpclass ditherer
        template parameter, avir.h:4569-4592) on the float64 image."""
        out_bits = 8 if out_dtype.itemsize == 1 else 16
        out_max = float((1 << out_bits) - 1)
        trunc_bits = out_bits - self.res_bit_depth
        return np.asarray(
            dither(pre.astype(np.float64), trunc_bits, out_max, rnd_seed)
        ).astype(out_dtype)

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
        dither="default",
        build_mode: int = -1,
        precision: str = "auto",
        rnd_seed: int = 0,
        engine: str = "auto",
        out: np.ndarray | None = None,
        device=None,
    ) -> np.ndarray:
        """Resize ``src`` ([H, W, C] or [H, W], any C; u8, u16, float32 or
        float64) to new_w x new_h, in ``out_dtype`` (default: the input's).

        ``k``: 0 = auto per-axis scale with centering; >0 = uniform scale
        with centering; <0 = |k| without centering (avir.h:4709-4736).
        ``ox``/``oy``: sub-pixel shift in source pixels.
        ``dither``: "default" (round + clamp, with the ``res_bit_depth``
        truncation); "errdiff", "errdiff-wavefront" or "errdiff-device"
        (error diffusion: all three run the wavefront scan, kernel K4, on
        a device, and the native serial scan on the host route); or a
        callable ``fn(img, trunc_bits, out_max, rnd_seed) -> array``, the
        reference's ditherer template slot (avir.h:4569-4592), given the
        float64 [new_h, new_w, C] image after gamma-out.  Float output
        ignores it.  ``rnd_seed`` (CImageResizerVars.RndSeed,
        avir.h:2533-2535) reaches only a callable ditherer.
        "errdiff-device" is the JAX package's sequential nested scan
        (``ops/dither.py:errdiff_dither_jnp``), which has no TPU kernel;
        the wavefront computes the same per-pixel recurrence, so it runs
        on K4 with its sums in the scan's order (``scan_order``), which
        gives the scan's bits; "errdiff" and "errdiff-wavefront" keep the
        JAX wavefront's order (the two orders differ by one step on
        isolated pixels of 16-bit output).  Error
        diffusion and a callable ditherer read a full-precision pre-dither
        image, so they never take K1's int8 mode (see models/runtime.py).
        ``precision``: "auto" (K1 int8 mode for u8 in / 8-bit out /
        default dither, else split-bf16: split2 for a first pass over u8
        input without gamma, split3 otherwise), "fast" (split2 for both
        passes), "exact" (full-float32 products by ``torch.bmm``, the
        library route) or "f64" (the float64 host route).
        ``engine``: "auto" and "pallas" run the hand-written kernels (the
        JAX package's "pallas" names its TPU kernels); "host" is the
        float64 host route, as ``precision="f64"``; "xla" raises
        ValueError (the JAX package's library route: ask for
        ``precision="exact"``).  Device compute is float32: float64 input
        is cast to float32 on the host, float64 output is float32 cast
        back.
        ``out``: optional preallocated destination, possibly a strided
        view (avir.h:4680-4692); written through its strides and returned.
        ``device``: None means the CUDA card (an error without one);
        ``"cpu"`` runs the kernels' plain versions.  The host route needs
        no device.

        ``use_srgb_gamma``: resize in linear light (sRGB in and out, in
        the kernel); ``alpha_index`` 0 or 3 of 4-channel data passes that
        channel through the gamma stages unchanged.  The environment
        variable ``AVIR_TPU_GAMMA_ROUTE`` picks the int8 gamma route (all
        bit-equal; see models/runtime.py): unset, "auto" or "inkernel"
        runs K1 with the in-kernel linearization; "prologue" linearizes
        the image once (kernel K5) before K1; "ring" runs the shift-ring
        kernel K6 where it is viable (uniform-stride downsizes), and
        warns and takes the in-kernel route elsewhere.
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
            res = np.zeros((new_h, new_w, ch), dtype=out_dtype)
            return deliver(res[:, :, 0] if squeeze else res, out)
        route = self._route(
            sh, sw, ch, src.dtype, new_w, new_h, k=k, ox=ox, oy=oy,
            out_dtype=out_dtype, use_srgb_gamma=use_srgb_gamma,
            alpha_index=alpha_index, dither=dither, build_mode=build_mode,
            precision=precision, rnd_seed=rnd_seed, engine=engine,
            device=device,
        )
        if route.host:
            res = np.asarray(route.fn(src))
        else:
            res = route.fn(to_device(src, route.device)).cpu().numpy()
            res = res.reshape(new_h, new_w, ch)
            if route.custom is not None:
                res = self._finish_custom(res, route.custom, out_dtype, rnd_seed)
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
        """Resize N same-shape frames [N, H, W, C] to [N, new_h, new_w, C],
        with the keyword arguments of ``resize`` (``out``: optional
        preallocated [N, new_h, new_w, C] destination, reused pages).
        Each frame keeps the single-image route and bits: its kernels
        launch once on the current stream, while the copies run through
        pinned staging on copy streams (``models/batch.py``).  Callable
        ditherers and the host route run frame by frame through
        ``resize``."""
        batch = np.asarray(batch)
        if batch.ndim != 4:
            raise ValueError("batch must be [N, H, W, C]")
        n, sh, sw, ch = batch.shape
        if (
            callable(kwargs.get("dither"))
            or kwargs.get("precision") == "f64"
            or kwargs.get("engine") == "host"
            or not sw or not sh
        ):
            frames = [self.resize(im, new_w, new_h, **kwargs) for im in batch]
            res = np.stack(frames) if frames else np.zeros(
                (0, new_h, new_w, ch),
                np.dtype(kwargs.get("out_dtype") or batch.dtype),
            )
            return deliver(res, out)
        route = self._route(sh, sw, ch, batch.dtype, new_w, new_h, **kwargs)
        if out is None:
            out = np.empty((n, new_h, new_w, ch), dtype=route.out_dtype)
        runner = self._cache.get_or_build(
            ("batch",) + route.key,
            lambda: BatchRunner(
                route.fn, (sh, sw, ch), torch_dtype(batch.dtype),
                (new_h, new_w, ch), torch_dtype(route.out_dtype), route.device,
            ),
        )
        return runner(batch, out)


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


def device_fn(run, src_shape, in_dtype: np.dtype, out_dtype: np.dtype,
              new_w: int, new_h: int, flat: bool, device: torch.device):
    """The function on device tensors that ``make_resize_fn`` and
    ``make_lancir_resize_fn`` return (``_traceable_wrapper`` there): it
    checks the input's shape, type and device, and makes no host copy and
    no host synchronisation.  A call is a ``frame`` span while the tracer
    (utils/trace.py) is on."""
    squeeze = len(src_shape) == 2
    sh, sw = src_shape[0], src_shape[1]
    ch = 1 if squeeze else src_shape[2]
    expect = (sh, sw * ch) if flat else tuple(src_shape)
    want = torch.float64 if in_dtype == np.float64 else torch_dtype(in_dtype)
    out_f64 = out_dtype == np.float64

    def frame(x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != expect:
            raise ValueError(f"expected input shape {expect}, got {tuple(x.shape)}")
        if x.dtype != want:
            raise ValueError(f"expected a {want} input, got {x.dtype}")
        if x.device.type != device.type or (
            device.index is not None and x.device.index != device.index
        ):
            raise ValueError(f"input on {x.device}, the function runs on {device}")
        if x.dtype == torch.float64:
            x = x.float()  # device compute is float32
        y = run(x.reshape(sh, sw * ch).contiguous())
        if out_f64:
            y = y.double()
        if flat:
            return y
        y = y.reshape(new_h, new_w, ch)
        return y[:, :, 0] if squeeze else y

    def fn(x: torch.Tensor) -> torch.Tensor:
        if trace.on:
            return trace.call("frame", frame, x)
        return frame(x)

    fn.run = run
    return fn


def make_resize_fn(
    src_shape,
    in_dtype,
    new_w: int,
    new_h: int,
    out_dtype=None,
    k: float = 0.0,
    ox: float = 0.0,
    oy: float = 0.0,
    params: Params = PARAMS_DEF,
    res_bit_depth: int = 8,
    src_bit_depth: int = 0,
    use_srgb_gamma: bool = False,
    alpha_index: int = -1,
    dither: str = "default",
    build_mode: int = -1,
    precision: str = "auto",
    engine: str = "auto",
    flat: bool = False,
    device=None,
):
    """A resize function on device tensors: [H, W, C] -> [new_h, new_w, C]
    (or [H, W] -> [new_h, new_w]), or with ``flat=True`` the executors'
    [H, W*C] -> [new_h, new_w*C].  It takes and returns tensors on
    ``device`` (None: the CUDA card), launches the same kernels as
    ``resize`` on the current stream, and makes no host copy and no host
    synchronisation, so a PyTorch program can call it on its own stream.
    The JAX package's counterpart returns a traceable function; its
    ``split_lanes=False`` (the TPU's aliased ``out_init`` lane split, which
    cannot carry a ``vmap`` batch dimension) has no counterpart here: K1
    writes whole output chunks, and a batch is a loop over frames.

    ``dither``: "default" or an error-diffusion spelling (K4, see
    ``ImageResizer.resize``); the host route and callable ditherers are
    host code and not offered here."""
    if dither not in DITHERS:
        raise ValueError(
            "device resize supports dither='default', 'errdiff', "
            "'errdiff-wavefront' or 'errdiff-device'"
        )
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
            plan = build_resize_plan(
                sw, sh, new_w, new_h, ch, in_dtype, out_dt,
                k=k, ox=ox, oy=oy, params=params,
                res_bit_depth=res_bit_depth, src_bit_depth=src_bit_depth,
                use_srgb_gamma=use_srgb_gamma, alpha_index=alpha_index,
                build_mode=build_mode,
            )
        with trace.span("setup.operands"):
            run = make_avir_executor(
                plan, errdiff=dither != "default", precision=precision,
                device=device, errdiff_impl=errdiff_impl(dither),
            )
        return device_fn(run, src_shape, in_dtype, out_dt, new_w, new_h, flat, device)
