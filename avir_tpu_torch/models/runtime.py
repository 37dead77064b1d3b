"""Execution of resize plans on PyTorch tensors.

Counterpart of the JAX package's ``models/runtime.py``
(``make_avir_executor``, ``make_lancir_executor``).  An executor takes
the image [H, W*C] (u8, u16 or float32) on ``device`` and returns
[new_h, new_w*C] in the plan's output type (u8, u16, or float32 for
float output).  AVIR routing:

  - ``precision="exact"``: both passes as full-float32 batched products
    (``ops/banded.py:apply_blocked``, the JAX package's
    ``_separable_pass``), with sRGB gamma by the rational forms
    (``ops/gamma.py``) around them, then the dither stage;
  - otherwise the fused two-pass kernel K1, one launch per resize, in
    the pass order of ``choose_fused`` (below), with sRGB gamma in the
    kernel:
      * int8 mode (``ops/cuda/fused_kernel.py``) for u8 in, 8-bit out,
        ``trunc_bits == 0``, ``precision="auto"`` and no error diffusion,
        when the operators' int8 limbs are feasible (gamma: 13-bit
        linear light, and a tighter s32 bound);
      * else the split-bf16 modes (``ops/cuda/fused_split.py``) from
        ``resolve_modes``: "auto" is split2 for a first pass over u8
        input without gamma (exact in bf16) and split3 otherwise, "fast"
        split2 for both.
    K1 quantizes in its epilogue (default dither, ``trunc_bits``), or
    writes float32 (after gamma-out) for float output and for error
    diffusion;
  - error diffusion runs the wavefront scan K4
    (``ops/cuda/wavefront.py``) on the float32 pre-dither image, its sums
    in the wavefront's order (``errdiff_impl="wavefront"``, the JAX
    package's ``errdiff_dither_wavefront_jnp``) or in the sequential
    scan's (``errdiff_impl="scan"``, its ``errdiff_dither_jnp``).

Fused or unfused, and the fused pass order (``choose_fused``, the JAX
package's rule of ``ops/pallas/fused_kernel.py:choose_fused`` with its
TPU VMEM check ``fused_viable`` taken as true, and
``models/runtime.py:366-375`` there), in this order:
  1. an int8-eligible plan runs fused, "vh" for a downsize and "hv" for
     an upsize, when its limbs are feasible (``int8_feasible``), else
     unfused in the split modes;
  2. otherwise a downsize is fused, "vh";
  3. a 2- or 4-byte (u16 / float) upsize is fused, "vh";
  4. a u8 upsize in the split modes is fused "hv" only with a split2
     first pass, no gamma and new_h * new_w * C >= 8,000,000.
The unfused route (``run.route == "unfused"``, ``separable_pass_lanes``)
runs two kernels: K3, the lane pass (``ops/cuda/lanes_kernel.py``), and
K2, the row pass (``ops/cuda/banded_kernel.py``), in the order of the JAX
package's cost model (``run.order``: "vh" is K2 then K3), over the lane
operator at its base tile (``ops/lanes.py:narrow_lop``), with a float32
intermediate in device memory.  With gamma the rational forms
(``ops/gamma.py``) run around the two passes, as on the "exact" route;
then the dither stage.

The int8 gamma route reads ``AVIR_TPU_GAMMA_ROUTE`` when the executor is
built (``models/runtime.py:402-449`` there):
  - unset, "auto" or "inkernel": K1 with the in-kernel linearization, as
    the JAX package's "auto".  On an H100 80GB HBM3 at 700 W it is the
    fastest of the three routes at every shape where K6 runs
    (``gamma_routes.py``, PERF.md §6);
  - "prologue": K5 (``ops/cuda/gamma_prologue.py``) linearizes the image
    once and K1 reads its two limb planes;
  - "ring": the shift-ring kernel K6 (``ops/cuda/fused_ring.py``) on the
    V operator's uniform blocking when ``ring_viable`` holds (a
    uniform-stride downsize) and its cluster plan fits (no chunk window of
    more than 16 segments; launch key ``fused_ring_vh_gamma``,
    ``run.order`` "vh"), and otherwise a warning, as the JAX package
    gives, and the in-kernel route;
  - anything else: the in-kernel route.
All routes are bit-equal.

LANCIR routes the same way (int8 for u8 in and u8 out at
``precision="auto"``), with K1's round-half-even epilogue and its
``scale`` (the plan's ``out_mul``) for integer output; float output is
written unscaled and multiplied by ``out_mul`` after the kernel, as in
the JAX package.  Its unfused route multiplies by ``out_mul`` after the
passes, then rounds half to even and clamps.

Error diffusion excludes the int8 mode, as in the JAX package
(``avir_tpu/models/runtime.py:344-347``): the recursive quantizer feeds
its residual back, which turns the int8 route's ~2^-14 tap noise into
extra +-1 flips, so the pre-dither image must be full precision.

``return_predither=True`` (the custom-ditherer slot of
``ImageResizer.resize``) returns the float32 image after gamma-out and
before the dither stage, on the routes error diffusion takes: never K1's
int8 mode.  No kernel assumes a channel count: the lane operators carry
C in their lane dimension, and the alpha bypass applies to C = 4 only, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable

import torch

from ..ops.banded import BlockedBandedOp, apply_blocked, block_banded
from ..ops.cuda.banded_kernel import BandedOperands, apply_banded, prepare_banded
from ..ops.cuda.fused_kernel import (
    apply_fused_int8,
    int8_feasible,
    prepare_fused_int8,
)
from ..ops.cuda.fused_ring import apply_fused_ring, prepare_fused_ring, ring_viable
from ..ops.cuda.fused_split import (
    apply_fused_split,
    prepare_fused_split,
    to_float32,
)
from ..ops.cuda.gamma_prologue import apply_gamma_prologue
from ..ops.cuda.lanes_kernel import LanesOperands, apply_lanes, prepare_lanes
from ..ops.cuda.wavefront import errdiff_wavefront
from ..ops.dither import default_dither
from ..ops.gamma import f32, linear_to_srgb_2d, srgb_to_linear_2d
from ..ops.lanes import LaneBlockedOp, lane_block_banded, narrow_lop
from ..plan.lancir_plan import LancirPlan
from ..plan.plan import ResizePlan
from ..utils import trace

# Environment variable that selects the int8 gamma route: "auto" and
# "inkernel" (K1 with the in-kernel linearization, the fastest of the
# three on an H100 wherever K6 runs: PERF.md §6), "prologue" (K5 + K1) or
# "ring" (K6); read when an executor is built, part of the resizers'
# cache keys.
GAMMA_ROUTE_ENV = "AVIR_TPU_GAMMA_ROUTE"


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card; without one, that is an error."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the kernels' plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def out_dtype_of(plan: ResizePlan) -> torch.dtype:
    """Device output type (``_out_dtype`` there): float32 for float
    output, else u8 or u16."""
    if plan.is_out_float:
        return torch.float32
    return torch.uint8 if plan.out_type_max == 255.0 else torch.uint16


def resolve_modes(
    precision: str, first_input_exact_bf16: bool
) -> tuple[str, str]:
    """(first_pass_mode, second_pass_mode) for a precision tier."""
    if precision == "exact":
        return "exact", "exact"
    if precision == "fast":
        return "split2", "split2"
    if precision == "auto":
        first = "split2" if first_input_exact_bf16 else "split3"
        return first, "split3"
    raise ValueError(f"unknown precision {precision!r}")


def in_exact_bf16(plan: ResizePlan) -> bool:
    """The first pass's input is exact in bf16: raw u8 without gamma
    (linearized u8 is not)."""
    return (
        not plan.is_in_float
        and plan.in_type_max == 255.0
        and not plan.use_srgb_gamma
    )


def choose_fused(
    vop: BlockedBandedOp, lop: LaneBlockedOp, mode1: str, gamma: bool,
    c: int, in_bytes: int = 1,
) -> tuple[bool, str]:
    """(K1 runs the resize, its pass order); when not fused, the unfused
    K3/K2 route runs it.  Rules 1-4 of the module docstring.  ``mode1``
    is the first pass's mode, "int8" for an int8-eligible plan."""
    downsize = vop.n_out * lop.n_out <= vop.n_in * lop.n_in
    if mode1 == "int8":
        order = "vh" if downsize else "hv"
        return int8_feasible(vop, lop, order, gamma), order
    if downsize or in_bytes >= 2:
        return True, "vh"
    use = (
        mode1 == "split2" and not gamma
        and vop.n_out * lop.n_out * c >= 8_000_000
    )
    return use, "hv" if use else "vh"


def lanes_order(vop: BlockedBandedOp, lop: LaneBlockedOp, h: int, w: int, c: int) -> str:
    """Pass order of the unfused route: the JAX package's model of the
    two kernels' tap work (``_separable_pass_lanes``, runtime.py:222-227
    there); "vh" runs the row pass K2 first."""
    flops_v = vop.n_blocks * vop.tile * vop.win
    flops_h = lop.n_blocks * lop.win_l * lop.tile * c
    cost_vh = flops_v * w * c + flops_h * vop.n_out
    cost_hv = flops_h * h + flops_v * lop.n_out * c
    return "vh" if cost_vh <= cost_hv else "hv"


@dataclasses.dataclass(frozen=True)
class UnfusedOperands:
    """The two kernels of an unfused resize and their order."""

    order: str             # "vh": K2 (rows) then K3 (lanes); "hv" the other
    rows: BandedOperands   # K2
    lanes: LanesOperands   # K3

    @property
    def mode_v(self) -> str:
        return self.rows.mode

    @property
    def mode_h(self) -> str:
        return self.lanes.mode


def prepare_unfused(
    vop: BlockedBandedOp, lop: LaneBlockedOp, h: int, w: int, c: int,
    mode1: str, mode2: str, device,
) -> UnfusedOperands:
    """Operands of the unfused route; ``mode1`` applies to the pass that
    reads the image, ``mode2`` to the other."""
    order = lanes_order(vop, lop, h, w, c)
    mode_v, mode_h = (mode1, mode2) if order == "vh" else (mode2, mode1)
    return UnfusedOperands(
        order=order,
        rows=prepare_banded(vop, mode_v, device),
        lanes=prepare_lanes(lop, mode_h, device),
    )


def separable_pass_lanes(x: torch.Tensor, ops: UnfusedOperands) -> torch.Tensor:
    """[H, W*C] (u8, u16 or float32) -> float32 [new_h, new_w*C] by the
    two kernels (``_separable_pass_lanes`` there): each converts its input
    as it stages it, and the lane pass writes the interleaved layout, so
    nothing is transposed."""
    if ops.order == "vh":
        return apply_lanes(ops.lanes, apply_banded(ops.rows, x))
    return apply_banded(ops.rows, apply_lanes(ops.lanes, x))


def gamma_route() -> str:
    """The int8 gamma route ``AVIR_TPU_GAMMA_ROUTE`` asks for: "auto"
    (unset), "inkernel", "prologue" or "ring"; anything else is
    "inkernel", and the executor runs "auto" as "inkernel"."""
    route = os.environ.get(GAMMA_ROUTE_ENV, "auto")
    return route if route in ("auto", "prologue", "ring") else "inkernel"


def _ring_operands(plan: ResizePlan, lop: LaneBlockedOp, order: str, device):
    """K6's operands for an int8 gamma plan on the "ring" route, or None
    when that route is not viable (``models/runtime.py:414-423`` there):
    the V operator by uniform blocking, with limbs, and ``ring_viable``;
    and K6's cluster plan fits the card (``prepare_fused_ring`` refuses a
    chunk window of more than 16 segments)."""
    if order != "vh":
        return None
    try:
        vop_ring = block_banded(plan.v.op, uniform=True)
    except ValueError:
        return None
    if vop_ring.taps_q1 is None or not ring_viable(vop_ring, lop, True, order):
        return None
    try:
        return prepare_fused_ring(
            vop_ring, lop, device, alpha_index=plan.alpha_index,
            in_gamma_mult=plan.in_gamma_mult, out_gamma_mult=plan.out_gamma_mult,
        )
    except ValueError:
        return None


def separable_pass_exact(
    x: torch.Tensor, hop, vop, h: int, w: int, c: int,
    h_taps: torch.Tensor | None = None, v_taps: torch.Tensor | None = None,
) -> torch.Tensor:
    """[H, W*C] float32 -> [new_h, new_w*C], both passes in full float32
    (``_separable_pass`` there, "exact" mode): the pass that shrinks the
    image runs first, so the one transpose moves the smaller image.
    ``h_taps``/``v_taps``: the operators' tap blocks already on the
    device."""
    new_w, new_h = hop.n_out, vop.n_out
    if new_h * w <= h * new_w:
        x = apply_blocked(vop, x, taps=v_taps)  # [new_h, W*C]
        x = x.reshape(new_h, w, c).transpose(0, 1).reshape(w, new_h * c)
        x = apply_blocked(hop, x, taps=h_taps)  # [new_w, new_h*C]
        return x.reshape(new_w, new_h, c).transpose(0, 1).reshape(new_h, -1)
    x = x.reshape(h, w, c).transpose(0, 1).reshape(w, h * c)
    x = apply_blocked(hop, x, taps=h_taps)  # [new_w, H*C]
    x = x.reshape(new_w, h, c).transpose(0, 1).reshape(h, new_w * c)
    return apply_blocked(vop, x, taps=v_taps)  # [new_h, new_w*C]


def make_avir_executor(
    plan: ResizePlan,
    errdiff: bool = False,
    precision: str = "auto",
    device=None,
    return_predither: bool = False,
    errdiff_impl: str = "wavefront",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a resize function [H, W*C] -> [new_h, new_w*C] on ``device``
    for ``plan`` (see the module docstring for the routing).  ``errdiff``
    selects error diffusion for integer output, on K4 in the sum order of
    ``errdiff_impl`` ("wavefront" or "scan"); ``return_predither`` makes
    the function return the float32 image before the dither stage.  The
    returned function carries its route as ``run.route`` ("int8", "split",
    "unfused" or "exact"), the pass order as ``run.order`` and its
    kernels' operands as ``run.ops`` (K1's, ``UnfusedOperands`` for
    "unfused", None for "exact")."""
    if errdiff_impl not in ("wavefront", "scan"):
        raise ValueError(f"unknown errdiff_impl {errdiff_impl!r}")
    device = resolve_device(device)
    in_bytes = 4 if plan.is_in_float else (1 if plan.in_type_max == 255.0 else 2)
    c = plan.el_count
    vop = block_banded(plan.v.op, in_bytes=in_bytes)
    lop = lane_block_banded(plan.h.op, c, in_bytes=in_bytes)
    out_dt = out_dtype_of(plan)
    out_bits = 8 if plan.out_type_max == 255.0 else 16
    trunc_bits = 0 if plan.is_out_float else out_bits - plan.res_bit_depth
    errdiff = errdiff and not plan.is_out_float
    pre_only = return_predither and not plan.is_out_float
    gamma = plan.use_srgb_gamma
    gamma_kw = dict(
        gamma=gamma,
        alpha_index=plan.alpha_index,
        in_gamma_mult=plan.in_gamma_mult,
        out_gamma_mult=plan.out_gamma_mult,
    )
    mode1, mode2 = resolve_modes(precision, in_exact_bf16(plan))
    int8_ok = (
        precision == "auto"
        and not plan.is_in_float
        and plan.in_type_max == 255.0
        and out_dt == torch.uint8
        and not errdiff
        and not pre_only
        and trunc_bits == 0
    )

    def quantize(x: torch.Tensor) -> torch.Tensor:
        """The dither stage on the float32 image [new_h, new_w*C]."""
        if plan.is_out_float or pre_only:
            return x
        if errdiff:
            x3 = x.reshape(vop.n_out, lop.n_out, c).contiguous()
            return errdiff_wavefront(
                x3, trunc_bits, plan.out_type_max, out_dtype=out_dt,
                scan_order=errdiff_impl == "scan",
            ).reshape(vop.n_out, -1)
        return default_dither(x, trunc_bits, plan.out_type_max).to(
            torch.int32
        ).to(out_dt)

    if mode1 == "exact":
        hop = block_banded(plan.h.op, in_bytes=in_bytes)
        h, w = plan.src_h, plan.src_w
        h_taps = torch.from_numpy(hop.taps).to(device)
        v_taps = torch.from_numpy(vop.taps).to(device)

        def run(src: torch.Tensor) -> torch.Tensor:
            x = to_float32(src)
            if gamma:
                x = srgb_to_linear_2d(x * plan.in_gamma_mult, c, plan.alpha_index)
            x = separable_pass_exact(x, hop, vop, h, w, c, h_taps, v_taps)
            if gamma:
                x = linear_to_srgb_2d(x, c, plan.alpha_index)
                if plan.out_gamma_mult != 0.0:
                    x = x * plan.out_gamma_mult
            return quantize(x)

        run.route, run.order, run.ops = "exact", None, None
        return run

    fused, order = choose_fused(
        vop, lop, "int8" if int8_ok else mode1, gamma, c, in_bytes
    )
    if not fused:
        ops = prepare_unfused(
            vop, narrow_lop(plan.h.op, lop, c, in_bytes=in_bytes),
            plan.src_h, plan.src_w, c, mode1, mode2, device,
        )

        def predither(src: torch.Tensor) -> torch.Tensor:
            x = src
            if gamma:
                x = srgb_to_linear_2d(
                    to_float32(src) * f32(plan.in_gamma_mult), c, plan.alpha_index
                )
            x = separable_pass_lanes(x, ops)
            if gamma:
                x = linear_to_srgb_2d(x, c, plan.alpha_index)
                if plan.out_gamma_mult != 0.0:
                    x = x * f32(plan.out_gamma_mult)
            return x

        def run(src: torch.Tensor) -> torch.Tensor:
            return quantize(predither(src))

        # The float32 image before the dither stage, for callers that
        # check it (chip_smoke.py).
        run.predither = predither
        run.route, run.order, run.ops = "unfused", ops.order, ops
        return run

    if int8_ok:
        route = gamma_route() if gamma else "inkernel"
        if route == "ring":
            with trace.span("setup.ring_operands"):
                ring = _ring_operands(plan, lop, order, device)
            if ring is not None:
                def run(src: torch.Tensor) -> torch.Tensor:
                    return apply_fused_ring(ring, src)

                run.route, run.order, run.ops = "int8", "vh", ring
                return run
            warnings.warn(
                f"{GAMMA_ROUTE_ENV}=ring not viable for this config (needs a "
                "uniform-stride int8 downsize whose lane windows span at most "
                "16 segments); falling back to the in-kernel route"
            )
        pre = route == "prologue"
        ops = prepare_fused_int8(vop, lop, order, device, gamma_pre=pre, **gamma_kw)

        def run(src: torch.Tensor) -> torch.Tensor:
            if not pre:
                return apply_fused_int8(ops, src)
            hi, lo = apply_gamma_prologue(
                src, ops.rows_pad, ops.lanes_pad, c, plan.alpha_index,
                plan.in_gamma_mult,
            )
            return apply_fused_int8(ops, hi, lo)

        run.route, run.order, run.ops = "int8", order, ops
        return run

    mode_v, mode_h = (mode1, mode2) if order == "vh" else (mode2, mode1)
    fuse_quant = not plan.is_out_float and not errdiff and not pre_only
    ops = prepare_fused_split(
        vop, lop, order, mode_v, mode_h, device,
        out_dtype=out_dt if fuse_quant else torch.float32,
        out_max=plan.out_type_max,
        trunc_bits=trunc_bits if fuse_quant else 0,
        **gamma_kw,
    )

    def run(src: torch.Tensor) -> torch.Tensor:
        out = apply_fused_split(ops, src)
        return out if fuse_quant else quantize(out)

    run.route, run.order, run.ops = "split", order, ops
    return run


def make_lancir_executor(
    plan: LancirPlan,
    precision: str = "auto",
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a LANCIR resize function [H, W*C] -> [new_h, new_w*C] on
    ``device`` for ``plan``: output rounding is round-half-even, as the
    reference's SIMD nearest-even conversions (lancir.h:1870-2002).
    ``run.route``, ``run.order`` and ``run.ops`` as in
    ``make_avir_executor``; ``precision="f64"`` is the host oracle's
    (models/lancir.py), not an executor's."""
    device = resolve_device(device)
    in_bytes = plan.in_itemsize
    c = plan.el_count
    vop = block_banded(plan.v, in_bytes=in_bytes)
    lop = lane_block_banded(plan.h, c, in_bytes=in_bytes)
    out_dt = (
        torch.float32 if plan.is_out_float
        else torch.uint8 if plan.clamp == 255.0 else torch.uint16
    )
    mode1, mode2 = resolve_modes(precision, plan.in_exact_bf16)
    epi_kw = dict(scale=plan.out_mul, round_mode="even")

    def rescale(x: torch.Tensor) -> torch.Tensor:
        return x * plan.out_mul if plan.out_mul != 1.0 else x

    def finish(x: torch.Tensor) -> torch.Tensor:
        """``out_mul``, then round half to even and clamp for integer
        output (the routes that do not round in a kernel)."""
        x = rescale(x)
        if plan.is_out_float:
            return x
        return torch.clamp(torch.round(x), 0.0, plan.clamp).to(
            torch.int32
        ).to(out_dt)

    if mode1 == "exact":
        hop = block_banded(plan.h, in_bytes=in_bytes)
        h, w = plan.src_h, plan.src_w
        h_taps = torch.from_numpy(hop.taps).to(device)
        v_taps = torch.from_numpy(vop.taps).to(device)

        def run(src: torch.Tensor) -> torch.Tensor:
            return finish(separable_pass_exact(
                to_float32(src), hop, vop, h, w, c, h_taps, v_taps
            ))

        run.route, run.order, run.ops = "exact", None, None
        return run

    int8_ok = (
        precision == "auto"
        and plan.in_exact_bf16
        and out_dt == torch.uint8
    )
    fused, order = choose_fused(
        vop, lop, "int8" if int8_ok else mode1, False, c, in_bytes
    )
    if not fused:
        ops = prepare_unfused(
            vop, narrow_lop(plan.h, lop, c, in_bytes=in_bytes),
            plan.src_h, plan.src_w, c, mode1, mode2, device,
        )

        def run(src: torch.Tensor) -> torch.Tensor:
            return finish(separable_pass_lanes(src, ops))

        run.route, run.order, run.ops = "unfused", ops.order, ops
        return run

    if int8_ok:
        ops = prepare_fused_int8(vop, lop, order, device, **epi_kw)

        def run(src: torch.Tensor) -> torch.Tensor:
            return apply_fused_int8(ops, src)

        run.route, run.order, run.ops = "int8", order, ops
        return run

    mode_v, mode_h = (mode1, mode2) if order == "vh" else (mode2, mode1)
    ops = prepare_fused_split(
        vop, lop, order, mode_v, mode_h, device,
        out_dtype=out_dt, out_max=plan.clamp, **epi_kw,
    )

    def run(src: torch.Tensor) -> torch.Tensor:
        out = apply_fused_split(ops, src)
        return rescale(out) if plan.is_out_float else out

    run.route, run.order, run.ops = "split", order, ops
    return run
